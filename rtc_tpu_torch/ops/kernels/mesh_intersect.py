"""Mesh intersection: the hand-written CUDA kernels K1-K6
(rtc_tpu_torch/csrc/mesh_intersect.cu) and their plain PyTorch versions.

Counterpart of rtc_tpu/ops/pallas/mesh_intersect.py:

  K1 mesh_closest_hit          <- mesh_closest_hit_mxu(tri_n=...)  (_kernel_mxu)
     mesh_closest_hit_sn       <- mesh_closest_hit_mxu(tri_sn=...)
  K2 mesh_any_hit              <- mesh_any_hit_mxu                 (_anyhit_kernel_mxu)
  K3 mesh_closest_shadow       <- mesh_closest_shadow_mxu          (_kernel_mxu_cs)
     mesh_closest_shadow_sn    <- mesh_closest_shadow_mxu(tri_sn=...)
  K4 mesh_crossing_count       <- mesh_crossing_count_mxu          (_crossing_kernel_mxu)
  K5 mesh_closest_hit_tlas     <- mesh_closest_hit_tlas_mxu(tri_n=...)  (_kernel_mxu_tlas)
     mesh_closest_hit_tlas_sn  <- mesh_closest_hit_tlas_mxu(tri_sn=...)
  K6 mesh_any_hit_tlas         <- mesh_any_hit_tlas_mxu            (_anyhit_kernel_tlas)

Each wrapper takes f32 tensors. Given tensors on the CPU it returns its
plain version's result; given CUDA tensors it launches its kernel, or
raises. LAUNCHES counts the kernel launches of each wrapper.

The kernels are built from the checkout's sources with nvcc at first use,
into a plain-C shared library under build/kernels/ (content-addressed, so
an edited source is rebuilt), and bound with ctypes.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

import torch

from ...utils.constants import BIG, EPSILON, FAR
from ..intersect import triangle
from ..vec import dot3, normalize3

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join(_PKG, "csrc", "mesh_intersect.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
# -fmad=false: the kernels round each multiply and add on its own, as the
# plain versions' separate elementwise operations do (see the source note)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v")

LAUNCHES = {"closest_hit": 0, "any_hit": 0, "closest_shadow": 0,
            "closest_hit_sn": 0, "closest_shadow_sn": 0, "crossing_count": 0,
            "closest_hit_tlas": 0, "closest_hit_tlas_sn": 0, "any_hit_tlas": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# plain PyTorch versions: a dense sweep over every triangle, chunked over rays
# ---------------------------------------------------------------------------

def _chunk(n_rays: int, n_tris: int, device) -> int:
    """Rays per chunk so one (rays, T) intermediate stays near 4M (CPU)
    or 32M (CUDA) elements."""
    budget = (1 << 25) if torch.device(device).type == "cuda" else (1 << 22)
    return max(1, min(n_rays, budget // max(n_tris, 1)))


def _pair_tests(o, d, p1, e1, e2, eps):
    """(rays, T) t and validity of every ray against every triangle."""
    return triangle(o[:, None, :], d[:, None, :], p1[None], e1[None], e2[None],
                    eps)[:2]


def _closest_plain(o, d, p1, e1, e2, eps):
    """Nearest triangle with t >= 0 by a dense sweep (rtc_tpu
    integrator.mesh_closest bruteforce, :640-644): t (BIG on a miss) and
    idx (-1 on a miss, the lowest index on a tie)."""
    R = o.shape[0]
    t_out = torch.full((R,), BIG, dtype=o.dtype, device=o.device)
    idx_out = torch.full((R,), -1, dtype=torch.int32, device=o.device)
    if p1.shape[0] == 0:
        return t_out, idx_out
    step = _chunk(R, p1.shape[0], o.device)
    for s in range(0, R, step):
        t, valid = _pair_tests(o[s:s + step], d[s:s + step], p1, e1, e2, eps)
        tt = torch.where(valid & (t >= 0.0), t, BIG)
        idx = torch.argmin(tt, dim=1)
        t_min = torch.gather(tt, 1, idx[:, None])[:, 0]
        t_out[s:s + step] = t_min
        idx_out[s:s + step] = torch.where(t_min < BIG * 0.5, idx, -1).to(torch.int32)
    return t_out, idx_out


def closest_hit_plain(o, d, p1, e1, e2, tri_n, eps: float = EPSILON):
    """K1's plain version: the dense sweep's (t, idx) and the winner's
    tri_n row (zeros on a miss)."""
    t, idx = _closest_plain(o, d, p1, e1, e2, eps)
    hit = idx >= 0
    if p1.shape[0] == 0:
        return t, idx, torch.zeros_like(o)
    n = torch.where(hit[:, None], tri_n[idx.clamp_min(0).long()], 0.0)
    return t, idx, n


def smooth_blend(o, d, p1, e1, e2, tri_sn, idx, eps: float = EPSILON):
    """The winner's corner normals (tri_sn: (T, 9) = [sn1 | sn2 | sn3])
    blended by its barycentric (u, v), unnormalized, zeros where idx < 0:
    w0 = (1 - u) - v, then (w0 sn1 + u sn2) + v sn3 per axis, as rtc_tpu
    (mesh_intersect.py:538-545, integrator.py:707-715)."""
    if p1.shape[0] == 0:
        return torch.zeros_like(o)
    i = idx.clamp_min(0).long()
    _, _, u, v = triangle(o, d, p1[i], e1[i], e2[i], eps)
    g = tri_sn[i]
    w0 = 1.0 - u - v
    n = w0[:, None] * g[:, 0:3] + u[:, None] * g[:, 3:6] + v[:, None] * g[:, 6:9]
    return torch.where((idx >= 0)[:, None], n, 0.0)


def closest_hit_sn_plain(o, d, p1, e1, e2, tri_sn, eps: float = EPSILON):
    """K1 with_sn's plain version: the dense sweep's (t, idx) and the
    winner's raw corner blend (smooth_blend)."""
    t, idx = _closest_plain(o, d, p1, e1, e2, eps)
    return t, idx, smooth_blend(o, d, p1, e1, e2, tri_sn, idx, eps)


def any_hit_plain(o, d, max_t, p1, e1, e2, eps: float = EPSILON):
    """K2's plain version: does any triangle lie at t in [0, max_t)? Lanes
    with max_t <= 0 are dead and never hit."""
    R = o.shape[0]
    out = torch.zeros((R,), dtype=torch.bool, device=o.device)
    if p1.shape[0] == 0:
        return out
    step = _chunk(R, p1.shape[0], o.device)
    for s in range(0, R, step):
        t, valid = _pair_tests(o[s:s + step], d[s:s + step], p1, e1, e2, eps)
        out[s:s + step] = torch.any(
            valid & (t >= 0.0) & (t < max_t[s:s + step, None]), dim=1)
    return out


def shadow_rays_plain(o, d, t, idx, n, light_pos, eps: float = EPSILON,
                      unit_n: bool = True):
    """K3's phase 2: the shadow ray of each closest hit, with the formulas
    of prepare_hit3 (normal flip, over_point), color_at (facing test,
    parked misses) and is_shadowed (direction, distance, live). unit_n=False
    normalizes n first (a smooth blend). Returns (origin (R, 3), direction
    (R, 3), max_t (R,)); dead lanes get -1."""
    hit_ok = idx >= 0
    t_safe = torch.where(hit_ok, t, 1.0)
    ox, oy, oz = o.unbind(1)
    dx, dy, dz = d.unbind(1)
    px, py, pz = ox + dx * t_safe, oy + dy * t_safe, oz + dz * t_safe
    nx, ny, nz = n.unbind(1)
    if not unit_n:
        nx, ny, nz = normalize3(nx, ny, nz)
    inside = (nx * -dx + ny * -dy + nz * -dz) < 0.0
    nx, ny, nz = (torch.where(inside, -c, c) for c in (nx, ny, nz))
    lx, ly, lz = light_pos.unbind(0)
    facing = dot3(*normalize3(lx - px, ly - py, lz - pz), nx, ny, nz) >= 0.0
    ovx = torch.where(hit_ok, px + nx * eps, FAR)
    ovy = torch.where(hit_ok, py + ny * eps, FAR)
    ovz = torch.where(hit_ok, pz + nz * eps, FAR)
    vx, vy, vz = lx - ovx, ly - ovy, lz - ovz
    dist = torch.sqrt(torch.clamp_min(vx * vx + vy * vy + vz * vz, 1e-30))
    max_t = torch.where(hit_ok & facing, dist, -1.0)
    return (torch.stack([ovx, ovy, ovz], 1),
            torch.stack([vx / dist, vy / dist, vz / dist], 1), max_t)


def closest_shadow_plain(o, d, p1, e1, e2, tri_n, light_pos,
                         eps: float = EPSILON):
    """K3's plain version: closest_hit_plain, then shadow_rays_plain, then
    any_hit_plain. Returns (t, idx, n, shadowed)."""
    t, idx, n = closest_hit_plain(o, d, p1, e1, e2, tri_n, eps)
    so, sd, max_t = shadow_rays_plain(o, d, t, idx, n, light_pos, eps)
    return t, idx, n, any_hit_plain(so, sd, max_t, p1, e1, e2, eps)


def closest_shadow_sn_plain(o, d, p1, e1, e2, tri_sn, light_pos,
                            eps: float = EPSILON):
    """K3 with_sn's plain version: closest_hit_sn_plain, then the shadow
    ray of the normalized blend, then any_hit_plain. Returns (t, idx,
    n_blend, shadowed), n_blend unnormalized as K1 with_sn's."""
    t, idx, n = closest_hit_sn_plain(o, d, p1, e1, e2, tri_sn, eps)
    so, sd, max_t = shadow_rays_plain(o, d, t, idx, n, light_pos, eps,
                                      unit_n=False)
    return t, idx, n, any_hit_plain(so, sd, max_t, p1, e1, e2, eps)


def crossing_count_plain(o, d, t_hit, hit_gid, p1, e1, e2, tri_cid,
                         n_containers: int, eps: float = EPSILON):
    """K4's plain version: per ray and container slot k, the count of
    crossings at t < t_hit (negative t included) of the triangles with
    tri_cid == k, the triangle hit_gid excluded, and the latest such t
    (-BIG where none).

    A dense sweep over the container rows of the global triangle tables
    (tri_cid >= 0), chunked over rays; rtc_tpu's compact refr_tri_* slabs
    hold the same rows, so the port does not keep them. Returns (cnt (R, K)
    i32, last (R, K) in o's dtype)."""
    R, K = o.shape[0], n_containers
    cnt = torch.zeros((R, K), dtype=torch.int32, device=o.device)
    last = torch.full((R, K), -BIG, dtype=o.dtype, device=o.device)
    rows = torch.nonzero(tri_cid >= 0)[:, 0]
    if rows.numel() == 0 or R == 0:
        return cnt, last
    cid = tri_cid[rows]
    gid = rows.to(hit_gid.dtype)
    step = _chunk(R, rows.numel(), o.device)
    for s in range(0, R, step):
        t, valid = _pair_tests(o[s:s + step], d[s:s + step], p1[rows],
                               e1[rows], e2[rows], eps)
        before = (valid & (t < t_hit[s:s + step, None])
                  & (gid[None] != hit_gid[s:s + step, None]))
        for k in range(K):
            mk = before & (cid == k)[None]
            cnt[s:s + step, k] = mk.sum(1, dtype=torch.int32)
            last[s:s + step, k] = torch.where(mk, t, -BIG).amax(1)
    return cnt, last


# --- instanced (TLAS) tables: K5 and K6's plain versions --------------------
#
# p1/e1/e2 and the payloads hold M unique meshes of cm * leaf rows each, in
# object space; inst_ab (I, 12) = [A row-major | b] maps world rays into
# instance k's object space; inst_aabb (I, 6) are the instances' world
# boxes, empty (lo 1 > hi -1) for padding instances; inst_mesh and
# inst_obj (I,) i32 (scene/compile.py TlasTables).

def instance_rays(o, d, ab):
    """Rays in an instance's object space, o' = A o + b and d' = A d (not
    renormalized, so t is world t). ab is (12,) for one instance or (R, 12)
    for one per ray. Summed left to right, elementwise, as K5/K6 round:
    einsum or matmul would fix neither the order nor TF32's absence."""
    ox, oy, oz = o.unbind(1)
    dx, dy, dz = d.unbind(1)
    a = ab.unbind(-1)
    o2 = [a[3 * k] * ox + a[3 * k + 1] * oy + a[3 * k + 2] * oz + a[9 + k]
          for k in range(3)]
    d2 = [a[3 * k] * dx + a[3 * k + 1] * dy + a[3 * k + 2] * dz
          for k in range(3)]
    return torch.stack(o2, 1), torch.stack(d2, 1)


def normal_to_world(n, ab):
    """Object-space normals (R, 3) through each ray's instance (ab (R, 12)):
    n_w[a] = (n0 A[0][a] + n1 A[1][a]) + n2 A[2][a], the inverse-transpose
    in row-vector form (rtc_tpu mesh_intersect.py:1094-1096), unnormalized."""
    n0, n1, n2 = n.unbind(1)
    a = ab.unbind(-1)
    return torch.stack([n0 * a[c] + n1 * a[3 + c] + n2 * a[6 + c]
                        for c in range(3)], 1)


def _real_instances(p1, inst_aabb, inst_mesh, tm: int):
    """(instance, mesh) of every instance with a non-empty world box and a
    mesh in the tables, in index order. Padding instances (identity, mesh
    0, empty box) are left out by their box alone."""
    n_mesh = p1.shape[0] // tm
    real = (inst_aabb[:, :3] <= inst_aabb[:, 3:]).all(1)
    return [(k, m) for k, (r, m) in enumerate(zip(real.tolist(),
                                                   inst_mesh.tolist()))
            if r and 0 <= m < n_mesh]


def _tlas_result(o, d, t, inst, row, payload, p1, e1, e2, inst_ab,
                 inst_mesh, inst_obj, tm: int, smooth: bool, eps):
    """K5's outputs from the winner (inst, mesh row; inst -1 on a miss):
    (t, enc i32, obj i32, n). n is the winner's object face normal, or
    with smooth its corner blend at its (u, v) in its instance's object
    space, pushed to world space; zeros on a miss."""
    hit = inst >= 0
    k = inst.clamp_min(0)
    ab = inst_ab[k]
    enc = torch.where(hit, k * tm + row - inst_mesh[k].long() * tm, -1)
    obj = torch.where(hit, inst_obj[k], 0)
    if smooth:
        n_obj = smooth_blend(*instance_rays(o, d, ab), p1, e1, e2, payload,
                             torch.where(hit, row, -1), eps)
    else:
        n_obj = payload[row]
    n = torch.where(hit[:, None], normal_to_world(n_obj, ab), 0.0)
    return t, enc.to(torch.int32), obj.to(torch.int32), n


def _closest_tlas_plain(o, d, p1, e1, e2, payload, inst_ab, inst_aabb,
                        inst_mesh, inst_obj, leaf: int, cm: int, eps,
                        smooth: bool):
    """The real instances in index order, each a dense sweep of its mesh's
    rows on the instance-space rays; the minimum t by strict <, so a tie
    goes to the lower instance, then the lower row."""
    R, tm = o.shape[0], cm * leaf
    t_best = torch.full((R,), BIG, dtype=o.dtype, device=o.device)
    inst = torch.full((R,), -1, dtype=torch.int64, device=o.device)
    row = torch.zeros((R,), dtype=torch.int64, device=o.device)
    for k, m in _real_instances(p1, inst_aabb, inst_mesh, tm):
        rows = slice(m * tm, (m + 1) * tm)
        t, idx = _closest_plain(*instance_rays(o, d, inst_ab[k]), p1[rows],
                                e1[rows], e2[rows], eps)
        better = t < t_best
        t_best = torch.where(better, t, t_best)
        inst = torch.where(better, k, inst)
        row = torch.where(better, m * tm + idx.long(), row)
    return _tlas_result(o, d, t_best, inst, row, payload, p1, e1, e2,
                        inst_ab, inst_mesh, inst_obj, tm, smooth, eps)


def closest_hit_tlas_plain(o, d, p1, e1, e2, tri_n, inst_ab, inst_aabb,
                           inst_mesh, inst_obj, leaf: int, cm: int,
                           eps: float = EPSILON):
    """K5's plain version: (t (BIG on a miss), enc = instance * cm * leaf
    + mesh-local row (-1), obj (0), n) with n the winner's object face
    normal (tri_n, (M * cm * leaf, 3)) pushed to world, unnormalized."""
    return _closest_tlas_plain(o, d, p1, e1, e2, tri_n, inst_ab, inst_aabb,
                               inst_mesh, inst_obj, leaf, cm, eps, False)


def closest_hit_tlas_sn_plain(o, d, p1, e1, e2, tri_sn, inst_ab, inst_aabb,
                              inst_mesh, inst_obj, leaf: int, cm: int,
                              eps: float = EPSILON):
    """K5 with_sn's plain version: as closest_hit_tlas_plain, with n the
    winner's object corner normals (tri_sn, (M * cm * leaf, 9)) blended by
    its (u, v) in its instance's object space, pushed to world."""
    return _closest_tlas_plain(o, d, p1, e1, e2, tri_sn, inst_ab, inst_aabb,
                               inst_mesh, inst_obj, leaf, cm, eps, True)


def any_hit_tlas_plain(o, d, max_t, p1, e1, e2, inst_ab, inst_aabb,
                       inst_mesh, leaf: int, cm: int, eps: float = EPSILON):
    """K6's plain version: does any real instance hold a triangle at t in
    [0, max_t)? Each real instance's rows are swept densely on the
    instance-space rays; max_t <= 0 marks a dead lane."""
    out = torch.zeros((o.shape[0],), dtype=torch.bool, device=o.device)
    tm = cm * leaf
    for k, m in _real_instances(p1, inst_aabb, inst_mesh, tm):
        rows = slice(m * tm, (m + 1) * tm)
        out |= any_hit_plain(*instance_rays(o, d, inst_ab[k]), max_t,
                             p1[rows], e1[rows], e2[rows], eps)
    return out


# ---------------------------------------------------------------------------
# build and binding
# ---------------------------------------------------------------------------

def find_nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           f"{SOURCE} on the machine with the GPU")
    return nvcc


def build() -> str:
    """Compile the kernels (once per source and flag set) and return the
    shared library's path. nvcc's ptxas report (registers, spills) is kept
    beside it as <library>.log."""
    with open(SOURCE, "rb") as f:
        key = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = os.path.join(BUILD_DIR, f"libmesh_intersect_{key}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {SOURCE}:\n{proc.stderr}")
    with open(lib + ".log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    os.replace(tmp, lib)  # atomic: concurrent builders never see half a file
    return lib


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build())
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    closest = [I, P, P, P, I, P, P, P, P, P, I, I, F, P, P, P]
    shadow = [I, P, P, P, I, P, P, P, P, P, I, I, F, P, P, P, P, P]
    lib.rtc_closest_hit.argtypes = closest
    lib.rtc_closest_hit_sn.argtypes = closest
    lib.rtc_any_hit.argtypes = [I, P, P, P, P, I, P, P, P, P, I, I, F, P]
    lib.rtc_closest_shadow.argtypes = shadow
    lib.rtc_closest_shadow_sn.argtypes = shadow
    lib.rtc_crossing_count.argtypes = [I, P, P, P, P, P, I, P, P, P, P, P, P,
                                       I, I, F, I, P, P]
    closest_tlas = [I, P, P, P, I, P, P, P, P, P, I, I, I, P, P, P, P, I, F,
                    P, P, P, P]
    lib.rtc_closest_hit_tlas.argtypes = closest_tlas
    lib.rtc_closest_hit_tlas_sn.argtypes = closest_tlas
    lib.rtc_any_hit_tlas.argtypes = [I, P, P, P, P, I, P, P, P, P, I, I, I, P,
                                     P, P, I, F, P]
    for fn in (lib.rtc_closest_hit, lib.rtc_closest_hit_sn, lib.rtc_any_hit,
               lib.rtc_closest_shadow, lib.rtc_closest_shadow_sn,
               lib.rtc_crossing_count, lib.rtc_closest_hit_tlas,
               lib.rtc_closest_hit_tlas_sn, lib.rtc_any_hit_tlas):
        fn.restype = I
    lib.rtc_error_string.argtypes = [I]
    lib.rtc_error_string.restype = ctypes.c_char_p
    return lib


def _check(name: str, x, dtype, shape, device) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch_args(o, d, tri_p1, tri_e1, tri_e2, cluster_aabb, leaf,
                 payload=None, payload_name="tri_n"):
    """Validate a launch's inputs; payload is (T, 3) tri_n or (T, 9)
    tri_sn. Returns (device, R, C)."""
    device = o.device
    if device.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, got {device}")
    R, C = o.shape[0], cluster_aabb.shape[0]
    T = C * leaf
    f32 = torch.float32
    _check("o", o, f32, (R, 3), device)
    _check("d", d, f32, (R, 3), device)
    for name, x in (("tri_p1", tri_p1), ("tri_e1", tri_e1), ("tri_e2", tri_e2)):
        _check(name, x, f32, (T, 3), device)
    if payload is not None:
        width = 9 if payload_name == "tri_sn" else 3
        _check(payload_name, payload, f32, (T, width), device)
    _check("cluster_aabb", cluster_aabb, f32, (C, 6), device)
    return device, R, C


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err} "
                           f"({library().rtc_error_string(err).decode()})")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _closest_launch(name, fn, o, d, tri_p1, tri_e1, tri_e2, payload,
                    payload_name, cluster_aabb, leaf, eps):
    """K1 in either payload mode: (t, idx, n)."""
    device, R, C = _launch_args(o, d, tri_p1, tri_e1, tri_e2, cluster_aabb,
                                leaf, payload, payload_name)
    t = torch.empty((R,), dtype=torch.float32, device=device)
    idx = torch.empty((R,), dtype=torch.int32, device=device)
    n = torch.empty((R, 3), dtype=torch.float32, device=device)
    if R:
        err = fn(device.index or 0, _stream(device), o.data_ptr(), d.data_ptr(),
                 R, tri_p1.data_ptr(), tri_e1.data_ptr(), tri_e2.data_ptr(),
                 payload.data_ptr(), cluster_aabb.data_ptr(), C, leaf, eps,
                 t.data_ptr(), idx.data_ptr(), n.data_ptr())
        _raise_on(err, name)
        LAUNCHES[name] += 1
    return t, idx, n


def mesh_closest_hit(o, d, tri_p1, tri_e1, tri_e2, tri_n, cluster_aabb,
                     leaf: int, eps: float = EPSILON):
    """K1: (t, idx, n) as closest_hit_plain."""
    if o.device.type == "cpu":
        return closest_hit_plain(o, d, tri_p1, tri_e1, tri_e2, tri_n, eps)
    return _closest_launch("closest_hit", library().rtc_closest_hit, o, d,
                           tri_p1, tri_e1, tri_e2, tri_n, "tri_n",
                           cluster_aabb, leaf, eps)


def mesh_closest_hit_sn(o, d, tri_p1, tri_e1, tri_e2, tri_sn, cluster_aabb,
                        leaf: int, eps: float = EPSILON):
    """K1 with_sn: (t, idx, n_blend) as closest_hit_sn_plain; tri_sn is
    the (T, 9) corner-normal table [sn1 | sn2 | sn3]."""
    if o.device.type == "cpu":
        return closest_hit_sn_plain(o, d, tri_p1, tri_e1, tri_e2, tri_sn, eps)
    return _closest_launch("closest_hit_sn", library().rtc_closest_hit_sn, o,
                           d, tri_p1, tri_e1, tri_e2, tri_sn, "tri_sn",
                           cluster_aabb, leaf, eps)


def mesh_any_hit(o, d, max_t, tri_p1, tri_e1, tri_e2, cluster_aabb,
                 leaf: int, eps: float = EPSILON):
    """K2: (R,) bool as any_hit_plain."""
    if o.device.type == "cpu":
        return any_hit_plain(o, d, max_t, tri_p1, tri_e1, tri_e2, eps)
    device, R, C = _launch_args(o, d, tri_p1, tri_e1, tri_e2, cluster_aabb, leaf)
    _check("max_t", max_t, torch.float32, (R,), device)
    hit = torch.empty((R,), dtype=torch.bool, device=device)
    if R:
        err = library().rtc_any_hit(
            device.index or 0, _stream(device), o.data_ptr(), d.data_ptr(),
            max_t.data_ptr(), R, tri_p1.data_ptr(), tri_e1.data_ptr(),
            tri_e2.data_ptr(), cluster_aabb.data_ptr(), C, leaf, eps,
            hit.data_ptr())
        _raise_on(err, "any_hit")
        LAUNCHES["any_hit"] += 1
    return hit


def _shadow_launch(name, fn, o, d, tri_p1, tri_e1, tri_e2, payload,
                   payload_name, cluster_aabb, light_pos, leaf, eps):
    """K3 in either payload mode: (t, idx, n, shadowed)."""
    device, R, C = _launch_args(o, d, tri_p1, tri_e1, tri_e2, cluster_aabb,
                                leaf, payload, payload_name)
    _check("light_pos", light_pos, torch.float32, (3,), device)
    t = torch.empty((R,), dtype=torch.float32, device=device)
    idx = torch.empty((R,), dtype=torch.int32, device=device)
    n = torch.empty((R, 3), dtype=torch.float32, device=device)
    sh = torch.empty((R,), dtype=torch.bool, device=device)
    if R:
        err = fn(device.index or 0, _stream(device), o.data_ptr(), d.data_ptr(),
                 R, tri_p1.data_ptr(), tri_e1.data_ptr(), tri_e2.data_ptr(),
                 payload.data_ptr(), cluster_aabb.data_ptr(), C, leaf, eps,
                 light_pos.data_ptr(), t.data_ptr(), idx.data_ptr(),
                 n.data_ptr(), sh.data_ptr())
        _raise_on(err, name)
        LAUNCHES[name] += 1
    return t, idx, n, sh


def mesh_closest_shadow(o, d, tri_p1, tri_e1, tri_e2, tri_n, cluster_aabb,
                        light_pos, leaf: int, eps: float = EPSILON):
    """K3: (t, idx, n, shadowed) as closest_shadow_plain."""
    if o.device.type == "cpu":
        return closest_shadow_plain(o, d, tri_p1, tri_e1, tri_e2, tri_n,
                                    light_pos, eps)
    return _shadow_launch("closest_shadow", library().rtc_closest_shadow, o,
                          d, tri_p1, tri_e1, tri_e2, tri_n, "tri_n",
                          cluster_aabb, light_pos, leaf, eps)


def mesh_closest_shadow_sn(o, d, tri_p1, tri_e1, tri_e2, tri_sn, cluster_aabb,
                           light_pos, leaf: int, eps: float = EPSILON):
    """K3 with_sn: (t, idx, n_blend, shadowed) as closest_shadow_sn_plain."""
    if o.device.type == "cpu":
        return closest_shadow_sn_plain(o, d, tri_p1, tri_e1, tri_e2, tri_sn,
                                       light_pos, eps)
    return _shadow_launch("closest_shadow_sn", library().rtc_closest_shadow_sn,
                          o, d, tri_p1, tri_e1, tri_e2, tri_sn, "tri_sn",
                          cluster_aabb, light_pos, leaf, eps)


def mesh_crossing_count(o, d, t_hit, hit_gid, tri_p1, tri_e1, tri_e2,
                        cluster_aabb, tri_cid, n_containers: int, leaf: int,
                        eps: float = EPSILON):
    """K4: (cnt (R, K) i32, last (R, K) f32) as crossing_count_plain.
    t_hit <= -BIG marks a dead lane; hit_gid (R,) i32 is -2 where the hit
    is not a triangle."""
    if o.device.type == "cpu":
        return crossing_count_plain(o, d, t_hit, hit_gid, tri_p1, tri_e1,
                                    tri_e2, tri_cid, n_containers, eps)
    device, R, C = _launch_args(o, d, tri_p1, tri_e1, tri_e2, cluster_aabb, leaf)
    _check("t_hit", t_hit, torch.float32, (R,), device)
    _check("hit_gid", hit_gid, torch.int32, (R,), device)
    _check("tri_cid", tri_cid, torch.int32, (C * leaf,), device)
    if n_containers < 1:
        raise ValueError(f"n_containers must be >= 1, got {n_containers}")
    # clusters without a container triangle leave the schedule (as rtc_tpu
    # masks their boxes, mesh_intersect.py:1610-1615)
    has = (tri_cid.view(C, leaf) >= 0).any(1).to(torch.uint8)
    cnt = torch.empty((R, n_containers), dtype=torch.int32, device=device)
    last = torch.empty((R, n_containers), dtype=torch.float32, device=device)
    if R:
        err = library().rtc_crossing_count(
            device.index or 0, _stream(device), o.data_ptr(), d.data_ptr(),
            t_hit.data_ptr(), hit_gid.data_ptr(), R, tri_p1.data_ptr(),
            tri_e1.data_ptr(), tri_e2.data_ptr(), tri_cid.data_ptr(),
            has.data_ptr(), cluster_aabb.data_ptr(), C, leaf, eps,
            n_containers, cnt.data_ptr(), last.data_ptr())
        _raise_on(err, "crossing_count")
        LAUNCHES["crossing_count"] += 1
    return cnt, last


def _tlas_launch_args(o, d, p1, e1, e2, caabb, inst_ab, inst_aabb,
                      inst_mesh, inst_obj, leaf, cm, payload=None,
                      payload_name="tri_n"):
    """Validate a K5/K6 launch's inputs (inst_obj None for K6). Returns
    (device, R, M, I)."""
    device, R, C = _launch_args(o, d, p1, e1, e2, caabb, leaf, payload,
                                payload_name)
    if cm < 1 or C % cm:
        raise ValueError(f"cm={cm} does not divide the {C} cluster boxes")
    I = inst_aabb.shape[0]
    _check("inst_ab", inst_ab, torch.float32, (I, 12), device)
    _check("inst_aabb", inst_aabb, torch.float32, (I, 6), device)
    _check("inst_mesh", inst_mesh, torch.int32, (I,), device)
    if inst_obj is not None:
        _check("inst_obj", inst_obj, torch.int32, (I,), device)
    if I * cm * leaf >= 2 ** 31:
        raise ValueError(f"{I} instances of {cm * leaf} rows overflow the "
                         "int32 winner encoding")
    return device, R, C // cm, I


def _closest_tlas_launch(name, fn, o, d, p1, e1, e2, payload, payload_name,
                         caabb, inst_ab, inst_aabb, inst_mesh, inst_obj,
                         leaf, cm, eps):
    """K5 in either payload mode: (t, enc, obj, n)."""
    device, R, M, I = _tlas_launch_args(o, d, p1, e1, e2, caabb, inst_ab,
                                        inst_aabb, inst_mesh, inst_obj, leaf,
                                        cm, payload, payload_name)
    t = torch.empty((R,), dtype=torch.float32, device=device)
    enc = torch.empty((R,), dtype=torch.int32, device=device)
    obj = torch.empty((R,), dtype=torch.int32, device=device)
    n = torch.empty((R, 3), dtype=torch.float32, device=device)
    if R:
        err = fn(device.index or 0, _stream(device), o.data_ptr(), d.data_ptr(),
                 R, p1.data_ptr(), e1.data_ptr(), e2.data_ptr(),
                 payload.data_ptr(), caabb.data_ptr(), M, cm, leaf,
                 inst_ab.data_ptr(), inst_aabb.data_ptr(), inst_mesh.data_ptr(),
                 inst_obj.data_ptr(), I, eps, t.data_ptr(), enc.data_ptr(),
                 obj.data_ptr(), n.data_ptr())
        _raise_on(err, name)
        LAUNCHES[name] += 1
    return t, enc, obj, n


def mesh_closest_hit_tlas(o, d, p1, e1, e2, tri_n, caabb, inst_ab, inst_aabb,
                          inst_mesh, inst_obj, leaf: int, cm: int,
                          eps: float = EPSILON):
    """K5: (t, enc, obj, n) as closest_hit_tlas_plain; caabb (M * cm, 6)
    holds the unique meshes' object-space cluster boxes."""
    if o.device.type == "cpu":
        return closest_hit_tlas_plain(o, d, p1, e1, e2, tri_n, inst_ab,
                                      inst_aabb, inst_mesh, inst_obj, leaf,
                                      cm, eps)
    return _closest_tlas_launch("closest_hit_tlas",
                                library().rtc_closest_hit_tlas, o, d, p1, e1,
                                e2, tri_n, "tri_n", caabb, inst_ab, inst_aabb,
                                inst_mesh, inst_obj, leaf, cm, eps)


def mesh_closest_hit_tlas_sn(o, d, p1, e1, e2, tri_sn, caabb, inst_ab,
                             inst_aabb, inst_mesh, inst_obj, leaf: int,
                             cm: int, eps: float = EPSILON):
    """K5 with_sn: (t, enc, obj, n_blend) as closest_hit_tlas_sn_plain."""
    if o.device.type == "cpu":
        return closest_hit_tlas_sn_plain(o, d, p1, e1, e2, tri_sn, inst_ab,
                                         inst_aabb, inst_mesh, inst_obj, leaf,
                                         cm, eps)
    return _closest_tlas_launch("closest_hit_tlas_sn",
                                library().rtc_closest_hit_tlas_sn, o, d, p1,
                                e1, e2, tri_sn, "tri_sn", caabb, inst_ab,
                                inst_aabb, inst_mesh, inst_obj, leaf, cm, eps)


def mesh_any_hit_tlas(o, d, max_t, p1, e1, e2, caabb, inst_ab, inst_aabb,
                      inst_mesh, leaf: int, cm: int, eps: float = EPSILON):
    """K6: (R,) bool as any_hit_tlas_plain."""
    if o.device.type == "cpu":
        return any_hit_tlas_plain(o, d, max_t, p1, e1, e2, inst_ab, inst_aabb,
                                  inst_mesh, leaf, cm, eps)
    device, R, M, I = _tlas_launch_args(o, d, p1, e1, e2, caabb, inst_ab,
                                        inst_aabb, inst_mesh, None, leaf, cm)
    _check("max_t", max_t, torch.float32, (R,), device)
    hit = torch.empty((R,), dtype=torch.bool, device=device)
    if R:
        err = library().rtc_any_hit_tlas(
            device.index or 0, _stream(device), o.data_ptr(), d.data_ptr(),
            max_t.data_ptr(), R, p1.data_ptr(), e1.data_ptr(), e2.data_ptr(),
            caabb.data_ptr(), M, cm, leaf, inst_ab.data_ptr(),
            inst_aabb.data_ptr(), inst_mesh.data_ptr(), I, eps, hit.data_ptr())
        _raise_on(err, "any_hit_tlas")
        LAUNCHES["any_hit_tlas"] += 1
    return hit
