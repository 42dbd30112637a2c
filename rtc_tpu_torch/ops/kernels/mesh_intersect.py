"""Mesh intersection: the hand-written CUDA kernels K1-K7
(rtc_tpu_torch/csrc/mesh_intersect.cu), their plain PyTorch versions, and
the superblock streaming drivers around K1, K2 and K4.

Counterpart of rtc_tpu/ops/pallas/mesh_intersect.py:

  K1 mesh_closest_hit          <- mesh_closest_hit_mxu(tri_n=...)  (_kernel_mxu)
     mesh_closest_hit(t0=...)  <- mesh_closest_hit_mxu(tri_n=..., t0=...)
     mesh_closest_hit_sn       <- mesh_closest_hit_mxu(tri_sn=...)
     mesh_closest_hit_uv       <- mesh_closest_hit_mxu(want_uv=True)
  K2 mesh_any_hit              <- mesh_any_hit_mxu                 (_anyhit_kernel_mxu)
  K3 mesh_closest_shadow       <- mesh_closest_shadow_mxu          (_kernel_mxu_cs)
     mesh_closest_shadow_sn    <- mesh_closest_shadow_mxu(tri_sn=...)
  K4 mesh_crossing_count       <- mesh_crossing_count_mxu          (_crossing_kernel_mxu)
  K5 mesh_closest_hit_tlas     <- mesh_closest_hit_tlas_mxu(tri_n=...)  (_kernel_mxu_tlas)
     mesh_closest_hit_tlas_sn  <- mesh_closest_hit_tlas_mxu(tri_sn=...)
  K6 mesh_any_hit_tlas         <- mesh_any_hit_tlas_mxu            (_anyhit_kernel_tlas)
  K7a mesh_closest_hit_elementwise <- mesh_closest_hit_pallas      (_kernel)
  K7b mesh_any_hit_elementwise     <- mesh_any_hit_pallas          (_anyhit_kernel)

and, with no TPU counterpart, the object rows' sum (object_rows_sum), the
backward of object_record's gather of its parameter fields, the analytic
prims' sweep (prim_closest, prim_any), the closest hit and the shadow
flag over the scene's prims, and a bounce node's shading (shade_surface,
shade_node, shade_blend; plain versions ops/shading.py) with the backward
of its node and blend stages (shade_node_grad, shade_blend_grad).

Each wrapper of K1-K7 takes f32 tensors. Given tensors on the CPU it
returns its plain version's result; given CUDA tensors it launches its
kernel, or raises; so do object_rows_sum with its float32 gradients, and
the prims' sweep and the shading stages with float32 or float64 rays.
LAUNCHES counts the kernel launches of each wrapper (a call of
object_rows_sum as one). K2, K3, K4 and K6 also take the walks' tables
(occ: scene/compile.py OcclusionTables), which only their kernels read.

Each wrapper launches one kernel on the table it is given, of any size.
The superblock drivers (closest_hit_blocked, any_hit_blocked,
crossing_count_blocked) stream a table in n_blocks cluster superblocks, as
rtc_tpu does (_blocked, :1413-1564), where the integrator's plan says so:
they are device-agnostic PyTorch that call the wrappers once per block, so
on the CPU they run the plain versions block by block. K1 gets views of
each block's rows; K2 and K4 walk the whole table's occlusion tables,
limited to the block's cluster range (clusters=).

The kernels are built from the checkout's sources with nvcc at first use,
into a plain-C shared library under build/kernels/ (content-addressed, so
an edited source is rebuilt), and bound with ctypes.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import shutil
import subprocess

import torch

from ...utils.constants import BIG, EPSILON, FAR
from ...utils.profiling import span
from .. import shading
from ..intersect import prims, triangle
from ..vec import dot3, normalize3

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join(_PKG, "csrc", "mesh_intersect.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
# -fmad=false: the kernels round each multiply and add on its own, as the
# plain versions' separate elementwise operations do (see the source note)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v")

# clusters per supercluster, the kernels' kSuperWidth (K7a/K7b)
SUPER_WIDTH = 8
# threads a block, the kernels' kThreads (K7: ELEMENTWISE_TILE) in the
# default build; block_flags(n) builds another
BLOCK_THREADS = 128
# K7's tile walk (kTileK7, kMaxLeafK7, kK7LaneMin): rays a block, the most
# rows a cluster it stages in shared memory, and the entered lanes a warp,
# on average over the warps holding any, from which a cluster goes a lane a
# ray rather than a warp a ray
ELEMENTWISE_TILE = 256
ELEMENTWISE_MAX_LEAF = 1024
ELEMENTWISE_LANE_MIN = 28

LAUNCHES = {"closest_hit": 0, "any_hit": 0, "closest_shadow": 0,
            "closest_hit_sn": 0, "closest_shadow_sn": 0, "crossing_count": 0,
            "closest_hit_tlas": 0, "closest_hit_tlas_sn": 0, "any_hit_tlas": 0,
            "closest_hit_t0": 0, "closest_hit_uv": 0,
            "closest_hit_elementwise": 0, "any_hit_elementwise": 0,
            "object_rows": 0, "prim_closest": 0, "prim_any": 0,
            "shade_surface": 0, "shade_node": 0, "shade_blend": 0, "shade_grad": 0}


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


def slab_reciprocal(d):
    """The slab reciprocals of directions d (..., 3), as make_ray takes
    them: 1 / d, and +-BIG (by the sign) where a component is near zero."""
    near0 = d.abs() < 1e-30
    return torch.where(near0, torch.where(d >= 0, BIG, -BIG).to(d.dtype),
                       1.0 / torch.where(near0, 1.0, d))


def slab_interval(o, inv, lo, hi, clamp: bool = True):
    """The kernels' slab arithmetic (cluster_slab, box_slab): the signed
    interval (tmin, tmax) of rays with origins o and slab reciprocals inv
    (slab_reciprocal) through boxes lo..hi, all (..., 3) and broadcast
    against each other. clamp: tmin >= -BIG and tmax <= BIG, as the
    kernels clamp; rtc_tpu's superblock order does not."""
    t1, t2 = (lo - o) * inv, (hi - o) * inv
    tmin, tmax = torch.minimum(t1, t2).amax(-1), torch.maximum(t1, t2).amin(-1)
    return (tmin.clamp_min(-BIG), tmax.clamp_max(BIG)) if clamp else (tmin, tmax)


def box_slabs(o, d, aabb, widen: bool = True):
    """The plain version of the kernels' cluster_slab: (R, C) signed slab
    interval (tmin, tmax) of each ray through each box, the box widened by
    4e-6 of its largest coordinate, and the boxes' emptiness (C,).
    widen=False: the boxes are widened already (the occlusion walk's,
    scene/compile.py widen_boxes), and are tested as they are."""
    lo, hi = aabb[:, :3], aabb[:, 3:]
    empty = (lo > hi).any(1)
    if widen:
        pad = 4e-6 * torch.maximum(lo.abs(), hi.abs()).amax(1, keepdim=True)
        lo, hi = lo - pad, hi + pad
    tmin, tmax = slab_interval(o[:, None], slab_reciprocal(d)[:, None], lo[None],
                               hi[None])                       # (R, C)
    return tmin, tmax, empty


def box_entries(o, d, aabb):
    """The plain version of cluster_entry: (R, C) entry t >= 0 of each ray
    into each box; BIG where the ray misses the box, the box lies behind
    it, or the box is empty. K1 and K5 visit boxes in (entry, id) order."""
    tmin, tmax, empty = box_slabs(o, d, aabb)
    ok = ~empty[None] & (tmax >= tmin) & (tmax >= 0.0)
    return torch.where(ok, tmin.clamp_min(0.0), BIG)


def _closest_plain(o, d, p1, e1, e2, eps, t0=None):
    """Nearest triangle with t >= 0 by a dense sweep (rtc_tpu
    integrator.mesh_closest bruteforce, :640-644): t (BIG on a miss) and
    idx (-1 on a miss, the lowest index on a tie). K7a's plain version.
    t0 (R,): a strict bound, as K1's t0 mode: a winner at t >= t0 becomes
    a miss."""
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
    if t0 is not None:
        below = t_out < t0
        t_out = torch.where(below, t_out, BIG)
        idx_out = torch.where(below, idx_out, -1)
    return t_out, idx_out


def closest_hit_plain(o, d, p1, e1, e2, tri_n, eps: float = EPSILON, t0=None):
    """K1's plain version: the dense sweep's (t, idx) and the winner's
    tri_n row (zeros on a miss); t0 as _closest_plain."""
    t, idx = _closest_plain(o, d, p1, e1, e2, eps, t0)
    hit = idx >= 0
    if p1.shape[0] == 0:
        return t, idx, torch.zeros_like(o)
    n = torch.where(hit[:, None], tri_n[idx.clamp_min(0).long()], 0.0)
    return t, idx, n


def closest_hit_uv_plain(o, d, p1, e1, e2, eps: float = EPSILON, t0=None):
    """K1 with_uv's plain version: the dense sweep's (t, idx) and the
    winner's raw barycentric (u, v) (R, 2) from triangle() at its row
    (zeros on a miss); t0 as _closest_plain."""
    t, idx = _closest_plain(o, d, p1, e1, e2, eps, t0)
    if p1.shape[0] == 0:
        return t, idx, o.new_zeros((o.shape[0], 2))
    i = idx.clamp_min(0).long()
    _, _, u, v = triangle(o, d, p1[i], e1[i], e2[i], eps)
    return t, idx, torch.where((idx >= 0)[:, None], torch.stack([u, v], 1), 0.0)


def corner_blend(u, v, g):
    """Corner normals g (R, 9) = [sn1 | sn2 | sn3] blended by barycentric
    (u, v) (R,), unnormalized: w0 = (1 - u) - v, then (w0 sn1 + u sn2) +
    v sn3 per axis, as rtc_tpu (mesh_intersect.py:538-545,
    integrator.py:707-715)."""
    w0 = 1.0 - u - v
    return w0[:, None] * g[:, 0:3] + u[:, None] * g[:, 3:6] + v[:, None] * g[:, 6:9]


def smooth_blend(o, d, p1, e1, e2, tri_sn, idx, eps: float = EPSILON):
    """The winner's corner normals (tri_sn: (T, 9)) blended by its
    barycentric (u, v) (corner_blend), zeros where idx < 0."""
    if p1.shape[0] == 0:
        return torch.zeros_like(o)
    i = idx.clamp_min(0).long()
    # index_select: its backward adds with atomics (render/integrator.py _pull)
    p1, e1, e2, tri_sn = (x.index_select(0, i) for x in (p1, e1, e2, tri_sn))
    _, _, u, v = triangle(o, d, p1, e1, e2, eps)
    return torch.where((idx >= 0)[:, None], corner_blend(u, v, tri_sn), 0.0)


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

    A dense sweep over every row of the triangle tables, chunked over
    rays, each counted only in its own slot (tri_cid; -1: not a container):
    rtc_tpu sweeps its compact refr_tri_* slabs of the container rows,
    which give the same counts and maxima, so the port does not keep them.
    Every shape here follows the tables' (no selection of rows by value),
    so a graph capture takes it. Returns (cnt (R, K) i32, last (R, K) in
    o's dtype)."""
    R, K = o.shape[0], n_containers
    cnt = torch.zeros((R, K), dtype=torch.int32, device=o.device)
    last = torch.full((R, K), -BIG, dtype=o.dtype, device=o.device)
    if tri_cid.shape[0] == 0 or R == 0:
        return cnt, last
    cid = tri_cid
    gid = torch.arange(tri_cid.shape[0], dtype=hit_gid.dtype, device=o.device)
    step = _chunk(R, tri_cid.shape[0], o.device)
    for s in range(0, R, step):
        t, valid = _pair_tests(o[s:s + step], d[s:s + step], p1, e1, e2, eps)
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


# the counting build (-DRTC_COUNT): the walks tally each ray's box tests,
# boxes entered and pair tests by stage (the kernels' enum Counter, in this
# order; bind checks their number against rtc_counters) into the buffer
# rtc_set_count_buffer names
COUNT_FLAGS = ("-DRTC_COUNT",)
COUNTERS = ("inst_group_tests", "inst_tests", "group_tests", "cluster_tests",
            "sub_tests", "inst_entered", "groups_entered", "clusters_entered",
            "subs_entered", "pair_det", "pair_u", "pair_v", "pair_t",
            "super_tests", "supers_entered", "rounds", "round_lanes",
            "tile_clusters", "tile_slots", "tile_by_lane")


def block_flags(threads: int) -> tuple:
    """build()'s extra_flags for per-ray kernels (K1-K6) of threads a block."""
    return (f"-DRTC_THREADS={int(threads)}",)


def build(source: str = SOURCE, extra_flags: tuple = ()) -> str:
    """Compile the kernels of source (once per source text and flag set)
    and return the shared library's path. nvcc's ptxas report (registers,
    spills) is kept beside it as <library>.log."""
    flags = NVCC_FLAGS + tuple(extra_flags)
    with open(source, "rb") as f:
        key = hashlib.sha1(f.read() + " ".join(flags).encode()).hexdigest()[:16]
    lib = os.path.join(BUILD_DIR, f"libmesh_intersect_{key}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    proc = subprocess.run([find_nvcc(), *flags, "-o", tmp, source],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
    with open(lib + ".log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    os.replace(tmp, lib)  # atomic: concurrent builders never see half a file
    return lib


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    return bind(build())


def bind(path: str) -> ctypes.CDLL:
    """Load a build of the kernels and declare its entry points' types."""
    lib = ctypes.CDLL(path)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    closest = [I, P, P, P, I, P, P, P, P, P, I, I, F, P, P, P]
    shadow = [I, P, P, P, I, P, P, P, P, P, I, I, F, P, P, P, P, P, I, P, P, P, P]
    lib.rtc_closest_hit.argtypes = closest
    lib.rtc_closest_hit_sn.argtypes = closest
    lib.rtc_any_hit.argtypes = [I, P, P, P, P, I, P, P, P, P, I, I, I, I, F, P]
    lib.rtc_closest_shadow.argtypes = shadow
    lib.rtc_closest_shadow_sn.argtypes = shadow
    lib.rtc_crossing_count.argtypes = [I, P, P, P, P, P, I, P, P, P, P, I, I, P, P,
                                       P, P, I, I, F, I, P, P]
    closest_tlas = [I, P, P, P, I, P, P, P, P, P, I, I, I, P, P, P, P, I, F,
                    P, P, P, P]
    lib.rtc_closest_hit_tlas.argtypes = closest_tlas
    lib.rtc_closest_hit_tlas_sn.argtypes = closest_tlas
    lib.rtc_any_hit_tlas.argtypes = [I, P, P, P, P, I, P, P, P, P, I, I, I, I,
                                     P, P, P, P, P, I, F, P]
    lib.rtc_closest_hit_bounded.argtypes = [I, P, P, P, P, I, P, P, P, P, P,
                                            I, I, F, P, P, P]
    lib.rtc_closest_hit_elementwise.argtypes = [I, P, P, P, I, P, P, P, P, I,
                                                P, I, I, F, P, P]
    lib.rtc_any_hit_elementwise.argtypes = [I, P, P, P, P, I, P, P, P, P, I, P,
                                            I, I, F, P]
    lib.rtc_object_rows_scratch.argtypes = [I, I, I, I, ctypes.POINTER(ctypes.c_longlong)]
    lib.rtc_object_rows_sum.argtypes = [I, P, P, I, I, P, P, P, I, P, ctypes.c_longlong]
    lib.rtc_prim_sweep.argtypes = [I, P, I, I, P, P, P, I, P, P, P, I, ctypes.c_double,
                                   P, P, P]
    lib.rtc_shade.argtypes = [I, P, I, I, I, I, P, P, I, I, ctypes.c_double, P]
    lib.rtc_shade_grad.argtypes = [I, P, I, I, I, P, P, P, P, P]
    for fn in (lib.rtc_closest_hit, lib.rtc_closest_hit_sn, lib.rtc_any_hit,
               lib.rtc_closest_shadow, lib.rtc_closest_shadow_sn,
               lib.rtc_crossing_count, lib.rtc_closest_hit_tlas,
               lib.rtc_closest_hit_tlas_sn, lib.rtc_any_hit_tlas,
               lib.rtc_closest_hit_bounded,
               lib.rtc_closest_hit_elementwise, lib.rtc_any_hit_elementwise,
               lib.rtc_object_rows_scratch, lib.rtc_object_rows_sum,
               lib.rtc_prim_sweep, lib.rtc_shade, lib.rtc_shade_grad):
        fn.restype = I
    lib.rtc_error_string.argtypes = [I]
    lib.rtc_error_string.restype = ctypes.c_char_p
    if hasattr(lib, "rtc_set_count_buffer"):  # the counting build
        lib.rtc_set_count_buffer.argtypes, lib.rtc_set_count_buffer.restype = [P], I
        lib.rtc_counters.argtypes, lib.rtc_counters.restype = [], I
        if lib.rtc_counters() != len(COUNTERS):
            raise RuntimeError(f"{path} tallies {lib.rtc_counters()} counters, "
                               f"COUNTERS names {len(COUNTERS)}")
        lib.rtc_count_any_hit_table_order.argtypes = [I, P, P, P, P, I, P, P, P, P, I,
                                                      I, F, P]
        lib.rtc_count_any_hit_table_order.restype = I
    return lib


# the kernels that walk boxes, by rtc_walk_kernel_report's index
WALK_KERNELS = ("K1 flat", "K1 with_sn", "K1 with_t0", "K1 with_uv",
                "K1 with_uv t0", "K3 flat", "K3 with_sn", "K5 flat",
                "K5 with_sn", "K6", "K2", "K4", "K7a", "K7b")


def walk_list(lib=None) -> tuple:
    """(L of K1 and K3, L of each of K5's two lists): the ordered walk's
    list lengths, as the kernels were built."""
    fn = (lib or library()).rtc_walk_list
    fn.argtypes, fn.restype = [ctypes.c_void_p] * 2, ctypes.c_int
    v = [ctypes.c_int() for _ in range(2)]
    fn(*map(ctypes.byref, v))
    return v[0].value, v[1].value


def walk_kernel_report(lib=None, leaf: int = 128) -> dict:
    """{kernel: registers a thread, local bytes a thread, shared bytes a
    block (K7's with its two staged clusters of leaf rows), threads a block,
    blocks and threads resident on one SM} of each kernel in WALK_KERNELS,
    as the CUDA runtime reports them for the current device."""
    fn = (lib or library()).rtc_walk_kernel_report
    fn.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 5
    fn.restype = ctypes.c_int
    out = {}
    for k, name in enumerate(WALK_KERNELS):
        v = [ctypes.c_int() for _ in range(5)]
        _raise_on(fn(k, leaf, *map(ctypes.byref, v)), f"report of {name}")
        regs, local, shared, threads, blocks = (x.value for x in v)
        out[name] = dict(registers=regs, local_bytes=local, shared_bytes=shared,
                         block_threads=threads, blocks_per_sm=blocks,
                         threads_per_sm=blocks * threads)
    return out


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
                    payload_name, cluster_aabb, leaf, eps, t0=None,
                    bounded: bool = False):
    """K1 in a payload mode (tri_n, tri_sn, or None for (u, v)), with or
    without the carried bound t0: (t, idx, n or uv). The bounded entry
    point takes the t0 pointer right after d, and null for t0 or payload
    where there is none."""
    device, R, C = _launch_args(o, d, tri_p1, tri_e1, tri_e2, cluster_aabb,
                                leaf, payload, payload_name)
    if t0 is not None:
        _check("t0", t0, torch.float32, (R,), device)
    ptr = lambda x: None if x is None else x.data_ptr()
    bound = (ptr(t0),) if bounded else ()
    t = torch.empty((R,), dtype=torch.float32, device=device)
    idx = torch.empty((R,), dtype=torch.int32, device=device)
    pay = torch.empty((R, 3 if payload is not None else 2),
                      dtype=torch.float32, device=device)
    if R:
        err = fn(device.index or 0, _stream(device), o.data_ptr(), d.data_ptr(),
                 *bound, R, tri_p1.data_ptr(), tri_e1.data_ptr(),
                 tri_e2.data_ptr(), ptr(payload), cluster_aabb.data_ptr(), C,
                 leaf, eps, t.data_ptr(), idx.data_ptr(), pay.data_ptr())
        _raise_on(err, name)
        LAUNCHES[name] += 1
    return t, idx, pay


def mesh_closest_hit(o, d, tri_p1, tri_e1, tri_e2, tri_n, cluster_aabb,
                     leaf: int, eps: float = EPSILON, t0=None):
    """K1: (t, idx, n) as closest_hit_plain. t0 (R,): a strict bound (K1's
    t0 mode)."""
    if o.device.type == "cpu":
        return closest_hit_plain(o, d, tri_p1, tri_e1, tri_e2, tri_n, eps, t0)
    if t0 is None:
        return _closest_launch("closest_hit", library().rtc_closest_hit, o, d,
                               tri_p1, tri_e1, tri_e2, tri_n, "tri_n",
                               cluster_aabb, leaf, eps)
    return _closest_launch("closest_hit_t0", library().rtc_closest_hit_bounded,
                           o, d, tri_p1, tri_e1, tri_e2, tri_n, "tri_n",
                           cluster_aabb, leaf, eps, t0, bounded=True)


def mesh_closest_hit_uv(o, d, tri_p1, tri_e1, tri_e2, cluster_aabb,
                        leaf: int, eps: float = EPSILON, t0=None):
    """K1 with_uv: (t, idx, uv (R, 2)) as closest_hit_uv_plain; t0 as
    mesh_closest_hit."""
    if o.device.type == "cpu":
        return closest_hit_uv_plain(o, d, tri_p1, tri_e1, tri_e2, eps, t0)
    return _closest_launch("closest_hit_uv", library().rtc_closest_hit_bounded,
                           o, d, tri_p1, tri_e1, tri_e2, None, "", cluster_aabb,
                           leaf, eps, t0, bounded=True)


def mesh_closest_hit_sn(o, d, tri_p1, tri_e1, tri_e2, tri_sn, cluster_aabb,
                        leaf: int, eps: float = EPSILON):
    """K1 with_sn: (t, idx, n_blend) as closest_hit_sn_plain; tri_sn is
    the (T, 9) corner-normal table [sn1 | sn2 | sn3]."""
    if o.device.type == "cpu":
        return closest_hit_sn_plain(o, d, tri_p1, tri_e1, tri_e2, tri_sn, eps)
    return _closest_launch("closest_hit_sn", library().rtc_closest_hit_sn, o,
                           d, tri_p1, tri_e1, tri_e2, tri_sn, "tri_sn",
                           cluster_aabb, leaf, eps)


def _cluster_range(clusters, C: int) -> tuple:
    """(c0, c1) of a call's cluster range: clusters, or the whole table."""
    c0, c1 = (0, C) if clusters is None else (int(c) for c in clusters)
    if not 0 <= c0 <= c1 <= C:
        raise ValueError(f"cluster range [{c0}, {c1}) is not inside the {C} clusters")
    return c0, c1


def _range_rows(clusters, leaf: int, *tables):
    """The rows of the cluster range clusters = (c0, c1) of each (T, ...)
    table (all of them without a range), for the plain versions."""
    if clusters is None:
        return tables
    rows = slice(clusters[0] * leaf, clusters[1] * leaf)
    return tuple(x[rows] for x in tables)


def mesh_any_hit(o, d, max_t, tri_p1, tri_e1, tri_e2, cluster_aabb,
                 leaf: int, eps: float = EPSILON, occ=None, clusters=None):
    """K2: (R,) bool as any_hit_plain. occ: the table's OcclusionTables
    (Scene.occ), which the kernel walks; a launch without them raises.
    clusters = (c0, c1): only the rows of clusters [c0, c1) count (a
    superblock of any_hit_blocked)."""
    if o.device.type == "cpu":
        return any_hit_plain(o, d, max_t,
                             *_range_rows(clusters, leaf, tri_p1, tri_e1, tri_e2), eps)
    device, R, C = _launch_args(o, d, tri_p1, tri_e1, tri_e2, cluster_aabb, leaf)
    _check("max_t", max_t, torch.float32, (R,), device)
    c0, c1 = _cluster_range(clusters, C)
    rows, sub, clus, grp, n_sub = _occ_args(occ, C, leaf, device, "any_hit")
    hit = torch.empty((R,), dtype=torch.bool, device=device)
    if R:
        err = library().rtc_any_hit(
            device.index or 0, _stream(device), o.data_ptr(), d.data_ptr(),
            max_t.data_ptr(), R, rows, sub, clus, grp, leaf, n_sub, c0, c1, eps,
            hit.data_ptr())
        _raise_on(err, "any_hit")
        LAUNCHES["any_hit"] += 1
    return hit


def _occ_args(occ, C: int, leaf: int, device, what: str):
    """Validate the occlusion walk's tables (scene/compile.py
    OcclusionTables) of a table of C clusters of leaf rows. Returns the
    pointers of rows, sub_box, cluster_box and group_box, and the
    sub-boxes a cluster."""
    if occ is None:
        raise ValueError(f"{what} walks the occlusion tables (Scene.occ, "
                         "Scene.tlas_occ; scene/compile.py occlusion_tables), "
                         "and none were given")
    n_sub = occ.sub_box.shape[0] // max(C, 1)
    if n_sub < 1 or leaf % n_sub or n_sub * C != occ.sub_box.shape[0]:
        raise ValueError(f"{occ.sub_box.shape[0]} sub-boxes do not cut {C} "
                         f"clusters of {leaf} rows evenly")
    f32 = torch.float32
    _check("occ.rows", occ.rows, f32, (C * leaf, 12), device)
    _check("occ.sub_box", occ.sub_box, f32, (C * n_sub, 6), device)
    _check("occ.cluster_box", occ.cluster_box, f32, (C, 6), device)
    _check("occ.group_box", occ.group_box, f32, (-(-C // SUPER_WIDTH), 6), device)
    return (occ.rows.data_ptr(), occ.sub_box.data_ptr(), occ.cluster_box.data_ptr(),
            occ.group_box.data_ptr(), n_sub)


def _census_args(occ, tri_cid, C: int, leaf: int, device) -> tuple:
    """Validate the census fields of a world table's occlusion tables (built
    with its container slots: occlusion_tables(tri_cid=...)), which must be
    built from tri_cid: the kernel counts by them, not by tri_cid. The
    tables keep the tensor they were built from, so a caller passing that
    one (Scene.tri_cid) is checked by identity, any other by value. Returns
    the pointers of row_id, row_cid, cluster_census and group_census."""
    if occ.row_cid.shape[0] == 0 and C:
        raise ValueError("crossing_count walks the occlusion tables' census fields, "
                         "and these tables were built without container slots "
                         "(occlusion_tables(tri_cid=...))")
    if tri_cid is not occ.tri_cid and not torch.equal(tri_cid, occ.tri_cid):
        raise ValueError("crossing_count counts by the occlusion tables' census "
                         "fields, and these were built from other container slots "
                         "than tri_cid (occlusion_tables(tri_cid=...))")
    _check("occ.row_id", occ.row_id, torch.int32, (C * leaf,), device)
    _check("occ.row_cid", occ.row_cid, torch.int32, (C * leaf,), device)
    _check("occ.cluster_census", occ.cluster_census, torch.bool, (C,), device)
    _check("occ.group_census", occ.group_census, torch.bool, (-(-C // SUPER_WIDTH),),
           device)
    return (occ.row_id.data_ptr(), occ.row_cid.data_ptr(), occ.cluster_census.data_ptr(),
            occ.group_census.data_ptr())


def _shadow_launch(name, fn, o, d, tri_p1, tri_e1, tri_e2, payload,
                   payload_name, cluster_aabb, light_pos, leaf, eps, occ):
    """K3 in either payload mode: (t, idx, n, shadowed)."""
    device, R, C = _launch_args(o, d, tri_p1, tri_e1, tri_e2, cluster_aabb,
                                leaf, payload, payload_name)
    _check("light_pos", light_pos, torch.float32, (3,), device)
    tables = _occ_args(occ, C, leaf, device, name)
    t = torch.empty((R,), dtype=torch.float32, device=device)
    idx = torch.empty((R,), dtype=torch.int32, device=device)
    n = torch.empty((R, 3), dtype=torch.float32, device=device)
    sh = torch.empty((R,), dtype=torch.bool, device=device)
    if R:
        err = fn(device.index or 0, _stream(device), o.data_ptr(), d.data_ptr(),
                 R, tri_p1.data_ptr(), tri_e1.data_ptr(), tri_e2.data_ptr(),
                 payload.data_ptr(), cluster_aabb.data_ptr(), C, leaf, eps,
                 light_pos.data_ptr(), *tables, t.data_ptr(), idx.data_ptr(),
                 n.data_ptr(), sh.data_ptr())
        _raise_on(err, name)
        LAUNCHES[name] += 1
    return t, idx, n, sh


def mesh_closest_shadow(o, d, tri_p1, tri_e1, tri_e2, tri_n, cluster_aabb,
                        light_pos, leaf: int, eps: float = EPSILON, occ=None):
    """K3: (t, idx, n, shadowed) as closest_shadow_plain. occ: the table's
    OcclusionTables (Scene.occ), which the kernel's shadow phase walks; a
    launch without them raises."""
    if o.device.type == "cpu":
        return closest_shadow_plain(o, d, tri_p1, tri_e1, tri_e2, tri_n,
                                    light_pos, eps)
    return _shadow_launch("closest_shadow", library().rtc_closest_shadow, o,
                          d, tri_p1, tri_e1, tri_e2, tri_n, "tri_n",
                          cluster_aabb, light_pos, leaf, eps, occ)


def mesh_closest_shadow_sn(o, d, tri_p1, tri_e1, tri_e2, tri_sn, cluster_aabb,
                           light_pos, leaf: int, eps: float = EPSILON, occ=None):
    """K3 with_sn: (t, idx, n_blend, shadowed) as closest_shadow_sn_plain;
    occ as mesh_closest_shadow."""
    if o.device.type == "cpu":
        return closest_shadow_sn_plain(o, d, tri_p1, tri_e1, tri_e2, tri_sn,
                                       light_pos, eps)
    return _shadow_launch("closest_shadow_sn", library().rtc_closest_shadow_sn,
                          o, d, tri_p1, tri_e1, tri_e2, tri_sn, "tri_sn",
                          cluster_aabb, light_pos, leaf, eps, occ)


def mesh_crossing_count(o, d, t_hit, hit_gid, tri_p1, tri_e1, tri_e2,
                        cluster_aabb, tri_cid, n_containers: int, leaf: int,
                        eps: float = EPSILON, occ=None, clusters=None):
    """K4: (cnt (R, K) i32, last (R, K) f32) as crossing_count_plain.
    t_hit <= -BIG marks a dead lane; hit_gid (R,) i32, a row of the whole
    table, is -2 where the hit is not a triangle. occ: the table's
    OcclusionTables with the census fields of the same tri_cid (Scene.occ;
    compile_scene builds them from Scene.tri_cid), which the kernel walks
    in place of tri_cid; a launch without them, or with tables built from
    other slots, raises. A row whose slot is n_containers or more counts
    nowhere, on the card as in the plain version. clusters = (c0,
    c1): only the rows of clusters [c0, c1) count (a superblock of
    crossing_count_blocked)."""
    if o.device.type == "cpu":
        # the plain version sweeps the range's rows, so the hit row is
        # rebased to them
        first = 0 if clusters is None else clusters[0] * leaf
        return crossing_count_plain(
            o, d, t_hit, hit_gid - first,
            *_range_rows(clusters, leaf, tri_p1, tri_e1, tri_e2, tri_cid),
            n_containers, eps)
    device, R, C = _launch_args(o, d, tri_p1, tri_e1, tri_e2, cluster_aabb, leaf)
    _check("t_hit", t_hit, torch.float32, (R,), device)
    _check("hit_gid", hit_gid, torch.int32, (R,), device)
    _check("tri_cid", tri_cid, torch.int32, (C * leaf,), device)
    if n_containers < 1:
        raise ValueError(f"n_containers must be >= 1, got {n_containers}")
    c0, c1 = _cluster_range(clusters, C)
    rows, sub, clus, grp, n_sub = _occ_args(occ, C, leaf, device, "crossing_count")
    census = _census_args(occ, tri_cid, C, leaf, device)
    cnt = torch.empty((R, n_containers), dtype=torch.int32, device=device)
    last = torch.empty((R, n_containers), dtype=torch.float32, device=device)
    if R:
        err = library().rtc_crossing_count(
            device.index or 0, _stream(device), o.data_ptr(), d.data_ptr(),
            t_hit.data_ptr(), hit_gid.data_ptr(), R, rows, sub, clus, grp, leaf,
            n_sub, *census, c0, c1, eps, n_containers, cnt.data_ptr(),
            last.data_ptr())
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
                      inst_mesh, leaf: int, cm: int, eps: float = EPSILON, occ=None):
    """K6: (R,) bool as any_hit_tlas_plain. occ: the instanced meshes'
    OcclusionTables with their instance slots (Scene.tlas_occ), which the
    kernel walks in place of the rows, cluster boxes and instance boxes; a
    launch without them raises."""
    if o.device.type == "cpu":
        return any_hit_tlas_plain(o, d, max_t, p1, e1, e2, inst_ab, inst_aabb,
                                  inst_mesh, leaf, cm, eps)
    device, R, M, I = _tlas_launch_args(o, d, p1, e1, e2, caabb, inst_ab,
                                        inst_aabb, inst_mesh, None, leaf, cm)
    _check("max_t", max_t, torch.float32, (R,), device)
    if cm % SUPER_WIDTH:
        raise ValueError(f"cm={cm} is not a multiple of the {SUPER_WIDTH}-cluster groups")
    tables = _occ_args(occ, M * cm, leaf, device, "any_hit_tlas")
    _check("occ.inst_perm", occ.inst_perm, torch.int32, (I,), device)
    _check("occ.inst_box", occ.inst_box, torch.float32, (I, 6), device)
    _check("occ.inst_group", occ.inst_group, torch.float32, (-(-I // SUPER_WIDTH), 6),
           device)
    hit = torch.empty((R,), dtype=torch.bool, device=device)
    if R:
        err = library().rtc_any_hit_tlas(
            device.index or 0, _stream(device), o.data_ptr(), d.data_ptr(),
            max_t.data_ptr(), R, *tables[:4], M, cm, leaf, tables[4],
            inst_ab.data_ptr(), inst_mesh.data_ptr(), occ.inst_perm.data_ptr(),
            occ.inst_box.data_ptr(), occ.inst_group.data_ptr(), I, eps,
            hit.data_ptr())
        _raise_on(err, "any_hit_tlas")
        LAUNCHES["any_hit_tlas"] += 1
    return hit


# --- the elementwise cross-check backend: K7a and K7b ----------------------
#
# rtc_tpu's mesh_impl="pallas": an independent three-level walk over the
# world table in table order (superclusters of SUPER_WIDTH clusters,
# super_aabb (S, 6), then clusters, then rows), a block of ELEMENTWISE_TILE
# rays at a time (the tile walk: csrc/mesh_intersect.cu). Their plain
# versions are the dense sweeps _closest_plain and any_hit_plain, which
# compute the same functions.

def _elementwise_args(o, d, tri_p1, tri_e1, tri_e2, cluster_aabb, super_aabb,
                      leaf):
    """Validate a K7 launch's inputs. Returns (device, R, C, S)."""
    device, R, C = _launch_args(o, d, tri_p1, tri_e1, tri_e2, cluster_aabb,
                                leaf)
    S = super_aabb.shape[0]
    _check("super_aabb", super_aabb, torch.float32, (S, 6), device)
    if C != S * SUPER_WIDTH:
        raise ValueError(f"{S} super boxes do not cover {C} clusters in "
                         f"groups of {SUPER_WIDTH}")
    if C and not 1 <= leaf <= ELEMENTWISE_MAX_LEAF:
        raise ValueError(f"leaf={leaf}: the elementwise kernels stage clusters of "
                         f"1 to {ELEMENTWISE_MAX_LEAF} rows")
    return device, R, C, S


def mesh_closest_hit_elementwise(o, d, tri_p1, tri_e1, tri_e2, cluster_aabb,
                                 super_aabb, leaf: int, eps: float = EPSILON):
    """K7a: (t, idx) as _closest_plain: t (BIG on a miss), idx (-1 on a
    miss; the earliest row in table order at the least t)."""
    if o.device.type == "cpu":
        return _closest_plain(o, d, tri_p1, tri_e1, tri_e2, eps)
    device, R, C, S = _elementwise_args(o, d, tri_p1, tri_e1, tri_e2,
                                        cluster_aabb, super_aabb, leaf)
    t = torch.empty((R,), dtype=torch.float32, device=device)
    idx = torch.empty((R,), dtype=torch.int32, device=device)
    if R:
        err = library().rtc_closest_hit_elementwise(
            device.index or 0, _stream(device), o.data_ptr(), d.data_ptr(), R,
            tri_p1.data_ptr(), tri_e1.data_ptr(), tri_e2.data_ptr(),
            cluster_aabb.data_ptr(), C, super_aabb.data_ptr(), S, leaf, eps,
            t.data_ptr(), idx.data_ptr())
        _raise_on(err, "closest_hit_elementwise")
        LAUNCHES["closest_hit_elementwise"] += 1
    return t, idx


def mesh_any_hit_elementwise(o, d, max_t, tri_p1, tri_e1, tri_e2,
                             cluster_aabb, super_aabb, leaf: int,
                             eps: float = EPSILON):
    """K7b: (R,) bool as any_hit_plain."""
    if o.device.type == "cpu":
        return any_hit_plain(o, d, max_t, tri_p1, tri_e1, tri_e2, eps)
    device, R, C, S = _elementwise_args(o, d, tri_p1, tri_e1, tri_e2,
                                        cluster_aabb, super_aabb, leaf)
    _check("max_t", max_t, torch.float32, (R,), device)
    hit = torch.empty((R,), dtype=torch.bool, device=device)
    if R:
        err = library().rtc_any_hit_elementwise(
            device.index or 0, _stream(device), o.data_ptr(), d.data_ptr(),
            max_t.data_ptr(), R, tri_p1.data_ptr(), tri_e1.data_ptr(),
            tri_e2.data_ptr(), cluster_aabb.data_ptr(), C,
            super_aabb.data_ptr(), S, leaf, eps, hit.data_ptr())
        _raise_on(err, "any_hit_elementwise")
        LAUNCHES["any_hit_elementwise"] += 1
    return hit


# ---------------------------------------------------------------------------
# the object rows' sum: the gradient of object_record's parameter fields
# (render/integrator.py ObjectRows)
# ---------------------------------------------------------------------------

def object_rows_sum_plain(ids, grads, n_rows: int):
    """The object rows' sum in plain PyTorch: each (R, ...) gradient of
    grads summed by the rays' ids (R,) into an (n_rows, ...) table, by
    index_add_ (index_select's backward); with one row, the sum over the
    rays (an expand's backward), which reads no ids."""
    if n_rows == 1:
        return [g.sum(0, keepdim=True) for g in grads]
    idx = ids.long()
    return [g.new_zeros((n_rows, *g.shape[1:])).index_add_(0, idx, g) for g in grads]


def object_rows_sum(ids, grads, n_rows: int):
    """The object rows' sum of object_rows_sum_plain. Given CPU tensors,
    the plain version; given CUDA tensors (int32 ids in [0, n_rows),
    float32 gradients), the kernel, run to run the same bits, or a raise.
    The span rtc.object_rows.kernel or rtc.object_rows.plain names the
    path taken."""
    if not ids.is_cuda:
        with span("rtc.object_rows.plain"):
            return object_rows_sum_plain(ids, grads, n_rows)
    with span("rtc.object_rows.kernel"):
        device, R, n = ids.device, ids.shape[0], len(grads)
        _check("ids", ids, torch.int32, (R,), device)
        gs = [g.contiguous() for g in grads]
        for k, g in enumerate(gs):
            _check(f"grads[{k}]", g, torch.float32, (R, *g.shape[1:]), device)
        if R == 0 or not gs:
            return [g.new_zeros((n_rows, *g.shape[1:])) for g in gs]
        widths = [math.prod(g.shape[1:]) for g in gs]
        outs = [g.new_empty((n_rows, *g.shape[1:])) for g in gs]
        lib, index = library(), device.index or 0
        floats = ctypes.c_longlong()
        _raise_on(lib.rtc_object_rows_scratch(index, R, n_rows, sum(widths),
                                              ctypes.byref(floats)), "object_rows")
        scratch = torch.empty((floats.value,), dtype=torch.float32, device=device)
        P = ctypes.c_void_p
        err = lib.rtc_object_rows_sum(
            index, _stream(device), ids.data_ptr() if n_rows > 1 else None, R, n_rows,
            (P * n)(*(g.data_ptr() for g in gs)), (P * n)(*(x.data_ptr() for x in outs)),
            (ctypes.c_int * n)(*widths), n, scratch.data_ptr(), floats)
        _raise_on(err, "object_rows")
        LAUNCHES["object_rows"] += 1
        return outs


# ---------------------------------------------------------------------------
# the analytic prims' sweep (render/integrator.py closest_hit, is_shadowed)
# ---------------------------------------------------------------------------
#
# The prims' tables are the scene's: inv (N, 3, 4) world -> object, kind (N,)
# int32 (intersect.SPHERE .. CONE), params (N, 3) ymin, ymax, capped.

def prim_closest_plain(o, d, inv, kind, params, eps: float = EPSILON):
    """The prims' closest hit in plain PyTorch: over every prim's 4 slots
    (intersect.prims), argmin's first least t of the valid slots with
    t >= 0, BIG elsewhere: (t (R,), prim (R,) int32), (BIG, 0) where none
    is. Differentiable in t (rtc_tpu integrator :560-566)."""
    t, v = prims(inv, kind, params, o, d, eps)
    tt = torch.where(v & (t >= 0.0), t, BIG).reshape(o.shape[0], -1)
    i = torch.argmin(tt, dim=1)
    return torch.gather(tt, 1, i[:, None])[:, 0], (i // 4).to(torch.int32)


def prim_any_plain(o, d, max_t, inv, kind, params, eps: float = EPSILON):
    """The prims' shadow flag in plain PyTorch: does a valid slot lie at
    t in [0, max_t)? Lanes with max_t <= 0 are dead and never hit."""
    t, v = prims(inv, kind, params, o, d, eps)
    return torch.any((v & (t >= 0.0) & (t < max_t[:, None, None])).flatten(1), dim=1)


def _prim_launch(name, o, d, max_t, inv, kind, params, eps):
    """Validate and launch the prim kernel: float32 or float64 rays (R, 3)
    with the tables (N >= 1 prims) in their dtype; max_t (R,) in the any
    mode (name 'prim_any'). Returns (t, prim) or the flags."""
    device, dtype = o.device, o.dtype
    if device.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, got {device}")
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the prim kernel takes float32 or float64 rays, got {dtype}")
    R, N = o.shape[0], inv.shape[0]
    _check("o", o, dtype, (R, 3), device)
    _check("d", d, dtype, (R, 3), device)
    _check("prim_inv", inv, dtype, (N, 3, 4), device)
    _check("prim_kind", kind, torch.int32, (N,), device)
    _check("prim_params", params, dtype, (N, 3), device)
    any_mode = max_t is not None
    if any_mode:
        _check("max_t", max_t, dtype, (R,), device)
        hit = torch.empty((R,), dtype=torch.bool, device=device)
        t = prim = None
    else:
        t = torch.empty((R,), dtype=dtype, device=device)
        prim = torch.empty((R,), dtype=torch.int32, device=device)
        hit = None
    ptr = lambda x: None if x is None else x.data_ptr()
    if R:
        err = library().rtc_prim_sweep(
            device.index or 0, _stream(device), int(dtype == torch.float64),
            int(any_mode), o.data_ptr(), d.data_ptr(), ptr(max_t), R, inv.data_ptr(),
            kind.data_ptr(), params.data_ptr(), N, eps, ptr(t), ptr(prim), ptr(hit))
        _raise_on(err, name)
        LAUNCHES[name] += 1
    return hit if any_mode else (t, prim)


def prim_closest(o, d, inv, kind, params, eps: float = EPSILON):
    """prim_closest_plain's (t, prim): the plain version for CPU tensors;
    for CUDA tensors the prim kernel's closest mode (prim_sweep_kernel),
    bit for bit the plain version's on the card, or a raise. Not
    differentiable: integrator.KernelPrimClosest gives it a backward."""
    if not o.is_cuda:
        return prim_closest_plain(o, d, inv, kind, params, eps)
    return _prim_launch("prim_closest", o, d, None, inv, kind, params, eps)


def prim_any(o, d, max_t, inv, kind, params, eps: float = EPSILON):
    """prim_any_plain's flags (R,) bool: the plain version for CPU tensors;
    for CUDA tensors the prim kernel's any mode, or a raise."""
    if not o.is_cuda:
        return prim_any_plain(o, d, max_t, inv, kind, params, eps)
    return _prim_launch("prim_any", o, d, max_t, inv, kind, params, eps)


# ---------------------------------------------------------------------------
# a bounce node's shading (render/integrator.py color_at; plain versions
# ops/shading.py surface, node, blend_colors)
# ---------------------------------------------------------------------------
#
# hit is a shading.HitInfo (t, valid, obj, prim, is_tri, tri_n), prims a
# shading.Prims or None (no analytic prim), objects a shading.Objects,
# each in the rays' dtype (ids int32, flags bool).

# the node stage's flags (the kernels' ShadeFlag)
SHADE_FLAGS = {"branch_r": 1, "branch_t": 2, "blend": 4, "pattern": 8}
# the kernels' ShadeStage: the node stage with the factors of its backward
# is its own stage, a float32 instance apart from the one frames run
_SHADE_STAGES = {"shade_surface": 0, "shade_node": 1, "shade_blend": 2, "factors": 3}


# shade_surface's and shade_blend's plain versions
shade_surface_plain = shading.surface
shade_blend_plain = shading.blend_colors


def shade_node_plain(o, d, hit, shadowed, n1, n2, prims, objects, light_pos,
                     light_intensity, eps: float = EPSILON, branch_r: bool = False,
                     branch_t: bool = False, blend: bool = False, pattern: bool = False,
                     factors: bool = False):
    """shade_node's plain version, shading.node on the rays' object rows."""
    return shading.node(o, d, hit, shadowed, n1, n2, prims,
                        shading.object_rows(objects, hit.obj), light_pos,
                        light_intensity, eps, branch_r, branch_t, blend, pattern,
                        factors=factors)


def _ray_input(name, x, dtype, shape, device):
    """x as the kernel reads it (contiguous), checked; None stays None."""
    if x is None:
        return None
    x = x.detach().contiguous()
    _check(name, x, dtype, shape, device)
    return x


def _hit_inputs(o, d, hit):
    """(device, dtype, R, [o, d, t, valid, is_tri, prim, tri_n, obj])."""
    device, dtype = o.device, o.dtype
    if device.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, got {device}")
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the shading kernels take float32 or float64 rays, got {dtype}")
    R = o.shape[0]
    i32 = torch.int32
    return device, dtype, R, [
        _ray_input("o", o, dtype, (R, 3), device), _ray_input("d", d, dtype, (R, 3), device),
        _ray_input("t", hit.t, dtype, (R,), device),
        _ray_input("valid", hit.valid, torch.bool, (R,), device),
        _ray_input("is_tri", hit.is_tri, torch.bool, (R,), device),
        _ray_input("prim", hit.prim.to(i32), i32, (R,), device),
        _ray_input("tri_n", hit.tri_n, dtype, (R, 3), device),
        _ray_input("obj", hit.obj.to(i32), i32, (R,), device)]


def _shade_tables(prims, objects, light_pos, light_intensity, dtype, device):
    """(N, O, the kernels' 17 table tensors or None)."""
    out = []
    N = 0 if prims is None else prims.inv.shape[0]
    if N:
        out += [_ray_input("prim_inv", prims.inv, dtype, (N, 3, 4), device),
                _ray_input("prim_invT", prims.invT, dtype, (N, 3, 3), device),
                _ray_input("prim_kind", prims.kind, torch.int32, (N,), device),
                _ray_input("prim_params", prims.params, dtype, (N, 3), device)]
    else:
        out += [None] * 4
    O = 0 if objects is None else objects.pat_kind.shape[0]
    if O:
        widths = {"pat_a": (3,), "pat_b": (3,), "pat_inv": (3, 4), "color": (3,)}
        out += [_ray_input(k, x, torch.int32 if k == "pat_kind" else dtype,
                           (O, *widths.get(k, ())), device)
                for k, x in zip(objects._fields, objects)]
    else:
        out += [None] * 11
    out += [_ray_input("light_pos", light_pos, dtype, (3,), device),
            _ray_input("light_intensity", light_intensity, dtype, (3,), device)]
    return N, O, out


def _shade_launch(name, device, dtype, R, ins, tables, N, O, flags, eps, outs,
                  stage: str | None = None):
    """Launch stage (default: name) of the shading kernel, counted as name:
    ins, its ShadeRays tensors in order (15, None where unread); tables,
    its 17 ShadeTables tensors; outs, its outputs (7, None where unused)."""
    if R:
        P = ctypes.c_void_p
        ptr = lambda x: None if x is None else x.data_ptr()
        outs = list(outs) + [None] * (7 - len(outs))
        err = library().rtc_shade(
            device.index or 0, _stream(device), int(dtype == torch.float64),
            _SHADE_STAGES[stage or name], flags, R, (P * 15)(*map(ptr, ins)),
            (P * 17)(*map(ptr, tables)), N, O, eps, (P * 7)(*map(ptr, outs)))
        _raise_on(err, name)
        LAUNCHES[name] += 1


def shade_surface(o, d, hit, prims, light_pos, eps: float = EPSILON):
    """shade_surface_plain's (origin, direction, distance): the plain
    version for CPU tensors; for CUDA tensors (float32 or float64) the
    shading kernel's surface stage, bit for bit the plain version's, or a
    raise. Not differentiable."""
    if not o.is_cuda:
        return shade_surface_plain(o, d, hit, prims, light_pos, eps)
    device, dtype, R, ins = _hit_inputs(o, d, hit)
    N, O, tables = _shade_tables(prims, None, light_pos, None, dtype, device)
    outs = [torch.empty((R, 3), dtype=dtype, device=device),
            torch.empty((R, 3), dtype=dtype, device=device),
            torch.empty((R,), dtype=dtype, device=device)]
    _shade_launch("shade_surface", device, dtype, R, ins + [None] * 7, tables, N, O, 0,
                  eps, outs + [None] * 3)
    return tuple(outs)


def shade_node(o, d, hit, shadowed, n1, n2, prims, objects, light_pos, light_intensity,
               eps: float = EPSILON, branch_r: bool = False, branch_t: bool = False,
               blend: bool = False, pattern: bool = False, factors: bool = False):
    """shade_node_plain's shading.Node: the plain version for CPU tensors;
    for CUDA tensors the shading kernel's node stage (weights an (R, 4)
    tensor), bit for bit the plain version's, or a raise. factors: also
    the factors of its backward (Node.factors, shade_node_grad), by the
    stage's float32 instance that writes them. Not differentiable."""
    if not o.is_cuda:
        return shade_node_plain(o, d, hit, shadowed, n1, n2, prims, objects, light_pos,
                                light_intensity, eps, branch_r, branch_t, blend, pattern,
                                factors)
    device, dtype, R, ins = _hit_inputs(o, d, hit)
    if factors and dtype != torch.float32:
        raise ValueError(f"the node stage's factors take float32 rays, got {dtype}")
    N, O, tables = _shade_tables(prims, objects, light_pos, light_intensity, dtype, device)
    ins += [_ray_input("shadowed", shadowed, torch.bool, (R,), device),
            _ray_input("n1", n1, dtype, (R,), device),
            _ray_input("n2", n2, dtype, (R,), device), None, None, None, None]
    new = lambda *shape: torch.empty((R, *shape), dtype=dtype, device=device)
    color = new(3)
    refl = (new(3), new(3)) if branch_r else None
    refr = (new(3), new(3)) if branch_t else None
    weights = new(4) if branch_r or branch_t else None
    flags = sum(SHADE_FLAGS[k] for k, on in (("branch_r", branch_r), ("branch_t", branch_t),
                                             ("blend", blend), ("pattern", pattern)) if on)
    fac = new(4) if factors else None
    _shade_launch("shade_node", device, dtype, R, ins, tables, N, O, flags, eps,
                  [color, *(refl or (None, None)), *(refr or (None, None)), weights, fac],
                  stage="factors" if factors else None)
    return shading.Node(color, refl, refr, weights, fac)


def shade_blend(valid, surface, refl, refr, weights, blend: bool = False):
    """shade_blend_plain's colour (R, 3): the plain version for CPU tensors;
    for CUDA tensors (weights shade_node's (R, 4)) the shading kernel's
    blend stage, bit for bit the plain version's, or a raise. Not
    differentiable."""
    if not surface.is_cuda:
        return shade_blend_plain(valid, surface, refl, refr, weights, blend)
    device, dtype, R = surface.device, surface.dtype, surface.shape[0]
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the shading kernels take float32 or float64 rays, got {dtype}")
    ins = [None, None, None, _ray_input("valid", valid, torch.bool, (R,), device)]
    ins += [None] * 7 + [_ray_input("surface", surface, dtype, (R, 3), device),
                         _ray_input("refl", refl, dtype, (R, 3), device),
                         _ray_input("refr", refr, dtype, (R, 3), device),
                         _ray_input("weights", weights, dtype, (R, 4), device)]
    flags = sum(SHADE_FLAGS[k] for k, on in (("branch_r", refl is not None),
                                             ("branch_t", refr is not None),
                                             ("blend", blend)) if on)
    color = torch.empty((R, 3), dtype=dtype, device=device)
    _shade_launch("shade_blend", device, dtype, R, ins, [None] * 17, 0, 0, flags, 0.0,
                  [color])
    return color


# the backward of the node and blend stages (render/integrator.py
# KernelShadeNode, KernelShadeBlend): each ray's partials, which the
# Functions sum by object_rows_sum

def shade_node_grad_plain(g, factors, light_intensity, color: bool = True,
                          light: bool = True):
    """shade_node_grad's plain version: from the upstream gradient g (R, 3)
    of a node's colour and its factors (R, 4) (Node.factors), each ray's
    partial of its object's colour row, g * light_intensity * factors[:, 0]
    (where color), and of the light's intensity, g * factors[:, 1:] (where
    light); None where not wanted."""
    return (g * light_intensity * factors[:, :1] if color else None,
            g * factors[:, 1:] if light else None)


def shade_blend_grad_plain(g, valid, weights, surface: bool = True, refl: bool = True,
                           refr: bool = True, blend: bool = False):
    """shade_blend_grad's plain version: from the upstream gradient g
    (R, 3) of a blend's colour, with the node's valid (R,) and weights
    (shade_node's (R, 4), or the plain version's tuple), the partials of
    blend_colors' surface colour and of the reflected and refracted
    colours (None where not wanted), in autograd's order of blend_colors'
    operations."""
    gs = torch.where(valid[:, None], g, 0.0)
    w = weights.unbind(1) if torch.is_tensor(weights) else weights
    if blend:
        both = ((w[0] > 0.0) & (w[1] > 0.0))[:, None]
        gr = torch.where(both, gs * w[3][:, None], gs)
        gt = torch.where(both, gs * (1.0 - w[3])[:, None], gs)
    else:
        gr = gt = gs
    return (gs if surface else None, gr * w[0][:, None] if refl else None,
            gt * w[2][:, None] * w[1][:, None] if refr else None)


def _shade_grad_launch(stage: int, flags: int, g, saved, valid, light_intensity, wants):
    """Launch the shading backward's stage (the kernels' ShadeGradStage) on
    float32 CUDA tensors: g (R, 3), saved (R, 4); one (R, 3) output a true
    entry of wants (three), None for the others."""
    device, R = g.device, g.shape[0]
    f32 = torch.float32
    g = _ray_input("g", g, f32, (R, 3), device)
    saved = _ray_input("saved", saved, f32, (R, 4), device)
    valid = _ray_input("valid", valid, torch.bool, (R,), device)
    light_intensity = _ray_input("light_intensity", light_intensity, f32, (3,), device)
    outs = [torch.empty((R, 3), dtype=f32, device=device) if w else None for w in wants]
    if R and any(wants):
        P = ctypes.c_void_p
        ptr = lambda x: None if x is None else x.data_ptr()
        err = library().rtc_shade_grad(device.index or 0, _stream(device), stage, flags, R,
                                       g.data_ptr(), saved.data_ptr(), ptr(valid),
                                       ptr(light_intensity), (P * 3)(*map(ptr, outs)))
        _raise_on(err, "shade_grad")
        LAUNCHES["shade_grad"] += 1
    return outs


def shade_node_grad(g, factors, light_intensity, color: bool = True, light: bool = True):
    """shade_node_grad_plain's partials: the plain version for CPU tensors;
    for CUDA tensors (float32) the shading backward's node stage
    (shade_grad_kernel), or a raise."""
    if not g.is_cuda:
        return shade_node_grad_plain(g, factors, light_intensity, color, light)
    if g.dtype != torch.float32:
        raise ValueError(f"the shading backward takes float32 gradients, got {g.dtype}")
    return tuple(_shade_grad_launch(0, 0, g, factors, None, light_intensity,
                                    (color, light, False))[:2])


def shade_blend_grad(g, valid, weights, surface: bool = True, refl: bool = True,
                     refr: bool = True, blend: bool = False):
    """shade_blend_grad_plain's partials: the plain version for CPU tensors;
    for CUDA tensors (float32) the shading backward's blend stage
    (shade_grad_kernel), bit for bit the plain version's, or a raise."""
    if not g.is_cuda:
        return shade_blend_grad_plain(g, valid, weights, surface, refl, refr, blend)
    if g.dtype != torch.float32:
        raise ValueError(f"the shading backward takes float32 gradients, got {g.dtype}")
    return tuple(_shade_grad_launch(1, SHADE_FLAGS["blend"] if blend else 0, g, weights,
                                    valid, None, (surface, refl, refr)))


# ---------------------------------------------------------------------------
# superblock streaming (rtc_tpu mesh_intersect.py:1413-1564)
# ---------------------------------------------------------------------------
#
# A table of more rows than a budget is cut into n_blocks superblocks of
# per_block = ceil(C / n_blocks) clusters, rtc_tpu's cut: the last one may be
# short where rtc_tpu pads it with empty clusters, which no ray enters. The
# drivers call the wrappers once per block: K1 on views of the block's rows
# (no copy), K2 and K4 on the whole table's occlusion tables with the
# block's cluster range.

def _blocked(tri_p1, leaf: int, budget: int) -> int:
    """Number of cluster superblocks for a table of tri_p1.shape[0] padded
    rows (1: no split)."""
    t = tri_p1.shape[0]
    if t <= budget:
        return 1
    per_block = max(budget // leaf, 1)
    return -(-(t // leaf) // per_block)


def _block_tables(n_clusters: int, n_blocks: int):
    """(per_block, [(first cluster, end cluster)] per block): the cluster
    ranges of the superblocks."""
    per_block = -(-n_clusters // n_blocks)
    return per_block, [(b * per_block, min((b + 1) * per_block, n_clusters))
                       for b in range(n_blocks)]


def _block_order(o, d, aabb, per_block: int):
    """Global front-to-back superblock order for a wavefront, as rtc_tpu
    (:1453-1476): each block's union box over its non-empty clusters, a
    slab test of every ray, the earliest entry any ray has into each block,
    and a stable argsort. Parked and dead lanes (origin 1e12) enter no
    block, so they leave the minimum alone. Returns (B,) int64."""
    C = aabb.shape[0]
    n_blocks = -(-C // per_block)
    bid = (torch.arange(C, device=aabb.device) // per_block)[:, None].expand(C, 3)
    empty = (aabb[:, :3] > aabb[:, 3:]).any(1, keepdim=True)
    inf = float("inf")
    lo = aabb.new_full((n_blocks, 3), inf).scatter_reduce(
        0, bid, torch.where(empty, inf, aabb[:, :3]), "amin")
    hi = aabb.new_full((n_blocks, 3), -inf).scatter_reduce(
        0, bid, torch.where(empty, -inf, aabb[:, 3:]), "amax")
    tmin, tmax = slab_interval(o[:, None], slab_reciprocal(d)[:, None], lo[None],
                               hi[None], clamp=False)          # (R, B)
    ov = (tmax >= tmin) & (tmax >= 0.0)
    entry = torch.where(ov, torch.clamp_min(tmin, 0.0), BIG).amin(0)
    return torch.argsort(entry, stable=True)


def closest_hit_blocked(o, d, p1, e1, e2, aabb, n_blocks: int, leaf: int,
                        eps: float = EPSILON, tri_n=None,
                        want_uv: bool = False):
    """Streamed K1 (rtc_tpu _closest_hit_blocked, :1479-1520): the blocks
    in _block_order, each a K1 t0 launch whose bound is the best t carried
    so far, so clusters at or beyond it are never scheduled. Returns (t,
    idx, n) with tri_n, or (t, idx, uv) with want_uv. t equals a single
    launch's bit for bit; idx may differ only at exact ties that straddle
    blocks (a later block cannot beat an equal t)."""
    per_block, blocks = _block_tables(aabb.shape[0], n_blocks)
    order = _block_order(o, d, aabb, per_block).tolist()
    R = o.shape[0]
    t_c = torch.full((R,), BIG, dtype=o.dtype, device=o.device)
    idx_c = torch.full((R,), -1, dtype=torch.int32, device=o.device)
    pay_c = o.new_zeros((R, 2 if want_uv else 3))
    for b in order:
        c0, c1 = blocks[b]
        rows, cl = slice(c0 * leaf, c1 * leaf), slice(c0, c1)
        tabs = (p1[rows], e1[rows], e2[rows])
        if want_uv:
            t_b, idx_b, pay_b = mesh_closest_hit_uv(
                o, d, *tabs, aabb[cl], leaf, eps, t0=t_c)
        else:
            t_b, idx_b, pay_b = mesh_closest_hit(
                o, d, *tabs, tri_n[rows], aabb[cl], leaf, eps, t0=t_c)
        won = idx_b >= 0
        t_c = torch.where(won, t_b, t_c)
        idx_c = torch.where(won, idx_b + c0 * leaf, idx_c)
        pay_c = torch.where(won[:, None], pay_b, pay_c)
    return t_c, idx_c, pay_c


def any_hit_blocked(o, d, max_t, p1, e1, e2, aabb, n_blocks: int, leaf: int,
                    eps: float = EPSILON, occ=None):
    """Streamed K2 (rtc_tpu _any_hit_blocked, :1523-1542): blocks in
    _block_order with a carried found mask; found lanes get max_t = -1, so
    later blocks drop them. Each block is one call over its cluster range of
    the whole table (occ: its OcclusionTables)."""
    per_block, blocks = _block_tables(aabb.shape[0], n_blocks)
    order = _block_order(o, d, aabb, per_block).tolist()
    found = torch.zeros(o.shape[:1], dtype=torch.bool, device=o.device)
    for b in order:
        m = torch.where(found, -1.0, max_t)
        found = found | mesh_any_hit(o, d, m, p1, e1, e2, aabb, leaf, eps, occ=occ,
                                     clusters=blocks[b])
    return found


def crossing_count_blocked(o, d, t_hit, hit_gid, p1, e1, e2, aabb, tri_cid,
                           n_containers: int, n_blocks: int, leaf: int,
                           eps: float = EPSILON, occ=None):
    """Streamed K4 (rtc_tpu _crossing_blocked, :1545-1564): counts summed
    over the blocks and the latest crossings maxed. Each block is one call
    over its cluster range of the whole table (occ: its OcclusionTables),
    where hit_gid names a row of the whole table, so the hit triangle is
    excluded exactly once."""
    per_block, blocks = _block_tables(aabb.shape[0], n_blocks)
    cnt = last = None
    for block in blocks:
        c, l = mesh_crossing_count(o, d, t_hit, hit_gid, p1, e1, e2, aabb, tri_cid,
                                   n_containers, leaf, eps, occ=occ, clusters=block)
        cnt = c if cnt is None else cnt + c
        last = l if last is None else torch.maximum(last, l)
    return cnt, last
