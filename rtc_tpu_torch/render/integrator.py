"""Wavefront Whitted integrator (counterpart of rtc_tpu/render/integrator.py).

The reference recurses per pixel (src/world.rs:80-163); here each node of
the statically unrolled bounce tree shades a whole wavefront of rays. With
the reference's budget semantics each secondary ray costs 3 budget, so
RECURSION_LIMIT = 5 yields two shading levels (primary + one reflection
and one refraction child).

Ported: analytic prims, flat and smooth triangle meshes, instanced meshes
(on the kernel path, K5 for closest hit and K6 for shadows, as rtc_tpu's
TLAS path), tables over rtc_tpu's VMEM budget (streamed in superblocks by
the kernel wrappers), the elementwise cross-check backend (K7a, K7b),
patterns, shadows, reflection, refraction with the n1/n2 crossing census,
the Schlick blend, and primitive sharding (cfg.prim_axis inside a sharded
call of parallel/shard.py: the scene's triangle table is one rank's shard,
and closest_hit, is_shadowed and refraction_indices combine their partial
results over the prims group). Masked lanes carry finite dummy values, and
dead lanes are parked outside every box so the kernels' traversal drops
them at once.

Gradients: the pure-PyTorch path is differentiable as it stands. Every
closest-hit kernel call goes through a torch.autograd.Function (KernelClosest
... KernelClosestTlasSn), the counterparts of rtc_tpu's eight custom JVPs
(:130-458): the kernel's outputs come back unchanged, and the backward
recomputes one Möller-Trumbore at the winning triangle, so the gradients
are exact with respect to the rays, the triangle rows, the normals and the
instance transforms. Occlusion and the crossing census stay
non-differentiable, as in rtc_tpu (:892, :1027): they run under no_grad.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import intersect, lighting, normals, patterns
from ..ops.kernels import mesh_intersect as mi
from ..ops.vec import affine3, normalize, normalize3, pack3, safe_sqrt, unpack3
from ..parallel import collectives as coll
from ..parallel import mesh as grid
from ..scene.compile import Scene
from ..scene.materials import NONE
from ..utils.config import RenderConfig
from ..utils.constants import BIG, FAR, PARK

# kind codes (scene.shapes.KIND_CODES)
SPHERE, PLANE, CUBE, CYLINDER, CONE = 0, 1, 2, 3, 4


class HitInfo(NamedTuple):
    t: torch.Tensor        # (R,) hit time (BIG on a miss)
    valid: torch.Tensor    # (R,) bool
    obj: torch.Tensor      # (R,) i32 object id (0 on a miss)
    prim: torch.Tensor     # (R,) analytic prim id (0 unless a prim won)
    tri: torch.Tensor      # (R,) i32 triangle id (0 on a miss)
    is_tri: torch.Tensor   # (R,) bool: a triangle won
    tri_n: torch.Tensor    # (R, 3) the winning triangle's unit world normal


KERNEL_IMPLS = ("kernel", "elementwise")


def _prim_axis(cfg: RenderConfig):
    """The prims axis of the active rank grid (parallel/mesh.py Axis), or
    None without primitive sharding. A config that names a prim axis
    outside a sharded call raises."""
    return None if cfg.prim_axis is None else grid.axis(cfg.prim_axis)


def mesh_impl_for(scene: Scene, cfg: RenderConfig, is_cuda: bool, dtype) -> str:
    """'kernel', 'elementwise' or 'bruteforce' for rays of dtype on a CUDA
    device (is_cuda) or the CPU. 'auto' takes the
    kernels for f32 tensors on CUDA and a clustered table, and the dense
    sweep otherwise; a scene without triangles has nothing for the kernels
    and sweeps its prims. An explicit 'kernel' or 'elementwise' raises on
    a CPU or f64 tensor and on an unclustered triangle table
    (compile_scene(cluster_size=0)), and so does 'elementwise' under the
    prim axis (rtc_tpu :552-560): its tile walk is built for the whole
    world table."""
    st = scene.static
    impl = cfg.mesh_impl
    if impl == "auto":
        impl = ("kernel" if st.n_clusters and is_cuda
                and dtype == torch.float32 else "bruteforce")
    if impl in KERNEL_IMPLS and not st.n_tris:
        impl = "bruteforce"
    if impl in KERNEL_IMPLS and not st.n_clusters:
        raise ValueError(
            f"mesh_impl={impl!r} walks the cluster tables, and this scene's "
            f"{st.n_tris} triangles are unclustered (cluster_size=0); compile "
            "it with a cluster size or use 'bruteforce'")
    if impl == "elementwise" and cfg.prim_axis is not None:
        raise ValueError(
            "mesh_impl='elementwise' does not support primitive sharding; use "
            "'kernel' (K1, K2 and K4 on each shard's own tables) or 'bruteforce'")
    if impl in KERNEL_IMPLS and not (is_cuda and dtype == torch.float32):
        raise ValueError(
            f"mesh_impl={impl!r} runs the CUDA kernels, which take float32 "
            f"tensors on a CUDA device (got {dtype} on "
            f"{'a CUDA device' if is_cuda else 'the CPU'})")
    return impl


def _use_tlas(scene: Scene, cfg: RenderConfig, impl: str) -> bool:
    """The instanced path (K5, K6) serves a scene with TLAS tables on the
    kernel backend (rtc_tpu :510-519); 'bruteforce' and 'elementwise'
    sweep the world table, and so does the prim axis: the shards are of
    the world table, and the TLAS tables stay whole and unused."""
    return (bool(scene.static.tlas_n_inst) and impl == "kernel"
            and cfg.prim_axis is None)


def _use_fused_shadow(scene: Scene, cfg: RenderConfig, impl: str) -> bool:
    """Fused closest+shadow eligibility (rtc_tpu :522-536): kernel backend,
    shadows on, no prim axis (a shard's shadow ray needs the whole combined
    hit first), a pure-mesh scene, flat or smooth, not instanced (K3 would
    sweep the instanced scene's whole world table), and a table that fits
    one superblock of rtc_tpu's VMEM budget (43/49 of it when smooth: the
    corner-normal slab), so a larger one streams through K1 and K2. The
    budget is a TPU artifact, kept so both packages take the same route."""
    st = scene.static
    budget = (mi.VMEM_TRI_BUDGET * 43) // 49 if st.any_smooth else mi.VMEM_TRI_BUDGET
    return (cfg.fused_shadow and cfg.shadows and impl == "kernel"
            and cfg.prim_axis is None and st.n_prims == 0 and st.n_tris > 0
            and not _use_tlas(scene, cfg, impl)
            and mi._blocked(scene.tri_p1, st.cluster_size, budget) == 1)


def streams(scene: Scene, cfg: RenderConfig, device) -> bool:
    """Does a frame of scene under cfg on device stream a table in
    superblocks (mesh_intersect.py closest_hit_blocked, any_hit_blocked,
    crossing_count_blocked)? A shape test: a kernel route
    on a world table of more than VMEM_TRI_BUDGET rows (_blocked > 1),
    where K1 and K2 sweep that table (the 'kernel' route without the
    instanced tables) or K4 counts crossings on it (a mesh container with
    the refraction child, max_depth >= 4). K3, K5, K6 and K7 never stream."""
    st = scene.static
    if not st.n_tris:
        return False
    impl = mesh_impl_for(scene, cfg, torch.device(device).type == "cuda",
                         cfg.torch_dtype())
    if (impl not in KERNEL_IMPLS
            or mi._blocked(scene.tri_p1, st.cluster_size, mi.VMEM_TRI_BUDGET) == 1):
        return False
    census = bool(st.refr_mesh_obj_ids) and st.any_refractive and cfg.max_depth >= 4
    return census or (impl == "kernel" and not _use_tlas(scene, cfg, impl))


def device_ids(ids, device):
    """The ints ids as a (K,) int64 tensor made on device by fills, so no
    data is copied from the host (a graph capture takes it)."""
    out = torch.empty((len(ids),), dtype=torch.long, device=device)
    for k, i in enumerate(ids):
        out[k].fill_(i)  # out[k] = i would copy a host scalar
    return out


def corner_normals(scene: Scene):
    """The (T, 9) table [sn1 | sn2 | sn3] that K1/K3 with_sn read."""
    return torch.cat([scene.tri_sn1, scene.tri_sn2, scene.tri_sn3], dim=1)


# --- exact gradients through the forward-only kernels ----------------------
#
# Each Function takes `search`, a kernel's wrapper (in the CPU tests, its
# plain version) as a callable of the differentiable inputs in order, and
# those inputs. forward runs the search on the detached inputs and returns
# its outputs unchanged; backward mirrors the JVP's refined(...): it
# recomputes the winner's Möller-Trumbore (and, where the JVP does, the
# corner blend and the instance affine) under autograd and pulls the
# incoming gradients through it. As rtc_tpu's JVPs (idx_c = where(hit_ok,
# idx, 0), then where(hit_ok, dt, 0.0)), every shape is the wavefront's:
# the closed form runs on every ray, a miss (the raw winner id, the
# search's second output, is -1) reads a stand-in row, and its incoming
# gradients are zeroed, so it adds an exact zero (intersect.triangle
# divides by 1.0 where det is small, so its partials are finite even on a
# padding row). Nothing waits on the host, and a CUDA graph captures the
# backward. Ids and shadow flags are non-differentiable, as rtc_tpu's
# float0 tangents.
# backward evaluates the closed form in float64: its partials cancel (t is
# f * (e2 . q) with f = 1 / det), so float32 evaluations in two orders
# differ by more than 1e-3 on some grazing hits, rtc_tpu's JVP and its
# transpose included; in float64 the gradient is the exact derivative at
# the kernel's float32 inputs, rounded once. Table rows are gathered with
# index_select, whose backward adds with atomics: indexing's backward sorts
# and sums each row's rays one by one, which took 0.24 s a tile of 460,800
# cow rays with the misses on row 0. Triangle rows spread the rays' atomics
# over many addresses; an object's few rows do not, so object_record
# gathers its parameter fields through ObjectRows, whose backward sums by
# block without atomics (mi.object_rows_sum).

def _stand_in(win, rows: int):
    """Each ray's stand-in row, which a miss reads: ray k reads row k mod
    rows. With every miss on row 0 their atomic adds of zeros would all
    land on one address: K3's backward over cow's 460,800 rays (396k
    misses) took 4.85 ms spread and 7.31 ms on row 0 on an H100 80GB HBM3
    at 700 W (chip_smoke.py phase 19 times both), and 5.13 ms when it
    gathered the hit rays with torch.nonzero."""
    return torch.arange(win.shape[0], dtype=win.dtype, device=win.device) % max(rows, 1)


def _forward(ctx, search, eps, inputs, rows=None):
    """rows: the winner ids' range, the first table's rows by default."""
    with torch.no_grad():  # the kernels take contiguous rows (camera rays expand o)
        outs = search(*(x.detach().contiguous() for x in inputs))
    ctx.eps = eps
    ctx.rows = inputs[2].shape[0] if rows is None else rows
    ctx.mark_non_differentiable(*(y for y in outs if not y.is_floating_point()))
    ctx.save_for_backward(*inputs, outs[1])
    return outs


def _pull(ctx, lead: int, grads, refined):
    """The gradients of a Function's inputs (saved by _forward after `lead`
    leading arguments that are not differentiable): refined(o, d, *tables,
    i), on every ray's o, d and winner id i (a miss's its _stand_in row),
    gives one output per entry of grads, whose miss rays are zeroed. None
    for the leading arguments and every input that needs no gradient."""
    *inputs, win = ctx.saved_tensors
    needs = ctx.needs_input_grad[lead:]
    if not any(needs):
        return (None,) * (lead + len(inputs))
    hit = win >= 0
    with torch.enable_grad():
        xs = [x.detach().requires_grad_(n) for x, n in zip(inputs, needs)]
        ys = refined(*(x.double() for x in xs),
                     torch.where(hit, win, _stand_in(win, ctx.rows)).long())
        pairs = [(y, torch.where(hit.view(-1, *(1,) * (g.dim() - 1)), g.double(), 0.0))
                 for y, g in zip(ys, grads) if y.requires_grad]
        got = iter(torch.autograd.grad(
            [y for y, _ in pairs], [x for x, n in zip(xs, needs) if n],
            [g for _, g in pairs], allow_unused=True))
    # + 0.0 makes a -0.0 gradient 0.0, as an index_add into zeros does: the
    # bytes of a backward over the hit rays alone (tests hold them equal)
    return (None,) * lead + tuple(_plus_zero(next(got)) if n else None for n in needs)


def _plus_zero(g):
    return None if g is None else g + 0.0


def _rows(i, *tables):
    return (x.index_select(0, i) for x in tables)


def _winner_t(o, d, p1, e1, e2, i, eps):
    return intersect.triangle(o, d, *_rows(i, p1, e1, e2), eps)[0]


def _winner_sn(o, d, p1, e1, e2, snc, i, eps):
    """The winner's t and corner blend (rtc_tpu :236-249)."""
    t, _, u, v = intersect.triangle(o, d, *_rows(i, p1, e1, e2), eps)
    return t, mi.corner_blend(u, v, snc.index_select(0, i))


class KernelClosest(torch.autograd.Function):
    """(t, idx) of K7a, mesh_closest_hit_elementwise; gradients to o, d,
    p1, e1, e2 (rtc_tpu _kernel_closest_jvp :155)."""

    @staticmethod
    def forward(ctx, search, eps, o, d, p1, e1, e2):
        return _forward(ctx, search, eps, (o, d, p1, e1, e2))

    @staticmethod
    def backward(ctx, gt, _):
        return _pull(ctx, 2, (gt,), lambda *x: (_winner_t(*x, ctx.eps),))


class KernelClosestN(torch.autograd.Function):
    """(t, idx, n) of K1 with_n, mesh_closest_hit (one launch or streamed
    t0 launches); n is the winner's tri_n row, so tri_n gets gradients too
    (rtc_tpu _kernel_closest_n_jvp :276)."""

    @staticmethod
    def forward(ctx, search, eps, o, d, p1, e1, e2, tri_n):
        return _forward(ctx, search, eps, (o, d, p1, e1, e2, tri_n))

    @staticmethod
    def backward(ctx, gt, _, gn):
        def refined(o, d, p1, e1, e2, tri_n, i):
            return _winner_t(o, d, p1, e1, e2, i, ctx.eps), tri_n.index_select(0, i)
        return _pull(ctx, 2, (gt, gn), refined)


class KernelClosestUv(torch.autograd.Function):
    """(t, idx, uv) of K1 with_uv, mesh_closest_hit_uv (streamed); uv
    (R, 2) is the winner's barycentric (u, v) (rtc_tpu
    _kernel_closest_uv_jvp :210)."""

    @staticmethod
    def forward(ctx, search, eps, o, d, p1, e1, e2):
        return _forward(ctx, search, eps, (o, d, p1, e1, e2))

    @staticmethod
    def backward(ctx, gt, _, guv):
        def refined(o, d, p1, e1, e2, i):
            t, _, u, v = intersect.triangle(o, d, *_rows(i, p1, e1, e2), ctx.eps)
            return t, torch.stack([u, v], 1)
        return _pull(ctx, 2, (gt, guv), refined)


class KernelClosestSn(torch.autograd.Function):
    """(t, idx, n) of K1 with_sn, mesh_closest_hit_sn; n is the winner's
    unnormalized corner blend, so the (T, 9) corner table snc gets
    gradients too (rtc_tpu _kernel_closest_sn_jvp :251)."""

    @staticmethod
    def forward(ctx, search, eps, o, d, p1, e1, e2, snc):
        return _forward(ctx, search, eps, (o, d, p1, e1, e2, snc))

    @staticmethod
    def backward(ctx, gt, _, gn):
        return _pull(ctx, 2, (gt, gn), lambda *x: _winner_sn(*x, ctx.eps))


class KernelClosestShadow(torch.autograd.Function):
    """(t, idx, n, shadowed) of K3, mesh_closest_shadow: KernelClosestN's
    gradients; the shadow flag has none (rtc_tpu
    _kernel_closest_shadow_jvp :316)."""

    @staticmethod
    def forward(ctx, search, eps, o, d, p1, e1, e2, tri_n):
        return _forward(ctx, search, eps, (o, d, p1, e1, e2, tri_n))

    @staticmethod
    def backward(ctx, gt, _, gn, __):
        return KernelClosestN.backward(ctx, gt, None, gn)


class KernelClosestShadowSn(torch.autograd.Function):
    """(t, idx, n, shadowed) of K3 with_sn, mesh_closest_shadow_sn:
    KernelClosestSn's gradients (rtc_tpu _kernel_closest_shadow_sn_jvp
    :354)."""

    @staticmethod
    def forward(ctx, search, eps, o, d, p1, e1, e2, snc):
        return _forward(ctx, search, eps, (o, d, p1, e1, e2, snc))

    @staticmethod
    def backward(ctx, gt, _, gn, __):
        return KernelClosestSn.backward(ctx, gt, None, gn)


def _tlas_refined(ctx, smooth: bool):
    """The JVPs' refined(...) of K5 (rtc_tpu :420-431, :474-490): the
    winner's Möller-Trumbore in its instance's object space, its normal
    (face, or corner blend) pushed to world space. enc = instance * tm +
    mesh-local row."""
    def refined(o, d, p1, e1, e2, payload, inst_ab, enc):
        k = enc // ctx.tm
        row = ctx.inst_mesh[k].long() * ctx.tm + enc % ctx.tm
        ab = inst_ab.index_select(0, k)
        o2, d2 = mi.instance_rays(o, d, ab)
        if smooth:
            t, n = _winner_sn(o2, d2, p1, e1, e2, payload, row, ctx.eps)
        else:
            t = _winner_t(o2, d2, p1, e1, e2, row, ctx.eps)
            n = payload.index_select(0, row)
        return t, mi.normal_to_world(n, ab)
    return refined


class KernelClosestTlas(torch.autograd.Function):
    """(t, enc, obj, n) of K5, mesh_closest_hit_tlas; gradients to o, d,
    the unique meshes' p1, e1, e2 and face normals, and the instance
    transforms inst_ab (rtc_tpu _kernel_closest_tlas_jvp :404). tm is the
    rows a unique mesh (cm * leaf), inst_mesh each instance's mesh."""

    @staticmethod
    def forward(ctx, search, eps, tm, inst_mesh, o, d, p1, e1, e2, tri_n, inst_ab):
        ctx.tm, ctx.inst_mesh = tm, inst_mesh
        return _forward(ctx, search, eps, (o, d, p1, e1, e2, tri_n, inst_ab),
                        rows=tm * inst_ab.shape[0])

    @staticmethod
    def backward(ctx, gt, _, __, gn):
        return _pull(ctx, 4, (gt, gn), _tlas_refined(ctx, False))


class KernelClosestTlasSn(torch.autograd.Function):
    """(t, enc, obj, n) of K5 with_sn, mesh_closest_hit_tlas_sn; as
    KernelClosestTlas with the object-space corner table sn (rtc_tpu
    _kernel_closest_tlas_sn_jvp :458)."""

    @staticmethod
    def forward(ctx, search, eps, tm, inst_mesh, o, d, p1, e1, e2, sn, inst_ab):
        ctx.tm, ctx.inst_mesh = tm, inst_mesh
        return _forward(ctx, search, eps, (o, d, p1, e1, e2, sn, inst_ab),
                        rows=tm * inst_ab.shape[0])

    @staticmethod
    def backward(ctx, gt, _, __, gn):
        return _pull(ctx, 4, (gt, gn), _tlas_refined(ctx, True))


def _local_rays(inv, o, d):
    """Rays in each prim's object space: inv (N, 3, 4), o/d (R, 3) ->
    (R, N, 3) each."""
    o_l = torch.einsum("nij,rj->rni", inv[:, :, :3], o) + inv[:, :, 3]
    d_l = torch.einsum("nij,rj->rni", inv[:, :, :3], d)
    return o_l, d_l


def prim_candidates(scene: Scene, o, d, eps, ids=None):
    """(R, N, 4) candidate t and validity of every analytic prim. Every
    kind runs on every prim, masked by kind (rtc_tpu :64-105). ids
    restricts the sweep to a subset of prims (the refraction census)."""
    inv, kind, params = scene.prim_inv, scene.prim_kind, scene.prim_params
    if ids is not None:
        sel = device_ids(ids, inv.device)
        inv, kind, params = inv[sel], kind[sel], params[sel]
    o_l, d_l = _local_rays(inv, o, d)
    ymin, ymax = params[:, 0], params[:, 1]
    capped = params[:, 2] > 0.5

    def pad4(h: intersect.Hits):
        extra = h.t.shape[:-1] + (4 - h.t.shape[-1],)
        return intersect.Hits(torch.cat([h.t, h.t.new_zeros(extra)], -1),
                              torch.cat([h.valid, h.valid.new_zeros(extra)], -1))

    sp = pad4(intersect.sphere(o_l, d_l))
    pl = pad4(intersect.plane(o_l, d_l, eps))
    cu = pad4(intersect.cube(o_l, d_l, eps))
    cy = pad4(intersect.cylinder(o_l, d_l, ymin, ymax, capped, eps))
    co = pad4(intersect.cone(o_l, d_l, ymin, ymax, capped, eps))

    k = kind[None, :, None]
    t = torch.where(k == SPHERE, sp.t, 0.0)
    v = (k == SPHERE) & sp.valid
    for code, h in ((PLANE, pl), (CUBE, cu), (CYLINDER, cy), (CONE, co)):
        t = torch.where(k == code, h.t, t)
        v = torch.where(k == code, h.valid, v)
    return t, v


def tri_candidates(scene: Scene, o, d, eps, with_uv: bool = False):
    """The dense ray x triangle sweep of the world table: (R, T) t and
    validity, and with_uv the barycentric u and v (rtc_tpu :108-117)."""
    t, valid, u, v = intersect.triangle(
        o[:, None, :], d[:, None, :], scene.tri_p1[None], scene.tri_e1[None],
        scene.tri_e2[None], eps)
    return (t, valid, u, v) if with_uv else (t, valid)


def _tlas_closest(scene: Scene, o, d, cfg: RenderConfig):
    """K5 on the scene's instanced tables, with_sn where the instanced
    meshes are smooth (rtc_tpu :492-507), reported as mesh_closest reports
    a hit, plus K5's object id: (t, idx, unit n, obj). The instance-local
    winner maps to its world-table row through tlas.gid (rtc_tpu :585-594,
    :673-691); idx == 0 on a miss."""
    st, tl = scene.static, scene.tlas
    fn, kernel = ((KernelClosestTlasSn, mi.mesh_closest_hit_tlas_sn) if st.tlas_sn
                  else (KernelClosestTlas, mi.mesh_closest_hit_tlas))

    def search(o, d, p1, e1, e2, payload, inst_ab):
        return kernel(o, d, p1, e1, e2, payload, tl.caabb, inst_ab, tl.inst_aabb,
                      tl.inst_mesh, tl.inst_obj, st.cluster_size, st.tlas_cm,
                      cfg.epsilon)
    t, enc, obj, n = fn.apply(search, cfg.epsilon, st.tlas_cm * st.cluster_size,
                              tl.inst_mesh, o, d, tl.p1, tl.e1, tl.e2,
                              tl.sn if st.tlas_sn else tl.n, tl.inst_ab)
    idx = torch.where(enc >= 0, tl.gid.reshape(-1)[enc.clamp_min(0).long()], 0)
    return t, idx, normalize(n), obj


def mesh_closest(scene: Scene, o, d, cfg: RenderConfig):
    """Closest triangle hit: (t, idx, n); t == BIG, idx == 0 and n == 0 on
    a miss. n is the winner's unit world normal: its face normal, or for a
    smooth scene its corner normals blended by (u, v) and normalized
    (rtc_tpu :605-618). 'kernel' launches K1 (with_n or with_sn; streamed
    over a table above the VMEM budget, K1 t0 with_n or, smooth, with_uv
    and one gathered blend, :619-630), or K5 for an instanced scene;
    'elementwise' launches K7a and gathers the normal (:702-717);
    'bruteforce' is the dense sweep of the world table."""
    impl = mesh_impl_for(scene, cfg, o.is_cuda, o.dtype)
    if _use_tlas(scene, cfg, impl):
        return _tlas_closest(scene, o, d, cfg)[:3]
    st, eps = scene.static, cfg.epsilon
    tabs = (scene.tri_p1, scene.tri_e1, scene.tri_e2)
    args = (scene.cluster_aabb, st.cluster_size, eps)
    if impl == "elementwise":
        t, idx = KernelClosest.apply(
            lambda *x: mi.mesh_closest_hit_elementwise(
                *x, scene.cluster_aabb, scene.super_aabb, st.cluster_size, eps),
            eps, o, d, *tabs)
        hit = idx >= 0
        if st.any_smooth:
            n = normalize(mi.smooth_blend(o, d, *tabs, corner_normals(scene),
                                          idx, eps))
        else:
            n = torch.where(hit[:, None],
                            scene.tri_n.index_select(0, idx.clamp_min(0).long()), 0.0)
    elif st.any_smooth:
        snc = corner_normals(scene)
        if impl != "kernel":
            t, idx, n = mi.closest_hit_sn_plain(o, d, *tabs, snc, eps)
        elif st.n_tris <= mi.VMEM_TRI_BUDGET:
            t, idx, n = KernelClosestSn.apply(
                lambda *x: mi.mesh_closest_hit_sn(*x, *args), eps, o, d, *tabs, snc)
        else:
            # streamed: the winner's (u, v), then one (R, 9) gather and
            # the blend in rtc_tpu's order
            t, idx, uv = KernelClosestUv.apply(
                lambda *x: mi.mesh_closest_hit_uv(*x, *args), eps, o, d, *tabs)
            n = mi.corner_blend(uv[:, 0], uv[:, 1],
                                snc.index_select(0, idx.clamp_min(0).long()))
            n = torch.where((idx >= 0)[:, None], n, 0.0)
        n = normalize(n)
    elif impl == "kernel":
        t, idx, n = KernelClosestN.apply(
            lambda *x: mi.mesh_closest_hit(*x, *args), eps, o, d, *tabs, scene.tri_n)
    else:
        t, idx, n = mi.closest_hit_plain(o, d, *tabs, scene.tri_n, eps)
    return t, idx.clamp_min(0), n


def _tri_obj(scene: Scene, idx):
    st = scene.static
    if st.single_tri_obj >= 0:
        # single-mesh scene: every triangle shares one object id
        return torch.full_like(idx, st.single_tri_obj)
    return scene.tri_obj[idx.long()]


def _min_by_t_over_axis(ax, t, obj, n, row):
    """Combine the ranks' closest triangle hits over the prims axis
    (rtc_tpu :731-745): the least t wins, a tie goes to the lowest rank
    (argmin's first minimum), and its object id, normal and row come with
    it. The gather of (t, n) is differentiable, so a hit's gradient flows
    back to the rank whose shard holds the winner
    (collectives.all_gather_replicated: every rank shades the combined
    hit alike)."""
    tn = coll.all_gather_replicated(torch.cat([t[:, None], n], 1), ax)  # (D, R, 4)
    ids = coll.all_gather(torch.stack([obj, row], 1), ax)              # (D, R, 2)
    win = torch.argmin(tn[:, :, 0], dim=0)[None, :, None]
    tn = torch.gather(tn, 0, win.expand(1, -1, 4))[0]
    ids = torch.gather(ids, 0, win.expand(1, -1, 2))[0]
    return tn[:, 0], ids[:, 0], tn[:, 1:], ids[:, 1]


def closest_hit(scene: Scene, o, d, cfg: RenderConfig) -> HitInfo:
    """World::intersect + Intersection::hit: the global min over t >= 0 of
    the prims' and the triangles' candidates; a tie goes to the prim
    (reference: src/world.rs:43-54, src/intersection.rs:79-84).

    Under the prim axis the triangle table is this rank's shard: its
    closest hit combines with the other ranks' by least t
    (_min_by_t_over_axis), and tri is the winner's row of the whole
    table, as a single device reports it."""
    R = o.shape[0]
    st = scene.static
    i32 = dict(dtype=torch.int32, device=o.device)
    t_p = torch.full((R,), BIG, dtype=o.dtype, device=o.device)
    idx_p = torch.zeros((R,), **i32)
    if st.n_prims:
        t, v = prim_candidates(scene, o, d, cfg.epsilon)
        tt = torch.where(v & (t >= 0.0), t, BIG).reshape(R, -1)
        idx_flat = torch.argmin(tt, dim=1)
        t_p = torch.gather(tt, 1, idx_flat[:, None])[:, 0]
        idx_p = (idx_flat // 4).to(torch.int32)
    t_t = torch.full((R,), BIG, dtype=o.dtype, device=o.device)
    idx_t = torch.zeros((R,), **i32)
    tri_obj = torch.zeros((R,), **i32)
    tri_n = torch.zeros_like(o)
    if st.n_tris and _use_tlas(scene, cfg, mesh_impl_for(scene, cfg, o.is_cuda, o.dtype)):
        # K5 selects the winner's object id itself
        t_t, idx_t, tri_n, tri_obj = _tlas_closest(scene, o, d, cfg)
    elif st.n_tris:
        t_t, idx_t, tri_n = mesh_closest(scene, o, d, cfg)
        tri_obj = _tri_obj(scene, idx_t)
        ax = _prim_axis(cfg)
        if ax is not None:
            t_t, tri_obj, tri_n, idx_t = _min_by_t_over_axis(
                ax, t_t, tri_obj, tri_n, idx_t + scene.tri_offset)
    is_tri = t_t < t_p
    t_hit = torch.where(is_tri, t_t, t_p)
    prim_obj = scene.prim_obj[idx_p.long()] if st.n_prims else torch.zeros((R,), **i32)
    return HitInfo(t=t_hit, valid=t_hit < BIG * 0.5,
                   obj=torch.where(is_tri, tri_obj, prim_obj), prim=idx_p,
                   tri=idx_t, is_tri=is_tri, tri_n=tri_n)


class Intersections(NamedTuple):
    """Per-ray sorted intersection lists, the wavefront form of the
    reference's World::intersect -> Intersections (src/world.rs:43-54,
    src/intersection.rs:86): (R, K) buffers sorted ascending by t,
    negative ts included (only hit() filters, src/intersection.rs:79-84).
    u and v are the barycentric coordinates of triangle entries (0 on
    analytic prims'); a list built by hand may leave them None."""

    t: torch.Tensor       # (R, K)
    obj: torch.Tensor     # (R, K) i32 object ids
    valid: torch.Tensor   # (R, K) bool
    u: torch.Tensor = None
    v: torch.Tensor = None


def intersect_all(scene: Scene, o, d, cfg: RenderConfig,
                  k: int | None = None) -> Intersections:
    """World::intersect for a wavefront: every object's candidate ts,
    merged and sorted ascending per ray (reference: src/world.rs:43-54;
    rtc_tpu :767-816).

    k bounds the list: K = min(k, candidate slots); None keeps them all.
    This is the conformance and utility API: the render path takes the
    kernels, which never build the list. Both sweeps are dense (the
    prims' slots and the whole triangle table), O(R * (4N + T)) in time
    and memory. Ties keep candidate order, prim slots first and then
    triangle rows, in the order the objects were inserted, as the
    reference's stable sort does (src/world.rs:51): a stable sort, since
    torch.topk promises no order among equal keys."""
    st = scene.static
    R = o.shape[0]
    parts_t, parts_v, parts_obj, parts_u, parts_w = [], [], [], [], []
    if st.n_prims:
        t, v = prim_candidates(scene, o, d, cfg.epsilon)     # (R, N, 4)
        parts_t.append(t.reshape(R, -1))
        parts_v.append(v.reshape(R, -1))
        parts_obj.append(scene.prim_obj.repeat_interleave(4))
        parts_u.append(t.new_zeros((R, 4 * st.n_prims)))
        parts_w.append(t.new_zeros((R, 4 * st.n_prims)))
    if st.n_tris:
        t, v, bu, bv = tri_candidates(scene, o, d, cfg.epsilon, with_uv=True)
        parts_t.append(t)
        parts_v.append(v)
        parts_obj.append(scene.tri_obj)
        parts_u.append(bu)
        parts_w.append(bv)
    if not parts_t:
        z = o.new_zeros((R, 0))
        return Intersections(t=z, obj=z.to(torch.int32), valid=z.to(torch.bool),
                             u=z, v=z)
    t = torch.cat(parts_t, dim=1)
    cols = torch.cat(parts_obj)
    kk = t.shape[1] if k is None else min(k, t.shape[1])
    tt, idx = torch.sort(torch.where(torch.cat(parts_v, dim=1), t, BIG), dim=1,
                         stable=True)
    tt, idx = tt[:, :kk], idx[:, :kk]
    valid = tt < BIG * 0.5
    sel = lambda parts: torch.where(
        valid, torch.gather(torch.cat(parts, dim=1), 1, idx), 0.0)
    return Intersections(t=tt, obj=cols[idx], valid=valid, u=sel(parts_u),
                         v=sel(parts_w))


def hit_index(xs: Intersections):
    """Intersection::hit: per ray the index into the K axis of the lowest
    non-negative valid t, or -1 when there is none (reference:
    src/intersection.rs:79-84). The lists are sorted by t, so that is the
    first such entry; argmax returns the first maximum, and takes no bool
    tensor, hence the cast. An empty list (a world with no objects) gives
    -1 on every ray, where rtc_tpu's argmax raises."""
    ok = xs.valid & (xs.t >= 0.0)
    if ok.shape[1] == 0:
        return torch.full(ok.shape[:1], -1, dtype=torch.int32, device=ok.device)
    first = torch.argmax(ok.to(torch.int8), dim=1).to(torch.int32)
    return torch.where(ok.any(dim=1), first, -1)


def normal_at(scene: Scene, hit: HitInfo, world_point, eps):
    """World-space unit normal at the hit (reference: src/shape.rs:466-519):
    the triangle's from closest-hit time, else the prim's, through its
    inverse-transpose. world_point: its (R,) components. Both products with
    the hit prim's matrices are affine3's, by component: an einsum would
    run a cuBLAS batched gemv over one 3x3 a ray."""
    if not scene.static.n_prims:
        return hit.tri_n
    p = hit.prim.long()
    inv, invT = scene.prim_inv[p], scene.prim_invT[p]
    params, kind = scene.prim_params[p], scene.prim_kind[p]
    p_l = affine3(inv, *world_point)
    n_l = normals.sphere(p_l)
    n_l = torch.where((kind == PLANE)[:, None], normals.plane(p_l), n_l)
    n_l = torch.where((kind == CUBE)[:, None], normals.cube(p_l), n_l)
    n_l = torch.where((kind == CYLINDER)[:, None],
                      normals.cylinder(p_l, params[:, 0], params[:, 1], eps), n_l)
    n_l = torch.where((kind == CONE)[:, None], normals.cone(p_l), n_l)
    n_p = normalize(affine3(invT, *unpack3(n_l)))
    return torch.where(hit.is_tri[:, None], hit.tri_n, n_p)


def shadow_query(scene: Scene, point, live=None):
    """is_shadowed's query from each point toward the light: (unit
    direction (R, 3), distance (R,)), the distance -1 on dead lanes (live
    False), which never report a hit."""
    px, py, pz = unpack3(point)
    lx, ly, lz = scene.light_pos.unbind(0)
    vx, vy, vz = lx - px, ly - py, lz - pz
    distance = torch.sqrt(torch.clamp_min(vx * vx + vy * vy + vz * vz, 1e-30))
    direction = pack3(vx / distance, vy / distance, vz / distance)
    if live is not None:
        distance = torch.where(live, distance, -1.0)
    return direction, distance


@torch.no_grad()
def is_shadowed(scene: Scene, point, cfg: RenderConfig, live=None):
    """Shadow ray toward the light (reference: src/world.rs:100-114).

    `hit().t < distance` is "any candidate t in [0, distance)": a dense
    prim sweep OR the any-hit kernel on the triangles (K6 on an instanced
    scene's tables, K2 otherwise, streamed over a table above the VMEM
    budget; K7b on 'elementwise'; the plain sweep of the world table on
    'bruteforce'); under the prim axis, of this rank's shard, ORed over
    the prims group (rtc_tpu :916-920). live: optional (R,) bool; dead
    lanes get max_t = -1 and report unshadowed. Not differentiable
    (rtc_tpu stops its gradients, :892), so no graph is kept.
    """
    direction, distance = shadow_query(scene, point, live)
    st = scene.static
    shadowed = torch.zeros(point.shape[:1], dtype=torch.bool, device=point.device)
    if st.n_prims:
        t, valid = prim_candidates(scene, point, direction, cfg.epsilon)
        shadowed = torch.any((valid & (t >= 0.0)
                              & (t < distance[:, None, None])).flatten(1), dim=1)
    if st.n_tris:
        tabs = (scene.tri_p1, scene.tri_e1, scene.tri_e2)
        impl = mesh_impl_for(scene, cfg, point.is_cuda, point.dtype)
        if _use_tlas(scene, cfg, impl):
            tl = scene.tlas
            found = mi.mesh_any_hit_tlas(point, direction, distance, tl.p1,
                                         tl.e1, tl.e2, tl.caabb, tl.inst_ab,
                                         tl.inst_aabb, tl.inst_mesh,
                                         st.cluster_size, st.tlas_cm,
                                         cfg.epsilon, occ=scene.tlas_occ)
        elif impl == "kernel":
            found = mi.mesh_any_hit(point, direction, distance, *tabs,
                                    scene.cluster_aabb,
                                    st.cluster_size, cfg.epsilon, occ=scene.occ)
        elif impl == "elementwise":
            found = mi.mesh_any_hit_elementwise(
                point, direction, distance, *tabs, scene.cluster_aabb,
                scene.super_aabb, st.cluster_size, cfg.epsilon)
        else:
            found = mi.any_hit_plain(point, direction, distance, *tabs,
                                     cfg.epsilon)
        ax = _prim_axis(cfg)
        if ax is not None:
            found = coll.all_reduce(found.to(torch.int32), ax) > 0
        shadowed = shadowed | found
    return shadowed


# object_record's entries and the scene's per-object fields they read
RECORD_FIELDS = (
    ("pat_kind", "pat_kind"), ("pat_a", "pat_a"), ("pat_b", "pat_b"),
    ("pat_inv", "pat_inv"), ("color", "mat_color"), ("ambient", "mat_ambient"),
    ("diffuse", "mat_diffuse"), ("specular", "mat_specular"),
    ("shininess", "mat_shininess"), ("reflective", "mat_reflective"),
    ("transparency", "mat_transparency"), ("ior", "mat_ior"),
)


class ObjectRows(torch.autograd.Function):
    """Each field's rows (O, ...) of the rays' objects obj (R,): one (R, ...)
    output a field, so no differentiable slice of a wider gather remains
    (each slice's backward would fill and add the whole width). With one
    object, its row expanded. backward sums each present gradient into
    its field's table in one pass, mi.object_rows_sum: on the card a block
    reduction in place of index_select's atomics, which took every ray of
    an object one at a time at the same few addresses."""

    @staticmethod
    def forward(ctx, obj, *fields):
        ctx.save_for_backward(obj)
        ctx.rows = fields[0].shape[0]
        if ctx.rows == 1:
            return tuple(x[0].expand(obj.shape[0], *x.shape[1:]) for x in fields)
        idx = obj.long()
        return tuple(x.index_select(0, idx) for x in fields)

    @staticmethod
    def backward(ctx, *grads):
        (obj,) = ctx.saved_tensors
        sums = iter(mi.object_rows_sum(obj, [g for g in grads if g is not None],
                                       ctx.rows))
        return (None, *(None if g is None else next(sums) for g in grads))


def object_record(scene: Scene, obj):
    """The per-object shading data of the rays' objects obj (R,): {entry:
    (R, ...)}. The fields that need a gradient (grad enabled and the field
    requires it: the parameters) go through ObjectRows; the others through
    one gather of their columns side by side, detached, so autograd
    records nothing for them. With no parameter, that one gather holds
    every field."""
    grad = torch.is_grad_enabled()
    params = [(k, f) for k, f in RECORD_FIELDS if grad and getattr(scene, f).requires_grad]
    rest = [(k, getattr(scene, f).detach()) for k, f in RECORD_FIELDS if (k, f) not in params]
    O = scene.pat_inv.shape[0]
    cols = [x.reshape(O, -1).to(scene.pat_a.dtype) for _, x in rest]
    tbl = torch.cat(cols, dim=1)
    if scene.static.n_objects == 1:
        g = tbl[0].expand(obj.shape[0], tbl.shape[1])
    else:
        g = tbl.index_select(0, obj.long())
    rec, a = {}, 0
    for (k, x), c in zip(rest, cols):
        b = a + c.shape[1]
        v = g[:, a] if x.dim() == 1 else g[:, a:b].reshape(-1, *x.shape[1:])
        rec[k] = v.to(x.dtype)
        a = b
    if params:
        rows = ObjectRows.apply(obj, *(getattr(scene, f) for _, f in params))
        rec.update(zip((k for k, _ in params), rows))
    return rec


@torch.no_grad()
def mesh_census(scene: Scene, o, d, t_hit, hit_gid, cfg: RenderConfig):
    """The mesh containers' crossing census: (cnt (R, K) i32, last (R, K)),
    per ray and container slot the crossings at t < t_hit (t_hit -BIG: a
    dead lane) and the latest of them, the triangle hit_gid (a row of the
    whole table; -2: none) excluded. K4 on the kernel path, its plain
    sweep otherwise. Not differentiable (rtc_tpu stops its gradients,
    :1027).

    Under the prim axis each rank counts on its shard with its own
    occlusion tables, excluding hit_gid where the shard holds that row,
    and the counts SUM and the latest crossings MAX over the prims group:
    exactly the whole table's census. (rtc_tpu sweeps replicated container
    slabs densely there, :1041-1052; the port keeps no such slabs.)"""
    st = scene.static
    ax = _prim_axis(cfg)
    if ax is not None:
        local = hit_gid - scene.tri_offset
        hit_gid = torch.where((local >= 0) & (local < scene.tri_p1.shape[0]),
                              local, -2)
    tabs = (scene.tri_p1, scene.tri_e1, scene.tri_e2)
    K = len(st.refr_mesh_obj_ids)
    # rtc_tpu's 'pallas' backend runs its dense refr_tri_* sweep here,
    # which is no Pallas kernel (rtc_tpu :1041-1052); the port keeps no
    # such slabs, so 'elementwise' launches K4 too: it counts exactly on
    # the card, and it keeps the plain census off the card's path
    if mesh_impl_for(scene, cfg, o.is_cuda, o.dtype) in KERNEL_IMPLS:
        cnt, last = mi.mesh_crossing_count(
            o, d, t_hit.contiguous(), hit_gid.contiguous(), *tabs,
            scene.cluster_aabb, scene.tri_cid, K, st.cluster_size, cfg.epsilon,
            occ=scene.occ)
    else:
        cnt, last = mi.crossing_count_plain(o, d, t_hit, hit_gid, *tabs,
                                            scene.tri_cid, K, cfg.epsilon)
    if ax is not None:
        cnt, last = coll.all_reduce(cnt, ax), coll.all_reduce(last, ax, "max")
    return cnt, last


def refraction_indices(scene: Scene, o, d, hit: HitInfo, cfg: RenderConfig,
                       n2_enter=None, live=None):
    """n1/n2 by crossing parity: the equivalent of the reference's
    containers walk over the sorted intersection list
    (src/intersection.rs:29-62), as rtc_tpu :970-1073.

    For each container (static.refr_prim_ids, static.refr_mesh_obj_ids),
    count its crossings strictly before t_hit, negative t included: odd
    parity means the ray is inside it, and the top of the containers stack
    is the inside container whose latest crossing is latest. Mesh
    crossings come from the census, K4 on the kernel path and its plain
    sweep otherwise (mesh_census, which also combines a prim-sharded
    table's counts); the hit triangle is excluded by id.

    live: optional (R,) bool of the rays whose shading reads n1/n2; the
    others leave the mesh census (t bound -BIG) and get defaults that no
    caller reads.
    """
    st = scene.static
    ids, mesh_ids = st.refr_prim_ids, st.refr_mesh_obj_ids
    R = o.shape[0]
    one = torch.ones((R,), dtype=o.dtype, device=o.device)
    if n2_enter is None:
        n2_enter = scene.mat_ior[hit.obj.long()] if st.n_objects else one
    if not ids and not mesh_ids:
        return one, n2_enter

    cnts, lasts, objs = [], [], []
    if ids:
        t, v = prim_candidates(scene, o, d, cfg.epsilon, ids=ids)  # (R, Ka, 4)
        before = v & (t < hit.t[:, None, None])
        cnts.append(before.sum(2, dtype=torch.int32))
        lasts.append(torch.where(before, t, -BIG).amax(2))
        objs.extend(ids)  # prim id == object id
    if mesh_ids:
        hit_gid = torch.where(hit.is_tri, hit.tri, -2).to(torch.int32)
        t_census = hit.t if live is None else torch.where(live, hit.t, -BIG)
        cnt_m, last_m = mesh_census(scene, o, d, t_census, hit_gid, cfg)
        cnts.append(cnt_m)
        lasts.append(last_m)
        objs.extend(mesh_ids)

    cnt = torch.cat(cnts, dim=1)                        # (R, K)
    last = torch.cat(lasts, dim=1)                      # (R, K)
    cont_obj = device_ids(objs, o.device)
    inside = (cnt % 2) == 1
    sub_ior = scene.mat_ior[cont_obj]                   # (K,)

    def stack_top(mask):
        j = torch.argmax(torch.where(mask, last, -BIG), dim=1)
        return torch.where(mask.any(1), sub_ior[j], 1.0)

    is_self = cont_obj[None, :] == hit.obj[:, None]
    self_inside = (inside & is_self).any(1)
    n1 = stack_top(inside)
    n2 = torch.where(self_inside, stack_top(inside & ~is_self), n2_enter)
    return n1, n2


class Comps(NamedTuple):
    """prepare_computations (reference: src/intersection.rs:17-77), packed.
    n1/n2 are real indices only for rays live in the census; elsewhere
    they are defaults that no caller reads (rtc_tpu's Comps invariant)."""

    point: torch.Tensor
    eyev: torch.Tensor
    normalv: torch.Tensor   # flipped toward the eye when inside
    inside: torch.Tensor
    over_point: torch.Tensor
    under_point: torch.Tensor
    reflectv: torch.Tensor
    n1: torch.Tensor
    n2: torch.Tensor


class Comps3(NamedTuple):
    """Comps in component form: every 3-vector is a tuple of three (R,)
    tensors."""

    point: tuple
    eyev: tuple
    normalv: tuple         # flipped toward the eye when inside
    inside: torch.Tensor
    over_point: tuple
    under_point: tuple
    reflectv: tuple
    n1: torch.Tensor
    n2: torch.Tensor


def prepare_hit3(scene: Scene, o, d, hit: HitInfo, cfg: RenderConfig,
                 n2_enter=None, need_refraction: bool = True,
                 refraction_live=None) -> Comps3:
    """The shading frame of a wavefront of hits (rtc_tpu :1114-1160).
    Misses carry finite dummies; callers mask on hit.valid. Every formula
    keeps rtc_tpu's association order. need_refraction=False skips the
    n1/n2 census (leaf nodes never read it); refraction_live masks it per
    ray (see refraction_indices)."""
    eps = cfg.epsilon
    t_safe = torch.where(hit.valid, hit.t, 1.0)
    ox, oy, oz = unpack3(o)
    dx, dy, dz = unpack3(d)
    px, py, pz = ox + dx * t_safe, oy + dy * t_safe, oz + dz * t_safe
    ex, ey, ez = -dx, -dy, -dz
    nx, ny, nz = unpack3(normal_at(scene, hit, (px, py, pz), eps))
    inside = (nx * ex + ny * ey + nz * ez) < 0.0
    nx = torch.where(inside, -nx, nx)
    ny = torch.where(inside, -ny, ny)
    nz = torch.where(inside, -nz, nz)
    k = 2.0 * (dx * nx + dy * ny + dz * nz)
    if need_refraction:
        n1, n2 = refraction_indices(scene, o, d, hit, cfg, n2_enter=n2_enter,
                                    live=refraction_live)
    else:
        n1 = n2 = torch.ones(o.shape[:1], dtype=o.dtype, device=o.device)
    return Comps3(
        point=(px, py, pz),
        eyev=(ex, ey, ez),
        normalv=(nx, ny, nz),
        inside=inside,
        over_point=(px + nx * eps, py + ny * eps, pz + nz * eps),
        under_point=(px - nx * eps, py - ny * eps, pz - nz * eps),
        reflectv=(dx - nx * k, dy - ny * k, dz - nz * k),
        n1=n1,
        n2=n2,
    )


def prepare_hit(scene: Scene, o, d, hit: HitInfo, cfg: RenderConfig,
                n2_enter=None, need_refraction: bool = True,
                refraction_live=None) -> Comps:
    """Packed (R, 3) view of prepare_hit3."""
    c = prepare_hit3(scene, o, d, hit, cfg, n2_enter=n2_enter,
                     need_refraction=need_refraction,
                     refraction_live=refraction_live)
    return Comps(point=pack3(*c.point), eyev=pack3(*c.eyev),
                 normalv=pack3(*c.normalv), inside=c.inside,
                 over_point=pack3(*c.over_point),
                 under_point=pack3(*c.under_point),
                 reflectv=pack3(*c.reflectv), n1=c.n1, n2=c.n2)


def schlick(cos_eye_normal, n1, n2):
    """Fresnel approximation (reference: src/intersection.rs:107-128)."""
    cos = cos_eye_normal
    n = n1 / n2
    sin2_t = n * n * (1.0 - cos * cos)
    tir = (n1 > n2) & (sin2_t > 1.0)
    cos_t = safe_sqrt(1.0 - torch.clamp_max(sin2_t, 1.0))
    cos_used = torch.where(n1 > n2, cos_t, cos)
    r0 = ((n1 - n2) / (n1 + n2)) ** 2
    reflectance = r0 + (1.0 - r0) * (1.0 - cos_used) ** 5
    return torch.where(tir, 1.0, reflectance)


def _park(live, o3, d3):
    """Packed secondary rays, with the lanes that spawn none parked
    pointing away from the scene (src/world.rs:117-119,132-134)."""
    return (pack3(*(torch.where(live, c, FAR) for c in o3)),
            pack3(*(torch.where(live, c, PARK) for c in d3)))


def color_at(scene: Scene, o, d, cfg: RenderConfig, budget: int | None = None):
    """Whole-wavefront color (reference: src/world.rs:80-98). o/d: (R, 3)."""
    if budget is None:
        budget = cfg.max_depth
    st = scene.static
    _prim_axis(cfg)  # a prim axis outside a sharded call raises
    if budget < 1 or st.n_objects == 0:
        return torch.zeros_like(o)

    impl = mesh_impl_for(scene, cfg, o.is_cuda, o.dtype)
    shadowed = None
    if _use_fused_shadow(scene, cfg, impl):
        # one K3 launch: closest hit + the in-register shadow query
        tabs = (scene.tri_p1, scene.tri_e1, scene.tri_e2)
        fn, kernel, payload = (
            (KernelClosestShadowSn, mi.mesh_closest_shadow_sn, corner_normals(scene))
            if st.any_smooth else
            (KernelClosestShadow, mi.mesh_closest_shadow, scene.tri_n))
        t, idx, n, shadowed = fn.apply(
            lambda *x: kernel(*x, scene.cluster_aabb, scene.light_pos,
                              st.cluster_size, cfg.epsilon, occ=scene.occ),
            cfg.epsilon, o, d, *tabs, payload)
        if st.any_smooth:
            n = normalize(n)
        idx = idx.clamp_min(0)
        valid = t < BIG * 0.5
        hit = HitInfo(t=t, valid=valid, obj=_tri_obj(scene, idx),
                      prim=torch.zeros_like(idx), tri=idx, is_tri=valid,
                      tri_n=n)
    else:
        hit = closest_hit(scene, o, d, cfg)
    valid = hit.valid
    rec = object_record(scene, hit.obj)
    can_branch = budget >= 4  # children shade only if budget - 3 >= 1
    reflective, transparency = rec["reflective"], rec["transparency"]
    # n1/n2 are read only by the Snell child and the Schlick blend, which
    # exist only when this node can branch and the hit is transparent
    # (src/world.rs:71-77,132-134)
    comps = prepare_hit3(scene, o, d, hit, cfg, n2_enter=rec["ior"],
                         need_refraction=can_branch and st.any_refractive,
                         refraction_live=valid & (transparency > 0.0))
    px, py, pz = comps.point
    ex, ey, ez = comps.eyev
    nx, ny, nz = comps.normalv
    over = tuple(torch.where(valid, c, FAR) for c in comps.over_point)

    if st.any_pattern:
        # pattern space: one affine per object (pattern_inv @ object_inv),
        # by component (affine3): an einsum is a cuBLAS batched gemv
        pat_p = affine3(rec["pat_inv"], px, py, pz)
        pat_kind = rec["pat_kind"]
        base_color = torch.where(
            (pat_kind == NONE)[:, None], rec["color"],
            patterns.color_at(pat_p, pat_kind, rec["pat_a"], rec["pat_b"]))
    else:
        base_color = rec["color"]

    if shadowed is None and cfg.shadows:
        # occlusion matters only where the surface faces the light
        # (lighting zeroes diffuse+specular when light.normal < 0,
        # src/material.rs:57-67): back-facing lanes leave the sweep
        lx, ly, lz = scene.light_pos.unbind(0)
        lvx, lvy, lvz = normalize3(lx - px, ly - py, lz - pz)
        facing = (lvx * nx + lvy * ny + lvz * nz) >= 0.0
        shadowed = is_shadowed(scene, pack3(*over), cfg, live=valid & facing)
    elif shadowed is None:
        shadowed = torch.zeros_like(valid)
    surface = lighting.lighting3(
        base_color, rec["ambient"], rec["diffuse"], rec["specular"],
        rec["shininess"], scene.light_pos, scene.light_intensity,
        comps.point, comps.eyev, comps.normalv, shadowed)

    refl = torch.zeros_like(o)
    if can_branch and st.any_reflective:  # (src/intersection.rs:27, world.rs:125)
        live_r = valid & (reflective > 0.0)
        refl = color_at(scene, *_park(live_r, over, comps.reflectv), cfg,
                        budget - 3) * reflective[:, None]

    refr = torch.zeros_like(o)
    n1, n2 = comps.n1, comps.n2
    if can_branch and st.any_refractive:
        # Snell construction (reference: src/world.rs:140-162)
        n_ratio = n1 / n2
        cos_i = ex * nx + ey * ny + ez * nz
        sin2_t = n_ratio * n_ratio * (1.0 - cos_i * cos_i)
        tir = sin2_t > 1.0
        cos_t = safe_sqrt(1.0 - torch.clamp_max(sin2_t, 1.0))
        a = n_ratio * cos_i - cos_t
        refr_d = (nx * a - ex * n_ratio, ny * a - ey * n_ratio,
                  nz * a - ez * n_ratio)
        live_t = valid & (transparency > 0.0) & ~tir
        under = tuple(torch.where(valid, c, FAR) for c in comps.under_point)
        refr = (color_at(scene, *_park(live_t, under, refr_d), cfg, budget - 3)
                * transparency[:, None]
                * (~tir).to(o.dtype)[:, None])

    if st.any_reflective and st.any_refractive:
        # the Schlick blend, only where the material is both
        # (src/world.rs:71-77)
        both = (reflective > 0.0) & (transparency > 0.0)
        reflectance = schlick(ex * nx + ey * ny + ez * nz, n1, n2)
        secondary = torch.where(
            both[:, None],
            refl * reflectance[:, None] + refr * (1.0 - reflectance)[:, None],
            refl + refr)
    else:
        secondary = refl + refr
    return torch.where(valid[:, None], surface + secondary, 0.0)
