"""Wavefront Whitted integrator (counterpart of rtc_tpu/render/integrator.py).

The reference recurses per pixel (src/world.rs:80-163); here each node of
the statically unrolled bounce tree shades a whole wavefront of rays. With
the reference's budget semantics each secondary ray costs 3 budget, so
RECURSION_LIMIT = 5 yields two shading levels (primary + one reflection
and one refraction child).

Ported: analytic prims, flat and smooth triangle meshes, instanced meshes
(on the kernel path, K5 for closest hit and K6 for shadows, as rtc_tpu's
TLAS path), tables over rtc_tpu's VMEM budget (streamed in superblocks
where plan says so), the elementwise cross-check backend (K7a, K7b),
patterns, shadows, reflection, refraction with the n1/n2 crossing census,
the Schlick blend, and primitive sharding (cfg.prim_axis inside a sharded
call of parallel/shard.py: the scene's triangle table is one rank's shard,
and closest_hit, is_shadowed and refraction_indices combine their partial
results over the prims group). Masked lanes carry finite dummy values, and
dead lanes are parked outside every box so the kernels' traversal drops
them at once. A node's shading (its hits' frame, shadow query, pattern,
Phong, children's rays and blend) runs in the shading kernels where the
plan says so and autograd records nothing, or only the objects' colours
and the light's intensity (KernelShadeNode, KernelShadeBlend), else in
their plain versions (ops/shading.py): shade_route decides.

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

from ..ops import intersect, shading
from ..ops.kernels import mesh_intersect as mi
from ..ops.shading import HitInfo  # noqa: F401  (integrator.HitInfo)
from ..ops.vec import affine3, normalize, pack3, unpack3
from ..parallel import collectives as coll
from ..parallel import mesh as grid
from ..scene.compile import Scene
from ..utils import constants
from ..utils.config import RenderConfig
from ..utils.constants import BIG
from ..utils.profiling import span

# shading nodes by the path that shaded them (shade_route): the shading
# kernels (mi.shade_surface, shade_node, shade_blend), the same under
# autograd with their backward ("grad"), or their plain versions
# (ops/shading.py), color_at's one increment a node; carried through a
# graph's replays (render/compiled.py)
SHADE_NODES = {"kernel": 0, "plain": 0, "grad": 0}


def _prim_axis(cfg: RenderConfig):
    """The prims axis of the active rank grid (parallel/mesh.py Axis), or
    None without primitive sharding. A config that names a prim axis
    outside a sharded call raises."""
    return None if cfg.prim_axis is None else grid.axis(cfg.prim_axis)


def mesh_impl_for(scene: Scene, cfg: RenderConfig, is_cuda: bool, dtype) -> str:
    """'kernel', 'elementwise' or 'bruteforce' for rays of dtype on a CUDA
    device (is_cuda) or the CPU: the triangles' route (the prims' is
    plan's). 'auto' takes the kernels for f32 tensors on CUDA and a
    clustered table, and the dense sweep otherwise; a scene without
    triangles has nothing for them. An explicit 'kernel' or 'elementwise'
    raises on a CPU or f64 tensor and on an unclustered triangle table
    (compile_scene(cluster_size=0)), and so does 'elementwise' under the
    prim axis (rtc_tpu :552-560): its tile walk is built for the whole
    world table."""
    st = scene.static
    impl = cfg.mesh_impl
    if impl == "auto":
        impl = ("kernel" if st.n_clusters and is_cuda
                and dtype == torch.float32 else "bruteforce")
    if impl != "bruteforce" and not st.n_tris:
        impl = "bruteforce"
    if impl != "bruteforce" and not st.n_clusters:
        raise ValueError(
            f"mesh_impl={impl!r} walks the cluster tables, and this scene's "
            f"{st.n_tris} triangles are unclustered (cluster_size=0); compile "
            "it with a cluster size or use 'bruteforce'")
    if impl == "elementwise" and cfg.prim_axis is not None:
        raise ValueError(
            "mesh_impl='elementwise' does not support primitive sharding; use "
            "'kernel' (K1, K2 and K4 on each shard's own tables) or 'bruteforce'")
    if impl != "bruteforce" and not (is_cuda and dtype == torch.float32):
        raise ValueError(
            f"mesh_impl={impl!r} runs the CUDA kernels, which take float32 "
            f"tensors on a CUDA device (got {dtype} on "
            f"{'a CUDA device' if is_cuda else 'the CPU'})")
    return impl


class Plan(NamedTuple):
    """The kernels a frame of one scene under one config runs (plan): the
    one place that decides them. mesh_closest, closest_hit, is_shadowed,
    mesh_census, color_at and compiled.route read it; the kernel wrappers
    launch what they are called for."""
    impl: str     # 'kernel', 'elementwise' or 'bruteforce' (mesh_impl_for)
    tlas: bool    # closest hit by K5 and occlusion by K6 (the instanced tables)
    fused: bool   # closest hit and shadow in one K3 launch
    blocks: int   # the world table's superblocks at the budget (1: one launch)
    uv: bool      # a smooth closest hit by K1 with_uv and one blend, streamed
    census: bool  # a frame counts crossings on the world table (K4)
    prims: bool   # the prims' closest hit and shadow flag by the prim kernel
    shade: bool   # a node's shading by the shading kernels (shade_route)

    @property
    def streams(self) -> bool:
        """Does a frame stream the world table in superblocks
        (mesh_intersect.py closest_hit_blocked, any_hit_blocked,
        crossing_count_blocked)? Where blocks > 1: K1 and K2 on 'kernel'
        without the instanced tables, and K4 on 'kernel' or 'elementwise'.
        K3, K5, K6 and K7 never stream."""
        return self.blocks > 1 and (self.census or (self.impl == "kernel"
                                                    and not self.tlas))


def plan(scene: Scene, cfg: RenderConfig, device, dtype) -> Plan:
    """The Plan of scene under cfg for rays of dtype on device, from the
    scene's static shapes and its world table's padded rows alone, as
    rtc_tpu decides (integrator :510-536):
      tlas    a scene with instanced tables on 'kernel' (rtc_tpu's 'mxu');
              'bruteforce' and 'elementwise' sweep the world table, and so
              does the prim axis: the shards are of the world table, and
              the instanced tables stay whole and unused;
      fused   'kernel', shadows on, no prim axis (a shard's shadow ray needs
              the whole combined hit first), a pure-mesh scene, flat or
              smooth, not instanced (K3 would sweep the world table), and a
              table that fits one superblock (43/49 of the budget when
              smooth: rtc_tpu's corner-normal slab);
      blocks  VMEM_TRI_BUDGET's superblocks of the table (1 on
              'bruteforce', which sweeps it whole);
      uv      'kernel' without the instanced tables, smooth, and more
              triangles (not padded rows) than the budget, where rtc_tpu
              leaves with_sn; such a table has blocks > 1;
      census  a mesh container with the refraction child (max_depth >= 4);
      prims   analytic prims in float32 or float64 on a CUDA device,
              whatever the triangles' route, unless cfg.mesh_impl is
              'bruteforce'; that and the CPU sweep them in PyTorch
              (intersect.prims), the kernel's plain version;
      shade   float32 or float64 on a CUDA device, unless cfg.mesh_impl
              is 'bruteforce' (the prims' rule): the shading kernels,
              where shade_route says so; else their plain versions,
              ops/shading.py."""
    st = scene.static
    impl = mesh_impl_for(scene, cfg, torch.device(device).type == "cuda", dtype)
    budget = constants.VMEM_TRI_BUDGET
    tlas = bool(st.tlas_n_inst) and impl == "kernel" and cfg.prim_axis is None
    fused = (cfg.fused_shadow and cfg.shadows and impl == "kernel"
             and cfg.prim_axis is None and st.n_prims == 0 and st.n_tris > 0
             and not tlas and mi._blocked(
                 scene.tri_p1, st.cluster_size,
                 budget * 43 // 49 if st.any_smooth else budget) == 1)
    blocks = (1 if impl == "bruteforce"
              else mi._blocked(scene.tri_p1, st.cluster_size, budget))
    card = (torch.device(device).type == "cuda" and dtype in (torch.float32, torch.float64)
            and cfg.mesh_impl != "bruteforce")
    return Plan(impl=impl, tlas=tlas, fused=fused, blocks=blocks,
                uv=(impl == "kernel" and not tlas and st.any_smooth
                    and st.n_tris > budget),
                census=(bool(st.refr_mesh_obj_ids) and st.any_refractive
                        and cfg.max_depth >= 4),
                prims=st.n_prims > 0 and card, shade=card)


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


def prim_tables(scene: Scene):
    """The prims' tables the sweep reads: (inv, kind, params)."""
    return scene.prim_inv, scene.prim_kind, scene.prim_params


def prim_candidates(scene: Scene, o, d, eps, ids=None):
    """(R, N, 4) candidate t and validity of every analytic prim
    (intersect.prims: every kind on every prim, masked by kind, rtc_tpu
    :64-105). ids restricts the sweep to a subset of prims (the
    refraction census)."""
    tabs = prim_tables(scene)
    if ids is not None:
        sel = device_ids(ids, tabs[0].device)
        tabs = tuple(x[sel] for x in tabs)
    return intersect.prims(*tabs, o, d, eps)


class KernelPrimClosest(torch.autograd.Function):
    """(t, prim) of the prim kernel's closest mode, mi.prim_closest;
    gradients to o, d and the prims' inv and params (geometry gradients).
    backward re-evaluates each hit ray's winning prim alone on its rows
    (intersect.prim_slots) in the rays' dtype, as the plain sweep computes
    it, and differentiates the least of its valid slots; a miss reads its
    _stand_in row and gets none."""

    @staticmethod
    def forward(ctx, eps, o, d, inv, kind, params):
        with torch.no_grad():
            t, prim = mi.prim_closest(*(x.detach().contiguous()
                                        for x in (o, d, inv, kind, params)), eps)
        ctx.eps = eps
        ctx.mark_non_differentiable(prim)
        ctx.save_for_backward(o, d, inv, kind, params, t, prim)
        return t, prim

    @staticmethod
    def backward(ctx, gt, _):
        o, d, inv, kind, params, t, prim = ctx.saved_tensors
        needs = ctx.needs_input_grad[1:]
        if not any(needs):
            return (None,) * 6
        hit = t < BIG
        i = torch.where(hit, prim, _stand_in(prim, inv.shape[0])).long()
        with torch.enable_grad():
            xs = [x.detach().requires_grad_(n)
                  for x, n in zip((o, d, inv, kind, params), needs)]
            o_, d_, inv_, kind_, params_ = xs
            rows = inv_.index_select(0, i)
            ts, v = intersect.prim_slots(affine3(rows, *unpack3(o_)),
                                         affine3(rows[..., :3], *unpack3(d_)),
                                         kind_.index_select(0, i),
                                         params_.index_select(0, i), ctx.eps)
            tt = torch.where(v & (ts >= 0.0), ts, BIG)
            win = torch.gather(tt, 1, torch.argmin(tt, dim=1, keepdim=True))[:, 0]
            got = iter(torch.autograd.grad(
                win, [x for x, n in zip(xs, needs) if n], torch.where(hit, gt, 0.0),
                allow_unused=True))
        return (None,) + tuple(_plus_zero(next(got)) if n else None for n in needs)


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
    p = plan(scene, cfg, o.device, o.dtype)
    if p.tlas:
        return _tlas_closest(scene, o, d, cfg)[:3]
    st, eps = scene.static, cfg.epsilon
    tabs = (scene.tri_p1, scene.tri_e1, scene.tri_e2)
    args = (scene.cluster_aabb, st.cluster_size, eps)
    streamed = (scene.cluster_aabb, p.blocks, st.cluster_size, eps)
    if p.impl == "elementwise":
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
        if p.impl != "kernel":
            t, idx, n = mi.closest_hit_sn_plain(o, d, *tabs, snc, eps)
        elif p.uv:
            # the winner's (u, v), then one (R, 9) gather and the blend in
            # rtc_tpu's order
            t, idx, uv = KernelClosestUv.apply(
                lambda *x: mi.closest_hit_blocked(*x, *streamed, want_uv=True),
                eps, o, d, *tabs)
            n = mi.corner_blend(uv[:, 0], uv[:, 1],
                                snc.index_select(0, idx.clamp_min(0).long()))
            n = torch.where((idx >= 0)[:, None], n, 0.0)
        else:
            t, idx, n = KernelClosestSn.apply(
                lambda *x: mi.mesh_closest_hit_sn(*x, *args), eps, o, d, *tabs, snc)
        n = normalize(n)
    elif p.impl == "kernel" and p.blocks > 1:
        t, idx, n = KernelClosestN.apply(
            lambda o, d, p1, e1, e2, n: mi.closest_hit_blocked(
                o, d, p1, e1, e2, *streamed, tri_n=n),
            eps, o, d, *tabs, scene.tri_n)
    elif p.impl == "kernel":
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
    p = plan(scene, cfg, o.device, o.dtype)
    i32 = dict(dtype=torch.int32, device=o.device)
    t_p = torch.full((R,), BIG, dtype=o.dtype, device=o.device)
    idx_p = torch.zeros((R,), **i32)
    if st.n_prims:
        if p.prims:
            t_p, idx_p = KernelPrimClosest.apply(cfg.epsilon, o, d, *prim_tables(scene))
        else:
            t_p, idx_p = mi.prim_closest_plain(o, d, *prim_tables(scene), cfg.epsilon)
    t_t = torch.full((R,), BIG, dtype=o.dtype, device=o.device)
    idx_t = torch.zeros((R,), **i32)
    tri_obj = torch.zeros((R,), **i32)
    tri_n = torch.zeros_like(o)
    if st.n_tris and p.tlas:
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


def shade_prims(scene: Scene):
    """The prims' rows a normal reads (shading.Prims), or None without
    analytic prims."""
    if not scene.static.n_prims:
        return None
    return shading.Prims(scene.prim_inv, scene.prim_invT, scene.prim_kind,
                         scene.prim_params)


def shade_objects(scene: Scene):
    """The objects' rows a node's shading reads (shading.Objects)."""
    return shading.Objects(*(getattr(scene, f) for f in shading.OBJECT_FIELDS))


def normal_at(scene: Scene, hit: HitInfo, world_point, eps):
    """World-space unit normal at the hit (shading.hit_normal; reference:
    src/shape.rs:466-519). world_point: its (R,) components."""
    return shading.hit_normal(shade_prims(scene), hit, world_point, eps)


def shadow_query(scene: Scene, point, live=None):
    """is_shadowed's query from each point toward the light: (unit
    direction (R, 3), distance (R,)), the distance -1 on dead lanes (live
    False), which never report a hit."""
    return shading.shadow_query(point, scene.light_pos, live)


@torch.no_grad()
def is_shadowed(scene: Scene, point, cfg: RenderConfig, live=None):
    """Shadow ray toward the light (reference: src/world.rs:100-114), from
    each point (R, 3): occluded on its shadow_query. live: optional (R,)
    bool; dead lanes get max_t = -1 and report unshadowed."""
    return occluded(scene, point, *shadow_query(scene, point, live), cfg)


@torch.no_grad()
def occluded(scene: Scene, point, direction, distance, cfg: RenderConfig):
    """Is each shadow query (origin point (R, 3), unit direction (R, 3),
    distance (R,), -1 on a dead lane) blocked? `hit().t < distance` is
    "any candidate t in [0, distance)": the prims' sweep (the prim kernel
    where plan says so, else its plain version) OR the any-hit kernel on
    the triangles (K6 on an instanced scene's tables, K2 otherwise,
    streamed over a table above the VMEM budget; K7b on 'elementwise';
    the plain sweep of the world table on 'bruteforce'); under the prim
    axis, of this rank's shard, ORed over the prims group (rtc_tpu
    :916-920). Not differentiable (rtc_tpu stops its gradients, :892), so
    no graph is kept."""
    st = scene.static
    p = plan(scene, cfg, point.device, point.dtype)
    shadowed = torch.zeros(point.shape[:1], dtype=torch.bool, device=point.device)
    if st.n_prims:
        sweep = mi.prim_any if p.prims else mi.prim_any_plain
        shadowed = sweep(point.contiguous(), direction, distance,
                         *prim_tables(scene), cfg.epsilon)
    if st.n_tris:
        tabs = (scene.tri_p1, scene.tri_e1, scene.tri_e2)
        if p.tlas:
            tl = scene.tlas
            found = mi.mesh_any_hit_tlas(point, direction, distance, tl.p1,
                                         tl.e1, tl.e2, tl.caabb, tl.inst_ab,
                                         tl.inst_aabb, tl.inst_mesh,
                                         st.cluster_size, st.tlas_cm,
                                         cfg.epsilon, occ=scene.tlas_occ)
        elif p.impl == "kernel" and p.blocks > 1:
            found = mi.any_hit_blocked(point, direction, distance, *tabs,
                                       scene.cluster_aabb, p.blocks,
                                       st.cluster_size, cfg.epsilon, occ=scene.occ)
        elif p.impl == "kernel":
            found = mi.mesh_any_hit(point, direction, distance, *tabs,
                                    scene.cluster_aabb,
                                    st.cluster_size, cfg.epsilon, occ=scene.occ)
        elif p.impl == "elementwise":
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
    p = plan(scene, cfg, o.device, o.dtype)
    if p.blocks > 1:
        cnt, last = mi.crossing_count_blocked(
            o, d, t_hit.contiguous(), hit_gid.contiguous(), *tabs,
            scene.cluster_aabb, scene.tri_cid, K, p.blocks, st.cluster_size,
            cfg.epsilon, occ=scene.occ)
    elif p.impl != "bruteforce":
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

    Spans: rtc.census over the census, rtc.census.prims over the prims'
    sweep and rtc.census.mesh over the mesh containers' count; they fire
    where the Python runs (an eager call, a capture), not in a replay.
    """
    st = scene.static
    ids, mesh_ids = st.refr_prim_ids, st.refr_mesh_obj_ids
    R = o.shape[0]
    one = torch.ones((R,), dtype=o.dtype, device=o.device)
    if n2_enter is None:
        n2_enter = scene.mat_ior[hit.obj.long()] if st.n_objects else one
    if not ids and not mesh_ids:
        return one, n2_enter

    with span("rtc.census"):
        cnts, lasts, objs = [], [], []
        if ids:
            with span("rtc.census.prims"):
                t, v = prim_candidates(scene, o, d, cfg.epsilon, ids=ids)  # (R, Ka, 4)
                before = v & (t < hit.t[:, None, None])
                cnts.append(before.sum(2, dtype=torch.int32))
                lasts.append(torch.where(before, t, -BIG).amax(2))
                objs.extend(ids)  # prim id == object id
        if mesh_ids:
            with span("rtc.census.mesh"):
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
    """The shading frame of a wavefront of hits (shading.surface_frame)
    with the n1/n2 census (refraction_indices). Misses carry finite
    dummies; callers mask on hit.valid. need_refraction=False skips the
    census (leaf nodes never read it); refraction_live masks it per ray."""
    fr = shading.surface_frame(o, d, hit, shade_prims(scene), cfg.epsilon)
    if need_refraction:
        n1, n2 = refraction_indices(scene, o, d, hit, cfg, n2_enter=n2_enter,
                                    live=refraction_live)
    else:
        n1 = n2 = torch.ones(o.shape[:1], dtype=o.dtype, device=o.device)
    return Comps3(*fr, n1=n1, n2=n2)


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


schlick = shading.schlick  # Fresnel (reference: src/intersection.rs:107-128)


def shade_route(p: Plan, scene: Scene, o, d, hit: HitInfo) -> str:
    """The path a node shades by, its SHADE_NODES key. Where p.shade:
    'kernel', the shading kernels, where autograd has nothing to record
    (grad mode off, or none of the inputs the node reads requires grad:
    its rays, its hits' t and normals, the scene's fields of shade_prims,
    shade_objects and the light, and mat_ior, which reaches the node
    through the census's n1/n2); 'grad', the shading kernels under
    autograd (KernelShadeNode, KernelShadeBlend), where of those inputs
    only the objects' colours (mat_color) and the light's intensity
    require grad and the rays are float32. Else 'plain', the plain
    versions, which autograd differentiates."""
    if not p.shade:
        return "plain"
    if not torch.is_grad_enabled():
        return "kernel"
    fixed = [o, d, hit.t, hit.tri_n, scene.mat_ior, scene.light_pos,
             *(x for k, x in zip(shading.Objects._fields, shade_objects(scene))
               if k != "color"), *(shade_prims(scene) or ())]
    if any(x.requires_grad for x in fixed):
        return "plain"
    if not (scene.mat_color.requires_grad or scene.light_intensity.requires_grad):
        return "kernel"
    return "grad" if o.dtype == torch.float32 else "plain"


# --- a node's shading under autograd (shade_route's 'grad') ----------------
#
# Where only the objects' colours and the light's intensity require grad, a
# node shades by the kernels all the same: its colour is bilinear in the
# object's colour row and the intensity, and nothing else it reads moves
# with them (the blend's weights, the children's rays). The node stage's
# float32 instance that writes its factors (mi.shade_node(factors=True))
# saves four floats a ray; the backward makes each ray's partials in one
# launch (mi.shade_node_grad, mi.shade_blend_grad) and sums them by object
# with the object rows' sum (mi.object_rows_sum), without atomics, so a
# step's gradients are the same bits from run to run. On the CPU the
# wrappers run their plain versions.

class KernelShadeNode(torch.autograd.Function):
    """A node's colour under autograd: color and factors, the node stage's
    (mi.shade_node(factors=True)) on the objects' colour table and the
    light's intensity detached, as a function of those two. backward: the
    colour table's gradient, each ray's partial summed into its object's
    row, and the intensity's, summed over every ray."""

    @staticmethod
    def forward(ctx, color, factors, obj, mat_color, intensity):
        ctx.rows = mat_color.shape[0]
        ctx.save_for_backward(obj.to(torch.int32), factors, intensity)
        return color

    @staticmethod
    def backward(ctx, g):
        obj, factors, intensity = ctx.saved_tensors
        want_c, want_l = ctx.needs_input_grad[3:]
        parts = mi.shade_node_grad(g.contiguous(), factors, intensity.detach(), want_c,
                                   want_l)
        sums = iter(mi.object_rows_sum(obj, [x for x in parts if x is not None], ctx.rows))
        return (None, None, None, next(sums) if want_c else None,
                next(sums).sum(0) if want_l else None)


class KernelShadeBlend(torch.autograd.Function):
    """The blend stage under autograd (mi.shade_blend): gradients to the
    surface colour and the children's colours, from the node's valid and
    weights (the kernel's (R, 4), or the plain version's tuple)."""

    @staticmethod
    def forward(ctx, blend, valid, surface, refl, refr, weights):
        ctx.blend, ctx.stacked = blend, torch.is_tensor(weights)
        ctx.save_for_backward(valid, *((weights,) if ctx.stacked else weights))
        return mi.shade_blend(valid, *(None if x is None else x.detach()
                                       for x in (surface, refl, refr)), weights, blend)

    @staticmethod
    def backward(ctx, g):
        valid, *weights = ctx.saved_tensors
        grads = mi.shade_blend_grad(g.contiguous(), valid,
                                    weights[0] if ctx.stacked else tuple(weights),
                                    *ctx.needs_input_grad[2:5], ctx.blend)
        return (None, None, *grads, None)


def autograd_node(scene: Scene, o, d, hit: HitInfo, shadowed, n1, n2, eps,
                  flags: dict) -> shading.Node:
    """mi.shade_node's Node, its colour differentiable in scene.mat_color
    and scene.light_intensity through KernelShadeNode."""
    objects = shade_objects(scene)._replace(color=scene.mat_color.detach())
    node = mi.shade_node(o, d, hit, shadowed, n1, n2, shade_prims(scene), objects,
                         scene.light_pos, scene.light_intensity.detach(), eps, **flags,
                         factors=True)
    return node._replace(color=KernelShadeNode.apply(
        node.color, node.factors, hit.obj, scene.mat_color, scene.light_intensity))


def color_at(scene: Scene, o, d, cfg: RenderConfig, budget: int | None = None):
    """Whole-wavefront color (reference: src/world.rs:80-98). o/d: (R, 3).

    A node shades its hits in three stages around the searches (the
    shading kernels where shade_route says so, under autograd through
    KernelShadeNode and KernelShadeBlend, else their plain versions,
    ops/shading.py): the surface's shadow query, then after the shadow
    flag and the n1/n2 census the surface colour and the children's parked
    rays, then after the children the blend. Counted in SHADE_NODES by the
    path taken."""
    if budget is None:
        budget = cfg.max_depth
    st = scene.static
    _prim_axis(cfg)  # a prim axis outside a sharded call raises
    if budget < 1 or st.n_objects == 0:
        return torch.zeros_like(o)

    p = plan(scene, cfg, o.device, o.dtype)
    eps = cfg.epsilon
    shadowed = None
    if p.fused:
        # one K3 launch: closest hit + the in-register shadow query
        tabs = (scene.tri_p1, scene.tri_e1, scene.tri_e2)
        fn, kernel, payload = (
            (KernelClosestShadowSn, mi.mesh_closest_shadow_sn, corner_normals(scene))
            if st.any_smooth else
            (KernelClosestShadow, mi.mesh_closest_shadow, scene.tri_n))
        t, idx, n, shadowed = fn.apply(
            lambda *x: kernel(*x, scene.cluster_aabb, scene.light_pos,
                              st.cluster_size, eps, occ=scene.occ),
            eps, o, d, *tabs, payload)
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
    route = shade_route(p, scene, o, d, hit)
    SHADE_NODES[route] += 1
    kernel = route != "plain"
    prims = shade_prims(scene)
    light = (scene.light_pos, scene.light_intensity)
    if kernel:
        rec = fr = None
    else:
        rec = object_record(scene, hit.obj)
        fr = shading.surface_frame(o, d, hit, prims, eps)

    if shadowed is None and cfg.shadows:
        query = (mi.shade_surface(o, d, hit, prims, scene.light_pos, eps) if kernel else
                 shading.surface(o, d, hit, prims, scene.light_pos, eps, frame=fr))
        shadowed = occluded(scene, *query, cfg)

    # n1/n2 are read only by the Snell child and the Schlick blend, which
    # exist only when this node can branch and the hit is transparent
    # (src/world.rs:71-77,132-134)
    can_branch = budget >= 4  # children shade only if budget - 3 >= 1
    branch_r = can_branch and st.any_reflective  # (src/intersection.rs:27, world.rs:125)
    branch_t = can_branch and st.any_refractive
    blend = st.any_reflective and st.any_refractive
    n1 = n2 = None
    if branch_t:
        if kernel:
            ior = scene.mat_ior.index_select(0, hit.obj.long())
            transparency = scene.mat_transparency.index_select(0, hit.obj.long())
        else:
            ior, transparency = rec["ior"], rec["transparency"]
        n1, n2 = refraction_indices(scene, o, d, hit, cfg, n2_enter=ior,
                                    live=valid & (transparency > 0.0))

    flags = dict(branch_r=branch_r, branch_t=branch_t, blend=blend, pattern=st.any_pattern)
    if route == "grad":
        node = autograd_node(scene, o, d, hit, shadowed, n1, n2, eps, flags)
    elif kernel:
        node = mi.shade_node(o, d, hit, shadowed, n1, n2, prims, shade_objects(scene),
                             *light, eps, **flags)
    else:
        node = shading.node(o, d, hit, shadowed, n1, n2, prims, rec, *light, eps,
                            **flags, frame=fr)
    if node.refl is None and node.refr is None:
        return node.color
    refl, refr = (None if rays is None else color_at(scene, *rays, cfg, budget - 3)
                  for rays in (node.refl, node.refr))
    if route == "grad":
        return KernelShadeBlend.apply(blend, valid, node.color, refl, refr, node.weights)
    return (mi.shade_blend if kernel else shading.blend_colors)(
        valid, node.color, refl, refr, node.weights, blend)
