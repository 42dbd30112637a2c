#!/usr/bin/env python3
"""Builds of the CUDA kernels timed in turns on one GPU, on the same
wavefronts, with their outputs held equal bit for bit; and, with --count,
the occlusion walks' tests counted per ray by the counting build.

Run from the repository root:

    python3 kernel_ab.py [--parent DIR] [--variant DIR ...] [--only REGEX] [--out FILE]
    python3 kernel_ab.py --count [--out FILE]

Builds, compiled at once, each from rtc_tpu_torch/csrc/mesh_intersect.cu:

  parent  the source of another checkout, DIR (a `git archive` of the
          commit to compare with, unpacked into a git-ignored directory
          such as build/parent); only with --parent
  change  this checkout's source as it stands
  DIR     with --variant, another checkout (or a copy of the two files
          below with a constant edited), named by its directory

Each build is launched through its own checkout's wrappers
(rtc_tpu_torch/ops/kernels/mesh_intersect.py, loaded from DIR for the
parent), so two commits whose kernels take different tables compare as
they are. To sweep a constant of the kernels (such as the ordered walk's
list lengths kListK1 and kListK5), copy this checkout's
rtc_tpu_torch/ops/kernels/mesh_intersect.py and the source into
DIR/rtc_tpu_torch/{ops/kernels,csrc}/, edit the copy and pass DIR as
--parent.

The cases are the wavefronts of chip_smoke.py: 460,800 primary rays
(every 4th ray of 1920x960, block-major) of cow (K1 flat, K3 flat, and K2
on K3's shadow rays and on the free-space occlusion rays), teapot_smooth
(K1 and K3 with_sn), glass_teapot (K1 with_sn, K2 on its surface shadow
rays, K4 on the main path's census input and on the rays re-seated past
their hits), the 90-cow one-mesh herd (K1 t0 streamed in 11 blocks, K1
uv streamed, one K1 launch over all 4,088 clusters, and K2 streamed on
its surface shadow rays), cow_herd (K5 flat, K6 on its 921,600
free-space occlusion rays and on the 460,800 shadow rays the frame casts
from its surfaces) and cow_herd_smooth (K5 with_sn); K7a on the primary
rays and K7b on the free-space occlusion rays of cow and of cow_herd's
world table (4,088 clusters, 511 supers);
the 10,240 rays of chip_smoke.py's 208-cluster soup (K1 flat); and each
call of the shading stages (shade_surface, shade_node, shade_blend) in an
eager 1920x960 glass_teapot frame and a table frame (chip_smoke.py
shade_calls, 1,843,200 rays a call), in the builds that have them, each
line with the stage's plain version's time ("plain_ms", its outputs
bit-equal to the first build's) and its bound ("bound_ms": the bytes it
reads and writes, chip_smoke.py shade_bytes, once at 3.35 TB/s); and
each call of the shading backward (shade_node_grad, shade_blend_grad) in
the eager gradient of a 1920x960 glass_teapot fit (chip_smoke.py
shade_grad_calls: its parameters mat_color and light_intensity, the
view's rays in 16x16 blocks), likewise with its plain version's time and
its bound (its inputs read once, its partials written once,
shade_grad_bytes). Each case runs the builds in the order
first..last, last..first, each timed with CUDA events around repeated
calls after a warm-up, so every build sees the same card state; every
build's outputs must equal the first build's bit for bit (t, idx or enc,
object id, payload, shadow flags, counts).

Prints, per build, the ptxas registers of its walking kernels and, for
builds that report them, the ordered walk's list lengths and each walking
kernel's registers, local and shared bytes and occupancy; then one JSON
line per case, with each build's two times, the mean of them, the time
with the host's dispatch hidden (chip_smoke.py device_ms, null for a
streamed call), and a digest of its outputs; writes the whole record to --out (default
build/kernel_ab.json). Exits non-zero if any output differs.

--count builds the counting library (-DRTC_COUNT) and counts, per ray, the
box tests and boxes entered at each level and the pair tests by the stage
where they stop, of the old walk (the table-order loop, which the
counting build alone still exports as K2's old loop: on cow's K3 shadow
rays; block by block, as the old streamed K2 ran it, on the one-mesh
herd's surface shadow rays; for K6, over each instance in table order,
as the old K6 ran it) and of the new (K2's and K3's phase 3's occlusion
walk, K6) on cow's two wavefronts (K3's shadow rays, the free-space
occlusion rays), the one-mesh herd's and cow_herd's two;
of K4's census walk on glass_teapot's two census inputs (its old
loop is not kept: the table-order census's tests are modelled only);
and of K7a's and K7b's tile walk (which also tallies the lanes that hold
a row in its 32-row rounds and the share of its warps' ray slots that
hold a listed ray; their old one-ray-a-lane loops are not kept), on
their wavefronts of cow and cow_herd: per
walk the mean and 99th percentile a ray, and a warp's max lane over its
mean lane (the sum over warps of the most a lane of the warp does, over
the sum of what its lanes do), beside the tests chip_smoke.py's bounds
count. The counted flags and counts must equal the production build's.
Writes build/kernel_ab_count.json by default. Needs one CUDA device.
"""

from __future__ import annotations

import argparse
import functools
import hashlib
import importlib.util
import inspect
import json
import os
import re
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

import chip_smoke as cs
from rtc_tpu_torch.ops.kernels import mesh_intersect as mi
from rtc_tpu_torch.render import integrator
from rtc_tpu_torch.utils.config import RenderConfig
from rtc_tpu_torch.utils.constants import BIG, VMEM_TRI_BUDGET

ROOT = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join("rtc_tpu_torch", "csrc", "mesh_intersect.cu")
# the walking kernels' names in nvcc's ptxas report
PTXAS_KERNELS = ("closest_hit_kernel", "closest_shadow_kernel", "closest_hit_tlas_kernel",
                 "any_hit_tlas_kernel", "elementwise_kernel")
WARP = 32


def wrappers(root: str, name: str):
    """The kernels module (rtc_tpu_torch/ops/kernels/mesh_intersect.py) of
    the checkout at root: this one's, or another loaded under a name of its
    own, its relative imports resolved in this checkout's package, its
    source and build directory its own."""
    if os.path.realpath(root) == ROOT:
        return mi
    path = os.path.join(root, "rtc_tpu_torch", "ops", "kernels", "mesh_intersect.py")
    spec = importlib.util.spec_from_file_location(
        f"rtc_tpu_torch.ops.kernels.mesh_intersect_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def builds(parent: str | None, variants=()) -> dict:
    """{name: wrappers module} in the order the cases run them: the parent,
    this checkout ("change"), then each variant, named by its directory."""
    out = {}
    if parent:
        out["parent"] = wrappers(parent, "parent")
    out["change"] = mi
    for root in variants:
        name = os.path.basename(os.path.normpath(root))
        out[name] = wrappers(root, name)
    return out


def ptxas_registers(lib_path: str) -> dict:
    """{mangled kernel: registers} of the walking kernels, from the build's
    ptxas log."""
    regs, name = {}, None
    with open(lib_path + ".log") as f:
        for line in f:
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                name = m.group(1)
            m = re.search(r"Used (\d+) registers", line)
            if m and name and any(k in name for k in PTXAS_KERNELS):
                regs[name] = int(m.group(1))
    return regs


def bits(outputs) -> list:
    """The outputs as raw bytes (so -0.0 and NaN compare by their bits)."""
    return [x.contiguous().view(torch.uint8) for x in outputs]


def digest(outputs) -> str:
    h = hashlib.sha1()
    for x in bits(outputs):
        h.update(x.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=None)
def takes_occ(m, fn: str) -> bool:
    return "occ" in inspect.signature(getattr(m, fn)).parameters


def occ_kw(m, fn: str, occ) -> dict:
    """The occlusion tables, for a build whose wrapper takes them. Builds
    from before the occlusion walk take none; once no build compared is
    that old, pass occ=... in the cases and delete this."""
    return {"occ": occ} if takes_occ(m, fn) else {}


def shade_cases(scenes=("glass_teapot", "table")) -> list:
    """chip_smoke.py's shading calls of each scene's frame as cases, each
    with its plain version and its bound: [(name, rays, call, iters,
    extra)]."""
    out = []
    calls = [(name, i, *c) for name in scenes for i, c in enumerate(cs.shade_calls(name))]
    for name, i, stage, a, kw, got in calls:
        rays = (a[1] if stage == "shade_blend" else a[0]).shape[0]
        bound_ms = cs.bound(cs.Work(), cs.shade_bytes(stage, a, got))[0]
        out.append((f"shading {stage}, {name}'s call {i}", rays,
                    lambda m, stage=stage, a=a, kw=kw: tuple(
                        cs.shade_outputs(stage, getattr(m, stage)(*a, **kw))), 10,
                    {"needs": stage, "bound_ms": bound_ms,
                     "plain": lambda stage=stage, a=a, kw=kw: cs.SHADE_PLAIN[stage](*a, **kw),
                     "plain_equal": lambda stage=stage, a=a, kw=kw: cs.shade_equal(
                         stage, getattr(mi, stage)(*a, **kw), cs.SHADE_PLAIN[stage](*a, **kw))}))
    return out


def shade_grad_cases(name: str = "glass_teapot") -> list:
    """chip_smoke.py's calls of the shading backward in a fit's gradient
    (shade_grad_calls) as cases, each with its plain version and its
    bound: [(name, rays, call, iters, extra)]."""
    out = []
    calls = [c for c in cs.shade_grad_calls(name) if c[0] != "shade_node"]
    for i, (stage, a, kw, got) in enumerate(calls):
        bound_ms = cs.bound(cs.Work(), cs.shade_grad_bytes(a, got))[0]
        run = lambda m, stage=stage, a=a, kw=kw: tuple(
            x for x in getattr(m, stage)(*a, **kw) if x is not None)
        plain = lambda stage=stage, a=a, kw=kw: cs.SHADE_GRAD_PLAIN[stage](*a, **kw)
        out.append((f"shading backward {stage}, {name}'s fit call {i}", a[0].shape[0], run,
                    10, {"needs": stage, "bound_ms": bound_ms, "plain": plain,
                         "plain_equal": lambda run=run, plain=plain: all(
                             torch.equal(x, y) for x, y in
                             zip(bits(run(mi)), bits(z for z in plain() if z is not None)))}))
    return out


def cases(eps: float) -> list:
    """[(name, rays, call, iters[, extra])]: call(m) launches the kernel
    through the wrappers module m and returns its outputs; extra, where
    given: the wrapper a build needs to run the case ("needs"), the plain
    version ("plain"), whether this checkout's kernel equals it bit for bit
    ("plain_equal") and the bound ("bound_ms")."""
    out = []
    scene, cam = cs.slice_scene("cow", cs.WIDTH)
    o, d = cs.main_path_rays(cam)
    tabs, aabb, leaf = cs.tables(scene), scene.cluster_aabb, scene.static.cluster_size
    args = (o, d, *tabs, scene.tri_n, aabb)
    out.append(("K1 flat, cow", o.shape[0],
                lambda m: m.mesh_closest_hit(*args, leaf, eps), 10))
    out.append(("K3 flat, cow", o.shape[0],
                lambda m: m.mesh_closest_shadow(*args, scene.light_pos, leaf, eps,
                                                **occ_kw(m, "mesh_closest_shadow",
                                                         scene.occ)), 10))
    so, sd, smax = cs.k3_shadow_rays(scene, o, d, eps)
    out.append(("K2, cow's surface shadow rays (K3's phase 3 input)", so.shape[0],
                k2_case(scene, so, sd, smax, eps), 10))
    t, idx = mi.mesh_closest_hit(*args, leaf, eps)[:2]
    fo, fd, fmax = cs.occlusion_rays(scene, o, d, t, idx)
    out.append(("K2, cow's free-space occlusion rays", fo.shape[0],
                k2_case(scene, fo, fd, fmax, eps), 10))
    sup = scene.super_aabb
    out.append(("K7a, cow", o.shape[0], lambda m: m.mesh_closest_hit_elementwise(
        o, d, *tabs, aabb, sup, leaf, eps), 5))
    out.append(("K7b, cow's free-space occlusion rays", fo.shape[0],
                lambda m: m.mesh_any_hit_elementwise(fo, fd, fmax, *tabs, aabb, sup,
                                                     leaf, eps), 5))
    out += k7_herd_cases(eps)

    soup, so_, sd_ = cs.soup_scene(np.random.default_rng(0))
    out.append((f"K1 flat, soup ({soup.static.n_clusters} clusters)", so_.shape[0],
                lambda m: m.mesh_closest_hit(so_, sd_, *cs.tables(soup), soup.tri_n,
                                             soup.cluster_aabb, soup.static.cluster_size,
                                             eps), 10))

    for name in ("teapot_smooth", "glass_teapot"):
        sc, cam = cs.slice_scene(name, cs.WIDTH)
        oo, dd = cs.main_path_rays(cam)
        a = (oo, dd, *cs.tables(sc), integrator.corner_normals(sc), sc.cluster_aabb)
        lf = sc.static.cluster_size
        out.append((f"K1 with_sn, {name}", oo.shape[0],
                    lambda m, a=a, lf=lf: m.mesh_closest_hit_sn(*a, lf, eps), 10))
        if name == "teapot_smooth":
            out.append((f"K3 with_sn, {name}", oo.shape[0],
                        lambda m, a=a, lf=lf, sc=sc: m.mesh_closest_shadow_sn(
                            *a, sc.light_pos, lf, eps,
                            **occ_kw(m, "mesh_closest_shadow_sn", sc.occ)), 10))
        else:
            for key, (co, t, g) in census_inputs(sc, oo, dd).items():
                out.append((f"K4, glass_teapot's census ({key})", oo.shape[0],
                            census_call(sc, co, dd, t, g, eps), 10))
            qo, qd, qmax = cs.surface_shadow_rays(sc, oo, dd)
            out.append(("K2, glass_teapot's surface shadow rays", qo.shape[0],
                        k2_case(sc, qo, qd, qmax, eps), 10))

    sc, cam = cs.slice_scene("cow_herd_mesh", cs.WIDTH)
    oo, dd = cs.main_path_rays(cam)
    tb, ab, lf = cs.tables(sc), sc.cluster_aabb, sc.static.cluster_size
    nb = mi._blocked(sc.tri_p1, lf, VMEM_TRI_BUDGET)
    out.append((f"K1 with_t0 streamed ({nb} launches), one-mesh herd", oo.shape[0],
                lambda m: m.closest_hit_blocked(oo, dd, *tb, ab, nb, lf, eps,
                                                tri_n=sc.tri_n), 3))
    out.append((f"K1 with_uv streamed ({nb} launches), one-mesh herd", oo.shape[0],
                lambda m: m.closest_hit_blocked(oo, dd, *tb, ab, nb, lf, eps,
                                                want_uv=True), 3))
    out.append((f"K1 flat, one launch over the one-mesh herd's {sc.static.n_clusters} "
                "clusters", oo.shape[0],
                lambda m: m.mesh_closest_hit(oo, dd, *tb, sc.tri_n, ab, lf, eps), 3))
    qo, qd, qmax = cs.surface_shadow_rays(sc, oo, dd)
    out.append((f"K2 streamed ({nb} launches), the one-mesh herd's surface shadow rays",
                qo.shape[0], k2_case(sc, qo, qd, qmax, eps), 5))

    for name in ("cow_herd", "cow_herd_smooth"):
        sc, cam = cs.slice_scene(name, cs.WIDTH)
        st, tl = sc.static, sc.tlas
        oo, dd = cs.main_path_rays(cam)
        fn = "mesh_closest_hit_tlas_sn" if st.tlas_sn else "mesh_closest_hit_tlas"
        k5 = (oo, dd, tl.p1, tl.e1, tl.e2, tl.sn if st.tlas_sn else tl.n, tl.caabb,
              tl.inst_ab, tl.inst_aabb, tl.inst_mesh, tl.inst_obj, st.cluster_size,
              st.tlas_cm, eps)
        out.append((f"K5 {'with_sn' if st.tlas_sn else 'flat'}, {name}", oo.shape[0],
                    lambda m, fn=fn, k5=k5: getattr(m, fn)(*k5), 10))
        if st.tlas_sn:
            continue
        for wave, (qo, qd, qmax) in herd_wavefronts(sc, oo, dd).items():
            k6 = (qo, qd, qmax, tl.p1, tl.e1, tl.e2, tl.caabb, tl.inst_ab, tl.inst_aabb,
                  tl.inst_mesh, st.cluster_size, st.tlas_cm, eps)
            out.append((f"K6, {name}'s {wave} rays", qo.shape[0],
                        lambda m, k6=k6, sc=sc: m.mesh_any_hit_tlas(
                            *k6, **occ_kw(m, "mesh_any_hit_tlas", sc.tlas_occ)), 10))
    return out + shade_cases() + shade_grad_cases()


def k7_wavefronts(name: str, eps):
    """K7's two wavefronts on a scene's world table (chip_smoke.py phase
    10): the 460,800 primary rays, and the free-space occlusion rays of
    their hits. Returns (scene, (o, d), (fo, fd, fmax))."""
    scene, cam = cs.slice_scene(name, cs.WIDTH)
    o, d = cs.main_path_rays(cam)
    t, idx = mi.mesh_closest_hit_elementwise(o, d, *cs.tables(scene), scene.cluster_aabb,
                                             scene.super_aabb, scene.static.cluster_size,
                                             eps)
    return scene, (o, d), cs.occlusion_rays(scene, o, d, t, idx)


def k7_herd_cases(eps) -> list:
    """K7a and K7b on cow_herd's world table (4,088 clusters, 511 supers)."""
    scene, (o, d), (fo, fd, fmax) = k7_wavefronts("cow_herd", eps)
    st = scene.static
    args = (*cs.tables(scene), scene.cluster_aabb, scene.super_aabb, st.cluster_size, eps)
    where = f"cow_herd's world table ({st.n_clusters} clusters, {st.n_super} supers)"
    return [(f"K7a, {where}", o.shape[0],
             lambda m: m.mesh_closest_hit_elementwise(o, d, *args), 3),
            (f"K7b, {where}, free-space occlusion rays", fo.shape[0],
             lambda m: m.mesh_any_hit_elementwise(fo, fd, fmax, *args), 3)]


def k2_case(scene, o, d, max_t, eps):
    """K2 on one wavefront over a world table: one launch, or streamed
    (any_hit_blocked) where the table exceeds the budget."""
    tabs, leaf = cs.tables(scene), scene.static.cluster_size
    n_blocks = mi._blocked(scene.tri_p1, leaf, VMEM_TRI_BUDGET)
    if n_blocks > 1:
        return lambda m: m.any_hit_blocked(o, d, max_t, *tabs, scene.cluster_aabb, n_blocks,
                                           leaf, eps, **occ_kw(m, "any_hit_blocked",
                                                               scene.occ))
    return lambda m: m.mesh_any_hit(o, d, max_t, *tabs, scene.cluster_aabb, leaf, eps,
                                    **occ_kw(m, "mesh_any_hit", scene.occ))


def census_inputs(scene, o, d) -> dict:
    """glass_teapot's two census inputs (chip_smoke.py phase 7): {name: (o,
    t_hit, hit_gid)}, the main path's (t_hit of the transparent hits) and
    the rays re-seated 1e-3 past their hits (t_hit = BIG)."""
    hit = integrator.closest_hit(scene, o, d, RenderConfig())
    live = hit.valid & (integrator.object_record(scene, hit.obj)["transparency"] > 0.0)
    g_main = torch.where(hit.is_tri, hit.tri, -2).to(torch.int32).contiguous()
    o2 = (o + d * (torch.where(hit.valid, hit.t, 0.0)[:, None] + 1e-3)).contiguous()
    return {"main path": (o, torch.where(live, hit.t, -BIG).contiguous(), g_main),
            "re-seated": (o2, torch.full_like(hit.t, BIG), torch.full_like(g_main, -2))}


def census_call(scene, o, d, t_hit, hit_gid, eps):
    """call(m): K4 on one of glass_teapot's census inputs."""
    K = len(scene.static.refr_mesh_obj_ids)
    tabs, leaf = cs.tables(scene), scene.static.cluster_size
    return lambda m: m.mesh_crossing_count(o, d, t_hit, hit_gid, *tabs, scene.cluster_aabb,
                                           scene.tri_cid, K, leaf, eps,
                                           **occ_kw(m, "mesh_crossing_count", scene.occ))


def herd_wavefronts(scene, o, d) -> dict:
    """cow_herd's two K6 wavefronts from its primary rays: the free-space
    occlusion rays of its hits and the shadow rays its frame casts from
    its surfaces."""
    t, idx = integrator._tlas_closest(scene, o, d, RenderConfig())[:2]
    return {"free-space": cs.occlusion_rays(scene, o, d, t, torch.where(t < BIG, idx, -1)),
            "surface": cs.surface_shadow_rays(scene, o, d)}


# ---------------------------------------------------------------------------
# --count: the occlusion walks' tests, counted per ray
# ---------------------------------------------------------------------------

C = {name: k for k, name in enumerate(mi.COUNTERS)}
BOX_TESTS = [C[k] for k in ("inst_group_tests", "inst_tests", "group_tests",
                            "cluster_tests", "sub_tests", "super_tests")]
PAIRS = [C[k] for k in ("pair_det", "pair_u", "pair_v", "pair_t")]


def stats(x) -> dict:
    """Mean and 99th percentile a ray, and a warp's max lane over its mean
    lane, of per-ray counts x (R,): rays i of warp i // 32, as launched."""
    x = x.double()
    pad = (-x.numel()) % WARP
    w = torch.cat([x, x.new_zeros(pad)]).view(-1, WARP)
    total = float(w.sum())
    return {"mean": float(x.mean()), "p99": float(torch.quantile(x, 0.99)),
            "warp_max_over_mean": float(w.amax(1).sum()) * WARP / total if total else 0.0}


def summary(counts, out) -> dict:
    """The count record of one walk on one wavefront; out: its flags, K4's
    counts, or K7a's t. K7's tile walk adds the share of lanes that held a
    row in its 32-row rounds, the share of its ray slots that held an
    entered ray (a warp a ray: a tile's warps take kTileWarps listed rays a
    round; a lane a ray: 32 slots a warp holding an entered lane), the
    clusters a tile tested, and the share of those it tested a lane a ray."""
    line = {"box_tests": stats(counts[:, BOX_TESTS].sum(1)),
            "pair_tests": stats(counts[:, PAIRS].sum(1)),
            "mean_a_ray": {k: float(counts[:, C[k]].double().mean()) for k in mi.COUNTERS}}
    if out.dtype == torch.bool:
        line["occluded"] = int(out.sum())
    elif out.dtype == torch.float32:
        line["hits"] = int((out < BIG).sum())
    else:
        line["crossings"] = int(out.sum())
    total = counts.double().sum(0)
    if total[C["tile_clusters"]]:
        tiles = -(-counts.shape[0] // mi.ELEMENTWISE_TILE)
        if total[C["rounds"]]:
            line["lanes_busy_a_round"] = float(total[C["round_lanes"]]
                                               / (WARP * total[C["rounds"]]))
        line["listed_share_of_warp_slots"] = float(total[C["clusters_entered"]]
                                                   / total[C["tile_slots"]])
        line["clusters_tested_a_tile"] = float(total[C["tile_clusters"]] / tiles)
        line["clusters_a_lane_a_ray_share"] = float(total[C["tile_by_lane"]]
                                                    / total[C["tile_clusters"]])
    return line


def model(work) -> dict:
    """chip_smoke.py's count of a bound's tests, a ray."""
    return {"box_tests": work.boxes, "pair_tests": int(work.stages.sum())}


def counting_library():
    """The counting build (-DRTC_COUNT) of this checkout's kernels, bound:
    the production build's entry points, whose occlusion loops also tally
    (counted)."""
    return mi.bind(mi.build(extra_flags=mi.COUNT_FLAGS))


def counted(call, n_rays: int, lib):
    """call(), a wrapper call of n_rays rays, launched on the counting
    build lib: (its outputs, per-ray tallies (n_rays, len(mi.COUNTERS))
    i32) of the walks it ran (K2, K3's phase 3, K4, K6, the table-order
    loop). The scratch buffer starts at zero and every launch in call adds
    to it."""
    buf = torch.zeros((n_rays, len(mi.COUNTERS)), dtype=torch.int32, device="cuda")
    production = mi.library
    mi.library = lambda: lib
    try:
        mi._raise_on(lib.rtc_set_count_buffer(buf.data_ptr()), "the count buffer")
        out = call()
        torch.cuda.synchronize()
    finally:
        lib.rtc_set_count_buffer(None)
        mi.library = production
    return out, buf


def table_order(o, d, max_t, p1, e1, e2, aabb, leaf: int, eps):
    """K2's old loop, the table-order loop over a (C * leaf, 3) table and
    its (C, 6) cluster boxes, on the counting build (its
    rtc_count_any_hit_table_order): (R,) bool, as any_hit_plain."""
    R, C = o.shape[0], aabb.shape[0]
    hit = torch.empty((R,), dtype=torch.bool, device=o.device)
    if R:
        mi._raise_on(mi.library().rtc_count_any_hit_table_order(
            o.device.index or 0, mi._stream(o.device), o.data_ptr(), d.data_ptr(),
            max_t.data_ptr(), R, p1.data_ptr(), e1.data_ptr(), e2.data_ptr(),
            aabb.data_ptr(), C, leaf, eps, hit.data_ptr()), "the table-order loop")
    return hit


def old_streamed_k2(o, d, max_t, scene, eps):
    """The old streamed K2 (before the occlusion walk): the table-order loop
    on views of each superblock's rows, in _block_order, with the carried
    found mask (mi.any_hit_blocked's schedule)."""
    leaf, aabb = scene.static.cluster_size, scene.cluster_aabb
    n_blocks = mi._blocked(scene.tri_p1, leaf, VMEM_TRI_BUDGET)
    per_block, blocks = mi._block_tables(aabb.shape[0], n_blocks)
    found = torch.zeros(o.shape[:1], dtype=torch.bool, device=o.device)
    for b in mi._block_order(o, d, aabb, per_block).tolist():
        c0, c1 = blocks[b]
        rows = slice(c0 * leaf, c1 * leaf)
        m = torch.where(found, -1.0, max_t)
        found = found | table_order(o, d, m, *(x[rows] for x in cs.tables(scene)),
                                    aabb[c0:c1], leaf, eps)
    return found


def old_k6(lib, fo, fd, fmax, scene, eps):
    """The old K6's tests, counted: its instances in table order, each
    box-tested (cluster_entry's widening, box_entries) by every live lane
    not yet occluded, and the table-order loop (K2, counting build) over
    the mesh of each instance entered, on the instance-space rays. Returns
    (counts (R, len(COUNTERS)), flags)."""
    st, tl = scene.static, scene.tlas
    leaf, cm, M = st.cluster_size, st.tlas_cm, st.tlas_n_mesh
    tm = cm * leaf
    counts = torch.zeros((fo.shape[0], len(mi.COUNTERS)), dtype=torch.int64, device="cuda")
    done = torch.zeros((fo.shape[0],), dtype=torch.bool, device="cuda")
    for k in range(tl.inst_aabb.shape[0]):
        live = (fmax > 0) & ~done
        counts[:, C["inst_tests"]] += live
        e = mi.box_entries(fo, fd, tl.inst_aabb[k:k + 1])[:, 0]
        m = int(tl.inst_mesh[k])
        if not 0 <= m < M:
            continue
        idx = (live & (e < fmax) & (e < BIG)).nonzero()[:, 0]
        if not idx.numel():
            continue
        counts[idx, C["inst_entered"]] += 1
        oi, di = (x.contiguous() for x in mi.instance_rays(fo[idx], fd[idx], tl.inst_ab[k]))
        rows, clusters = slice(m * tm, (m + 1) * tm), slice(m * cm, (m + 1) * cm)
        hit, c = counted(lambda: table_order(
            oi, di, fmax[idx].contiguous(), tl.p1[rows], tl.e1[rows], tl.e2[rows],
            tl.caabb[clusters], leaf, eps), idx.numel(), lib)
        counts[idx] += c.long()
        done[idx] |= hit
    return counts, done


def count_main(out_path: str) -> int:
    eps = RenderConfig().epsilon
    lib = counting_library()
    k1, k5 = mi.walk_list()
    cs.WALK_L = {"K1": k1, "K5": k5}
    record = {"card": cs.CARD, "counters": list(mi.COUNTERS), "walks": []}
    ok = True

    def report(case, walk, counts, flags, production, work=None, **extra):
        nonlocal ok
        same = all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(flags, production))
        ok &= same
        rays = int(counts.shape[0])
        line = {"card": cs.CARD, "case": case, "walk": walk, "rays": rays,
                "outputs_equal_production": same, **summary(counts, flags[0])}
        if work is not None:
            line["bound_model_a_ray"] = {k: v / rays for k, v in model(work).items()}
        line.update({k: {m: v / rays for m, v in model(w).items()} for k, w in extra.items()})
        record["walks"].append(line)
        print(json.dumps(line), flush=True)

    scene, cam = cs.slice_scene("cow", cs.WIDTH)
    o, d = cs.main_path_rays(cam)
    tabs, aabb, leaf = cs.tables(scene), scene.cluster_aabb, scene.static.cluster_size
    k3 = lambda: mi.mesh_closest_shadow(o, d, *tabs, scene.tri_n, aabb, scene.light_pos,
                                        leaf, eps, occ=scene.occ)
    production = k3()[3]
    so, sd, smax = cs.k3_shadow_rays(scene, o, d, eps)
    case = "cow K3 phase 3 and K2 (460,800 surface shadow rays)"
    flags, counts = counted(lambda: table_order(so, sd, smax, *tabs, aabb, leaf, eps),
                            o.shape[0], lib)
    report(case, "old: table-order loop (K2)", counts, (flags,), (production,),
           cs.any_work(so, sd, tabs, aabb, smax, production, leaf, eps))
    out, counts = counted(k3, o.shape[0], lib)
    report(case, "new: occlusion walk (K3)", counts, (out[3],), (production,),
           cs.occlusion_walk_work(so, sd, scene.occ, leaf, eps, smax, production))
    flags, counts = counted(lambda: mi.mesh_any_hit(so, sd, smax, *tabs, aabb, leaf, eps,
                                                    occ=scene.occ), o.shape[0], lib)
    report(case, "new: occlusion walk (K2)", counts, (flags,), (production,),
           cs.occlusion_walk_work(so, sd, scene.occ, leaf, eps, smax, production))
    t, idx = mi.mesh_closest_hit(o, d, *tabs, scene.tri_n, aabb, leaf, eps)[:2]
    fo, fd, fmax = cs.occlusion_rays(scene, o, d, t, idx)
    production = mi.mesh_any_hit(fo, fd, fmax, *tabs, aabb, leaf, eps, occ=scene.occ)
    case = f"cow K2 ({fo.shape[0]} free-space occlusion rays)"
    for walk, call in (("old: table-order loop", lambda: table_order(
                            fo, fd, fmax, *tabs, aabb, leaf, eps)),
                       ("new: occlusion walk (K2)", lambda: mi.mesh_any_hit(
                            fo, fd, fmax, *tabs, aabb, leaf, eps, occ=scene.occ))):
        flags, counts = counted(call, fo.shape[0], lib)
        report(case, walk, counts, (flags,), (production,))

    herd, cam = cs.slice_scene("cow_herd_mesh", cs.WIDTH)
    o, d = cs.main_path_rays(cam)
    so, sd, smax = cs.surface_shadow_rays(herd, o, d)
    n_blocks = mi._blocked(herd.tri_p1, herd.static.cluster_size, VMEM_TRI_BUDGET)
    k2 = lambda: mi.any_hit_blocked(so, sd, smax, *cs.tables(herd), herd.cluster_aabb,
                                    n_blocks, herd.static.cluster_size, eps, occ=herd.occ)
    production = k2()
    case = f"one-mesh herd K2 streamed ({so.shape[0]} surface shadow rays)"
    flags, counts = counted(lambda: old_streamed_k2(so, sd, smax, herd, eps), so.shape[0],
                            lib)
    report(case, "old: table-order loop, block by block", counts, (flags,), (production,))
    flags, counts = counted(k2, so.shape[0], lib)
    report(case, "new: occlusion walk, block by block (K2)", counts, (flags,),
           (production,))

    glass, cam = cs.slice_scene("glass_teapot", cs.WIDTH)
    o, d = cs.main_path_rays(cam)
    tabs, leaf = cs.tables(glass), glass.static.cluster_size
    for key, (oo, tt, gg) in census_inputs(glass, o, d).items():
        call = census_call(glass, oo, d, tt, gg, eps)
        production = call(mi)
        out, counts = counted(lambda: call(mi), o.shape[0], lib)
        report(f"glass_teapot K4, {key} census input ({o.shape[0]} rays)",
               "new: census walk (K4)", counts, out, production,
               cs.census_walk_work(oo, d, glass.occ, leaf, eps, tt, gg),
               table_order_model_a_ray=cs.census_work(
                   oo, d, tabs, glass.cluster_aabb, tt, gg, glass.tri_cid, leaf, eps))

    herd, cam = cs.slice_scene("cow_herd", cs.WIDTH)
    st, tl = herd.static, herd.tlas
    o, d = cs.main_path_rays(cam)
    for wave, (fo, fd, fmax) in herd_wavefronts(herd, o, d).items():
        k6 = lambda: mi.mesh_any_hit_tlas(fo, fd, fmax, tl.p1, tl.e1, tl.e2, tl.caabb,
                                          tl.inst_ab, tl.inst_aabb, tl.inst_mesh,
                                          st.cluster_size, st.tlas_cm, eps,
                                          occ=herd.tlas_occ)
        production = k6()
        case = f"cow_herd K6 ({fo.shape[0]} {wave} rays)"
        counts, flags = old_k6(lib, fo, fd, fmax, herd, eps)
        live = fmax > 0
        report(case, "old: instances and the table-order loop", counts, (flags,),
               (production,), cs.tlas_work(fo, fd, tl, st, eps, fmax, strict=True,
                                           occluded=production & live)[0])
        flags, counts = counted(k6, fo.shape[0], lib)
        report(case, "new: occlusion walk (K6)", counts, (flags,), (production,),
               cs.tlas_walk_work(fo, fd, tl, st, herd.tlas_occ, eps, fmax, production))
    for name in ("cow", "cow_herd"):
        scene, (o, d), (fo, fd, fmax) = k7_wavefronts(name, eps)
        st = scene.static
        tabs, aabb, leaf = cs.tables(scene), scene.cluster_aabb, st.cluster_size
        args = (*tabs, aabb, scene.super_aabb, leaf, eps)
        where = f"{name}'s world table ({st.n_clusters} clusters)"
        k7a = lambda: mi.mesh_closest_hit_elementwise(o, d, *args)
        production = k7a()
        work = cs.closest_work(o, d, tabs, aabb, production[0], leaf, eps)[0]
        case = f"{name} K7a ({o.shape[0]} primary rays, {where})"
        out, counts = counted(k7a, o.shape[0], lib)
        report(case, "new: tile walk (K7a)", counts, out, production, work)
        k7b = lambda: mi.mesh_any_hit_elementwise(fo, fd, fmax, *args)
        production = k7b()
        work = cs.any_work(fo, fd, tabs, aabb, fmax, production, leaf, eps)
        case = f"{name} K7b ({fo.shape[0]} free-space occlusion rays, {where})"
        out, counts = counted(k7b, fo.shape[0], lib)
        report(case, "new: tile walk (K7b)", counts, (out,), (production,), work)
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(record, f, indent=1)
    print(f"wrote {os.path.relpath(out_path, ROOT)}; counted outputs "
          + ("equal the production build's" if ok else "DIFFER from the production build's"))
    return 0 if ok else 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="a checkout of the commit to compare with")
    ap.add_argument("--variant", action="append", metavar="DIR",
                    help="another checkout to time beside the change (repeatable; "
                    "a copy with an edited kernel constant, as --parent)")
    ap.add_argument("--only", metavar="REGEX",
                    help="time only the cases whose name matches")
    ap.add_argument("--count", action="store_true",
                    help="count the occlusion walks' tests (the counting build)")
    ap.add_argument("--out", help="the record's path (default build/kernel_ab.json, "
                    "or build/kernel_ab_count.json with --count)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    cs.CARD = cs.card()
    if args.count:
        return count_main(args.out or os.path.join(ROOT, "build", "kernel_ab_count.json"))
    eps = RenderConfig().epsilon
    mods = builds(args.parent, args.variant or ())
    with ThreadPoolExecutor(len(mods)) as pool:  # one nvcc per build, all at once
        paths = dict(zip(mods, pool.map(lambda m: m.build(), mods.values())))
    libs = {name: mods[name].bind(path) for name, path in paths.items()}
    for name, lib in libs.items():
        mods[name].library = lambda lib=lib: lib
    record = {"card": cs.CARD, "builds": {}, "cases": []}
    for name, lib in libs.items():
        m = mods[name]
        info = {"source": os.path.relpath(m.SOURCE, ROOT),
                "ptxas_registers": ptxas_registers(paths[name])}
        if hasattr(lib, "rtc_walk_list"):  # a build from before the walk has no report
            info["walk_list"] = m.walk_list(lib)
            info["walk_kernels"] = m.walk_kernel_report(lib)
        record["builds"][name] = info
        print(json.dumps({"card": cs.CARD, "build": name, **info}), flush=True)

    ok = True
    for case, rays, call, iters, *extra in cases(eps):
        if args.only and not re.search(args.only, case):
            continue
        extra = extra[0] if extra else {}
        present = [n for n in libs if hasattr(mods[n], extra.get("needs", "library"))]
        order = present + present[::-1]
        ms = {name: [] for name in present}
        device = {name: [] for name in present}
        outs = {}
        for name in order:
            t, got = cs.timed_ms(lambda: call(mods[name]), 2, iters)
            ms[name].append(t)
            device[name].append(cs.device_ms(lambda: call(mods[name]), iters))
            outs[name] = got if isinstance(got, tuple) else (got,)
        first = present[0]
        equal = {name: all(torch.equal(a, b) for a, b in
                           zip(bits(outs[name]), bits(outs[first])))
                 for name in present}
        with_plain = {}
        if "plain" in extra:
            plain_ms, _ = cs.timed_ms(extra["plain"], 1, 3)
            with_plain = {"plain_ms": plain_ms, "bound_ms": extra["bound_ms"],
                          "bit_equal_to_plain": extra["plain_equal"]()}
            ok &= with_plain["bit_equal_to_plain"]
        ok &= all(equal.values())
        line = {"card": cs.CARD, "case": case, "rays": rays,
                "ms": {n: sum(v) / len(v) for n, v in ms.items()}, "ms_each": ms,
                "device_ms": {n: None if None in v else sum(v) / len(v)
                              for n, v in device.items()},
                "device_ms_each": device,
                "bit_equal_to_" + first: equal, **with_plain,
                "digest": {n: digest(outs[n]) for n in present}}
        record["cases"].append(line)
        print(json.dumps(line), flush=True)
    out = args.out or os.path.join(ROOT, "build", "kernel_ab.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(record, f, indent=1)
    print(f"wrote {os.path.relpath(out, ROOT)}; outputs "
          + ("bit-equal across every build" if ok else "DIFFER between builds"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
