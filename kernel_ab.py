#!/usr/bin/env python3
"""Builds of the CUDA kernels timed in turns on one GPU, on the same
wavefronts, with their outputs held equal bit for bit; and, with --count,
the occlusion walks' tests counted per ray by the counting build.

Run from the repository root:

    python3 kernel_ab.py [--parent DIR] [--out FILE]
    python3 kernel_ab.py --count [--out FILE]

Builds, compiled at once, each from rtc_tpu_torch/csrc/mesh_intersect.cu:

  parent  the source of another checkout, DIR (a `git archive` of the
          commit to compare with, unpacked into a git-ignored directory
          such as build/parent); only with --parent
  change  this checkout's source as it stands

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
(K1 and K3 with_sn), glass_teapot (K1 with_sn, K4 on the main path's
census input), the 90-cow one-mesh herd (K1 t0 streamed in 11 blocks, K1
uv streamed, and one K1 launch over all 4,088 clusters), cow_herd (K5
flat, K6 on its 921,600 free-space occlusion rays and on the 460,800
shadow rays the frame casts from its surfaces) and cow_herd_smooth (K5
with_sn); cow's K7a and K7b; and the 10,240 rays of chip_smoke.py's
208-cluster soup (K1 flat). Each case runs the builds in the order
first..last, last..first, each timed with CUDA events around repeated
calls after a warm-up, so every build sees the same card state; every
build's outputs must equal the first build's bit for bit (t, idx or enc,
object id, payload, shadow flags, counts).

Prints, per build, the ptxas registers of its walking kernels and, for
builds that report them, the ordered walk's list lengths and each walking
kernel's registers, local and shared bytes and occupancy; then one JSON
line per case, with each build's two times, the mean of them, and a digest
of its outputs; writes the whole record to --out (default
build/kernel_ab.json). Exits non-zero if any output differs.

--count builds the counting library (-DRTC_COUNT) and counts, per ray, the
box tests and boxes entered at each level and the pair tests by the stage
where they stop, of the old walk (the table-order loop: K2 on K3's shadow
rays; for K6, K2's loop over each instance in table order, as the old K6
ran it) and of the new (K3's phase 3, K6) on cow's wavefront and on
cow_herd's two: per walk the mean and 99th percentile a ray, and a warp's
max lane over its mean lane (the sum over warps of the most a lane of the
warp does, over the sum of what its lanes do), beside the tests
chip_smoke.py's bounds count. The counted flags must equal the
production build's. Writes build/kernel_ab_count.json by default. Needs
one CUDA device.
"""

from __future__ import annotations

import argparse
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
from rtc_tpu_torch.utils.constants import BIG

ROOT = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join("rtc_tpu_torch", "csrc", "mesh_intersect.cu")
# the walking kernels' names in nvcc's ptxas report
PTXAS_KERNELS = ("closest_hit_kernel", "closest_shadow_kernel", "closest_hit_tlas_kernel",
                 "any_hit_tlas_kernel")
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


def builds(parent: str | None) -> dict:
    """{name: wrappers module} in the order the cases run them."""
    out = {}
    if parent:
        out["parent"] = wrappers(parent, "parent")
    out["change"] = mi
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


def occ_kw(m, fn: str, occ) -> dict:
    """The occlusion tables, for a build whose wrapper takes them. Builds
    from before the occlusion walk take none; once no build compared is
    that old, pass occ=... in the cases and delete this."""
    return {"occ": occ} if "occ" in inspect.signature(getattr(m, fn)).parameters else {}


def cases(eps: float) -> list:
    """[(name, rays, call, iters)]: call(m) launches the kernel through the
    wrappers module m and returns its outputs."""
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
                lambda m: m.mesh_any_hit(so, sd, smax, *tabs, aabb, leaf, eps), 10))
    t, idx = mi.mesh_closest_hit(*args, leaf, eps)[:2]
    fo, fd, fmax = cs.occlusion_rays(scene, o, d, t, idx)
    out.append(("K2, cow's free-space occlusion rays", fo.shape[0],
                lambda m: m.mesh_any_hit(fo, fd, fmax, *tabs, aabb, leaf, eps), 10))
    sup = scene.super_aabb
    out.append(("K7a, cow", o.shape[0], lambda m: m.mesh_closest_hit_elementwise(
        o, d, *tabs, aabb, sup, leaf, eps), 5))
    out.append(("K7b, cow's free-space occlusion rays", fo.shape[0],
                lambda m: m.mesh_any_hit_elementwise(fo, fd, fmax, *tabs, aabb, sup,
                                                     leaf, eps), 5))

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
            out.append(("K4, glass_teapot's census", oo.shape[0],
                        census_case(sc, oo, dd, eps), 10))

    sc, cam = cs.slice_scene("cow_herd_mesh", cs.WIDTH)
    oo, dd = cs.main_path_rays(cam)
    tb, ab, lf = cs.tables(sc), sc.cluster_aabb, sc.static.cluster_size
    out.append(("K1 with_t0 streamed (11 launches), one-mesh herd", oo.shape[0],
                lambda m: m.mesh_closest_hit(oo, dd, *tb, sc.tri_n, ab, lf, eps), 3))
    out.append(("K1 with_uv streamed (11 launches), one-mesh herd", oo.shape[0],
                lambda m: m.mesh_closest_hit_uv(oo, dd, *tb, ab, lf, eps), 3))
    out.append((f"K1 flat, one launch over the one-mesh herd's {sc.static.n_clusters} "
                "clusters", oo.shape[0],
                lambda m: m.mesh_closest_hit(oo, dd, *tb, sc.tri_n, ab, lf, eps,
                                             block_budget=sc.tri_p1.shape[0]), 3))

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
    return out


def census_case(scene, o, d, eps):
    """K4 on glass_teapot's main-path census input (chip_smoke.py phase 7)."""
    K = len(scene.static.refr_mesh_obj_ids)
    hit = integrator.closest_hit(scene, o, d, RenderConfig())
    live = hit.valid & (integrator.object_record(scene, hit.obj)["transparency"] > 0.0)
    t_main = torch.where(live, hit.t, -BIG).contiguous()
    g_main = torch.where(hit.is_tri, hit.tri, -2).to(torch.int32).contiguous()
    tabs, leaf = cs.tables(scene), scene.static.cluster_size
    return lambda m: m.mesh_crossing_count(o, d, t_main, g_main, *tabs, scene.cluster_aabb,
                                           scene.tri_cid, K, leaf, eps)


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
                            "cluster_tests", "sub_tests")]
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


def summary(counts, flags) -> dict:
    """The count record of one walk on one wavefront."""
    return {"box_tests": stats(counts[:, BOX_TESTS].sum(1)),
            "pair_tests": stats(counts[:, PAIRS].sum(1)),
            "mean_a_ray": {k: float(counts[:, C[k]].double().mean()) for k in mi.COUNTERS},
            "occluded": int(flags.sum())}


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
    i32) of the occlusion loops it ran (K2's table-order loop, K3's phase
    3, K6). The scratch buffer starts at zero and every launch in call
    adds to it."""
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
        hit, c = counted(lambda: mi.mesh_any_hit(
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

    def report(case, walk, counts, flags, production, work=None):
        nonlocal ok
        same = torch.equal(flags.cpu(), production.cpu())
        ok &= same
        line = {"card": cs.CARD, "case": case, "walk": walk, "rays": int(flags.numel()),
                "flags_equal_production": same, **summary(counts, flags)}
        if work is not None:
            line["bound_model_a_ray"] = {k: v / flags.numel() for k, v in model(work).items()}
        record["walks"].append(line)
        print(json.dumps(line), flush=True)

    scene, cam = cs.slice_scene("cow", cs.WIDTH)
    o, d = cs.main_path_rays(cam)
    tabs, aabb, leaf = cs.tables(scene), scene.cluster_aabb, scene.static.cluster_size
    k3 = lambda: mi.mesh_closest_shadow(o, d, *tabs, scene.tri_n, aabb, scene.light_pos,
                                        leaf, eps, occ=scene.occ)
    production = k3()[3]
    so, sd, smax = cs.k3_shadow_rays(scene, o, d, eps)
    case = "cow K3 phase 3 (460,800 surface shadow rays)"
    flags, counts = counted(lambda: mi.mesh_any_hit(so, sd, smax, *tabs, aabb, leaf, eps),
                               o.shape[0], lib)
    report(case, "old: table-order loop (K2)", counts, flags, production,
           cs.any_work(so, sd, tabs, aabb, smax, production, leaf, eps))
    out, counts = counted(k3, o.shape[0], lib)
    report(case, "new: occlusion walk (K3)", counts, out[3], production,
           cs.occlusion_walk_work(so, sd, scene.occ, leaf, eps, smax, production))

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
        report(case, "old: instances and the table-order loop", counts, flags, production,
               cs.tlas_work(fo, fd, tl, st, eps, fmax, strict=True,
                            occluded=production & live)[0])
        flags, counts = counted(k6, fo.shape[0], lib)
        report(case, "new: occlusion walk (K6)", counts, flags, production,
               cs.tlas_walk_work(fo, fd, tl, st, herd.tlas_occ, eps, fmax, production))
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(record, f, indent=1)
    print(f"wrote {os.path.relpath(out_path, ROOT)}; counted flags "
          + ("equal the production build's" if ok else "DIFFER from the production build's"))
    return 0 if ok else 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="a checkout of the commit to compare with")
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
    mods = builds(args.parent)
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
    for case, rays, call, iters in cases(eps):
        order = list(libs) + list(libs)[::-1]
        ms = {name: [] for name in libs}
        outs = {}
        for name in order:
            t, got = cs.timed_ms(lambda: call(mods[name]), 2, iters)
            ms[name].append(t)
            outs[name] = got if isinstance(got, tuple) else (got,)
        first = next(iter(libs))
        equal = {name: all(torch.equal(a, b) for a, b in
                           zip(bits(outs[name]), bits(outs[first])))
                 for name in libs}
        ok &= all(equal.values())
        line = {"card": cs.CARD, "case": case, "rays": rays,
                "ms": {n: sum(v) / len(v) for n, v in ms.items()}, "ms_each": ms,
                "bit_equal_to_" + first: equal,
                "digest": {n: digest(outs[n]) for n in libs}}
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
