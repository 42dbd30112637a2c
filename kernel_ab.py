#!/usr/bin/env python3
"""Builds of the CUDA kernels timed in turns on one GPU, on the same
wavefronts, with their outputs held equal bit for bit.

Run from the repository root:

    python3 kernel_ab.py [--parent DIR] [--out FILE]

Builds, compiled at once, each from rtc_tpu_torch/csrc/mesh_intersect.cu:

  parent  the source of another checkout, DIR (a `git archive` of the
          commit to compare with, unpacked into a git-ignored directory
          such as build/parent); only with --parent
  change  this checkout's source as it stands

To sweep a constant of the kernels (such as the ordered walk's list
lengths kListK1 and kListK5), edit it in a copy and pass the copy as
--parent.

This checkout's wrappers launch each build in turn (the builds share their
C entry points). The cases are the wavefronts of chip_smoke.py: 460,800
primary rays (every 4th ray of 1920x960, block-major) of cow (K1 flat, K3
flat), teapot_smooth (K1 and K3 with_sn), glass_teapot (K1 with_sn), the
90-cow one-mesh herd (K1 t0 streamed in 11 blocks, K1 uv streamed, and one
K1 launch over all 4,088 clusters), cow_herd (K5 flat) and cow_herd_smooth
(K5 with_sn); and the 10,240 rays of chip_smoke.py's 208-cluster soup (K1
flat). Each case runs the builds in the order first..last, last..first,
each timed with CUDA events around repeated calls after a warm-up, so every
build sees the same card state; every build's outputs must equal the first
build's bit for bit (t, idx or enc, object id, payload, shadow flags).

Prints, per build, the ptxas registers of its walking kernels and, for
builds that report the ordered walk (rtc_walk_list), its list lengths and
each walking kernel's registers, local and shared bytes and occupancy;
then one JSON line
per case, with each build's two times, the mean of them, and a digest of
its outputs; writes the whole record to --out (default
build/kernel_ab.json). Exits non-zero if any output differs. Needs one
CUDA device.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import sys
from concurrent.futures import ThreadPoolExecutor
from functools import partial

import numpy as np
import torch

import chip_smoke as cs
from rtc_tpu_torch.ops.kernels import mesh_intersect as mi
from rtc_tpu_torch.render import integrator
from rtc_tpu_torch.utils.config import RenderConfig

ROOT = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join("rtc_tpu_torch", "csrc", "mesh_intersect.cu")
# the walking kernels' names in nvcc's ptxas report
PTXAS_KERNELS = ("closest_hit_kernel", "closest_shadow_kernel", "closest_hit_tlas_kernel")


def builds(parent: str | None) -> dict:
    """{name: source} in the order the cases run them."""
    out = {}
    if parent:
        out["parent"] = os.path.join(parent, SOURCE)
    out["change"] = os.path.join(ROOT, SOURCE)
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


def cases(eps: float) -> list:
    """[(name, rays, call, iters)]: each call returns the kernel's outputs."""
    out = []
    scene, cam = cs.slice_scene("cow", cs.WIDTH)
    o, d = cs.main_path_rays(cam)
    args = (o, d, *cs.tables(scene), scene.tri_n, scene.cluster_aabb)
    leaf = scene.static.cluster_size
    out.append(("K1 flat, cow", o.shape[0],
                partial(mi.mesh_closest_hit, *args, leaf, eps), 10))
    out.append(("K3 flat, cow", o.shape[0],
                partial(mi.mesh_closest_shadow, *args, scene.light_pos, leaf, eps), 10))

    soup, so, sd = cs.soup_scene(np.random.default_rng(0))
    out.append((f"K1 flat, soup ({soup.static.n_clusters} clusters)", so.shape[0],
                partial(mi.mesh_closest_hit, so, sd, *cs.tables(soup), soup.tri_n,
                        soup.cluster_aabb, soup.static.cluster_size, eps), 10))

    for name in ("teapot_smooth", "glass_teapot"):
        scene, cam = cs.slice_scene(name, cs.WIDTH)
        o, d = cs.main_path_rays(cam)
        args = (o, d, *cs.tables(scene), integrator.corner_normals(scene),
                scene.cluster_aabb)
        leaf = scene.static.cluster_size
        out.append((f"K1 with_sn, {name}", o.shape[0],
                    partial(mi.mesh_closest_hit_sn, *args, leaf, eps), 10))
        if name == "teapot_smooth":
            out.append((f"K3 with_sn, {name}", o.shape[0],
                        partial(mi.mesh_closest_shadow_sn, *args, scene.light_pos,
                                leaf, eps), 10))

    scene, cam = cs.slice_scene("cow_herd_mesh", cs.WIDTH)
    o, d = cs.main_path_rays(cam)
    tabs, aabb, leaf = cs.tables(scene), scene.cluster_aabb, scene.static.cluster_size
    out.append(("K1 with_t0 streamed (11 launches), one-mesh herd", o.shape[0],
                partial(mi.mesh_closest_hit, o, d, *tabs, scene.tri_n, aabb, leaf,
                        eps), 3))
    out.append(("K1 with_uv streamed (11 launches), one-mesh herd", o.shape[0],
                partial(mi.mesh_closest_hit_uv, o, d, *tabs, aabb, leaf, eps), 3))
    out.append((f"K1 flat, one launch over the one-mesh herd's {scene.static.n_clusters} "
                "clusters", o.shape[0],
                partial(mi.mesh_closest_hit, o, d, *tabs, scene.tri_n, aabb, leaf, eps,
                        block_budget=scene.tri_p1.shape[0]), 3))

    for name in ("cow_herd", "cow_herd_smooth"):
        scene, cam = cs.slice_scene(name, cs.WIDTH)
        st, tl = scene.static, scene.tlas
        o, d = cs.main_path_rays(cam)
        kernel = mi.mesh_closest_hit_tlas_sn if st.tlas_sn else mi.mesh_closest_hit_tlas
        out.append((f"K5 {'with_sn' if st.tlas_sn else 'flat'}, {name}", o.shape[0],
                    partial(kernel, o, d, tl.p1, tl.e1, tl.e2,
                            tl.sn if st.tlas_sn else tl.n, tl.caabb, tl.inst_ab,
                            tl.inst_aabb, tl.inst_mesh, tl.inst_obj, st.cluster_size,
                            st.tlas_cm, eps), 10))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="a checkout of the commit to compare with")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "kernel_ab.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    cs.CARD = cs.card()
    eps = RenderConfig().epsilon
    spec = builds(args.parent)
    with ThreadPoolExecutor(len(spec)) as pool:  # one nvcc per build, all at once
        paths = dict(zip(spec, pool.map(mi.build, spec.values())))
    libs = {name: mi.bind(path) for name, path in paths.items()}
    record = {"card": cs.CARD, "builds": {}, "cases": []}
    for name, lib in libs.items():
        info = {"source": os.path.relpath(spec[name], ROOT),
                "ptxas_registers": ptxas_registers(paths[name])}
        if hasattr(lib, "rtc_walk_list"):  # a build from before the walk has no report
            info["walk_list"] = mi.walk_list(lib)
            info["walk_kernels"] = mi.walk_kernel_report(lib)
        record["builds"][name] = info
        print(json.dumps({"card": cs.CARD, "build": name, **info}), flush=True)

    library = mi.library
    ok = True
    try:
        for case, rays, call, iters in cases(eps):
            order = list(libs) + list(libs)[::-1]
            ms = {name: [] for name in libs}
            outs = {}
            for name in order:
                mi.library = lambda lib=libs[name]: lib
                t, got = cs.timed_ms(call, 2, iters)
                ms[name].append(t)
                outs[name] = got
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
    finally:
        mi.library = library
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    print(f"wrote {os.path.relpath(args.out, ROOT)}; outputs "
          + ("bit-equal across every build" if ok else "DIFFER between builds"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
