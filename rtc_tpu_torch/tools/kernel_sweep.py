"""Sweep K1's structural parameters on the cow wavefronts (counterpart of
kernel_sweep.py).

    python -m rtc_tpu_torch.tools.kernel_sweep [width] [--leafs=64,128,256]
        [--rts=64,128,256] [--device=cuda|cpu]

leaf (the cluster size, compile_scene(cluster_size=)) x rt (the CUDA block
size of the per-ray kernels, kThreads, built with -DRTC_THREADS=rt: the
counterpart of the TPU kernel's ray tile), timed on the coherent primary
wavefront (render()'s order) and on the incoherent reflected wavefront of
its hits. Before a pair is timed, its K1 is held to closest_hit_plain on
every 8th ray of both wavefronts: t bit for bit, the index equal but at
ties. Prints one JSON line a pair, kernel_sweep.py's keys. On the CPU the
wrappers take their plain versions, so there is one line a leaf with rt
null.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import json
import sys

import torch

from ..models.scenes import REGISTRY
from ..ops.kernels import mesh_intersect as mi
from ..ops.vec import reflect
from ..scene.compile import compile_scene
from ..utils.config import RenderConfig
from ..utils.constants import FAR
from .common import frame_rays, timeit

PARITY_STEP = 8  # K1 against plain on every PARITY_STEP-th ray


def block_libraries(rts) -> dict:
    """{rt: the kernels built and bound with rt threads a block}, the
    builds run in parallel (one nvcc each)."""
    with concurrent.futures.ThreadPoolExecutor(len(rts)) as pool:
        paths = {rt: pool.submit(mi.build, extra_flags=mi.block_flags(rt)) for rt in rts}
        return {rt: mi.bind(f.result()) for rt, f in paths.items()}


@contextlib.contextmanager
def using(lib):
    """The wrappers launch lib's kernels in the body (None: the default
    build's)."""
    if lib is None:
        yield
        return
    default = mi.library
    mi.library = lambda: lib
    try:
        yield
    finally:
        mi.library = default


def k1_parity(what: str, o, d, tabs, aabb, leaf: int, eps: float) -> int:
    """K1 on every PARITY_STEP-th ray of (o, d) against closest_hit_plain:
    raises unless t is bit-equal and every differing index is a tie.
    Returns the ties."""
    o, d = o[::PARITY_STEP].contiguous(), d[::PARITY_STEP].contiguous()
    t, idx, _ = mi.mesh_closest_hit(o, d, *tabs, aabb, leaf, eps)
    tp, ip, _ = mi.closest_hit_plain(o, d, *tabs, eps)
    if not torch.equal(t, tp):
        raise AssertionError(f"{what}: K1's t differs from plain on "
                             f"{int((t != tp).sum())} of {o.shape[0]} rays")
    if not bool((t[idx != ip] == tp[idx != ip]).all()):
        raise AssertionError(f"{what}: K1 picked a non-closest triangle")
    return int((idx != ip).sum())


@torch.no_grad()
def sweep(width: int = 1920, leafs=(64, 128, 256), rts=(64, 128, 256),
          device="cuda") -> list:
    """One row a (leaf, rt) pair, printed as a JSON line; rts is (None,)
    on the CPU."""
    cuda = torch.device(device).type == "cuda"
    libs = block_libraries(rts) if cuda else {None: None}
    eps = RenderConfig().epsilon
    world, cam = REGISTRY["cow"](width)
    rows = []
    for leaf in leafs:
        scene = compile_scene(world, dtype=torch.float32, device=device,
                              cluster_size=leaf)
        st = scene.static
        tabs = (scene.tri_p1, scene.tri_e1, scene.tri_e2, scene.tri_n)
        o, d = frame_rays(cam, device)
        R = o.shape[0]
        # the reflected wavefront of this build's hits, lifted 1e-4
        t, idx, n = mi.mesh_closest_hit(o, d, *tabs, scene.cluster_aabb, leaf, eps)
        valid = idx >= 0
        p = o + d * torch.where(valid, t, 1.0)[:, None]
        o2 = torch.where(valid[:, None], p + n * 1e-4, FAR).contiguous()
        d2 = torch.where(valid[:, None], reflect(d, n), 0.5773502692).contiguous()
        for rt, lib in libs.items():
            with using(lib):
                ties = [k1_parity(f"leaf {leaf}, rt {rt}, {name}", oo, dd, tabs,
                                  scene.cluster_aabb, leaf, eps)
                        for name, oo, dd in (("primary", o, d), ("reflected", o2, d2))]
                k1 = lambda oo, dd: mi.mesh_closest_hit(oo, dd, *tabs,
                                                        scene.cluster_aabb, leaf, eps)
                tp = timeit(lambda: k1(o, d), device, iters=10)
                tr = timeit(lambda: k1(o2, d2), device, iters=10)
            print(f"kernel_sweep: leaf {leaf}, rt {rt}: K1 t bit-equal to plain on "
                  f"every {PARITY_STEP}th ray of both wavefronts, index ties "
                  f"{ties[0]} and {ties[1]}", file=sys.stderr)
            row = {"leaf": leaf, "rt": rt, "n_clusters": st.n_clusters,
                   "prim_ms": tp * 1e3, "prim_mrays": R / tp / 1e6,
                   "refl_ms": tr * 1e3, "refl_mrays": R / tr / 1e6}
            print(json.dumps(row), flush=True)
            rows.append(row)
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="rtc_tpu_torch.tools.kernel_sweep",
                                     description=__doc__.split("\n\n")[0])
    parser.add_argument("width", nargs="?", type=int, default=1920)
    parser.add_argument("--leafs", default="64,128,256")
    parser.add_argument("--rts", default="64,128,256")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    ints = lambda s: tuple(int(x) for x in s.split(","))
    sweep(args.width, ints(args.leafs), ints(args.rts), args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
