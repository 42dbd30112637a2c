"""Benchmark: cow.obj at 1080p-class resolution on the card (counterpart of
bench.py).

    python -m rtc_tpu_torch.tools.bench [width] [--scene=NAME] [--tile=N]
        [--no-parity] [--no-suite] [--device=cuda|cpu]

prints ONE JSON line on stdout, bench.py's:

  {"metric": ..., "value": N, "unit": "rays/s", "vs_baseline": N}

vs_baseline = value / 1e8, the north-star target of 100M rays/s
(BASELINE.json), as bench.py computes it. Ray accounting is bench.py's:
pixels x rays_per_pixel (utils/profiling.py), one closest-hit sweep and one
shadow sweep per live node of the bounce tree (cow: 2 nodes at depth 5, 4
sweeps a pixel).

The suite's scenes (SUITE_SCENES) are benched by default, each as one JSON
line on stderr; --no-suite skips them. Each scene also prints, on stderr,
its five timed frames (median, min, max in ms: a diagnostic of the spread,
not a metric) and its peak memory on the card.

Without --tile a scene renders at RenderConfig().ray_tile, the tile the card
measured best on every scene (a loop of --tile=N --scene=NAME --no-suite
--no-parity runs; PERF.md).

The kernels are built from the checkout's source into build/kernels/ at
first use, inside the warm-up frame.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
import time

import numpy as np
import torch

from ..models.scenes import REGISTRY
from ..render import integrator
from ..render.camera import camera_rays
from ..render.renderer import render
from ..scene.compile import compile_scene
from ..utils.config import RenderConfig
from ..utils.constants import BIG
from ..utils.profiling import rays_per_pixel
from .common import device_name, synchronize


@torch.no_grad()
def check_kernel_parity(scene, cam, cfg) -> None:
    """Kernel correctness gate on the card (bench.py :26-101): the kernels'
    closest-hit and any-hit results on a wavefront of up to 10,240 of the
    frame's primary rays against the plain dense sweep (mesh_impl=
    "bruteforce"): equal hit masks, |dt| <= 1e-3 on the hits, indices that
    differ only at ties, and at most max(2, R // 2048) occlusion flips from
    the free-space midpoints to the hits. Skipped, as bench.py skips it,
    where the integrator resolves to no kernel route (the CPU, float64).
    Raises on a mismatch."""
    dtype = cfg.torch_dtype()
    o, d = camera_rays(cam.transform_inverse, cam.hsize, cam.vsize, cam.half_width,
                       cam.half_height, cam.pixel_size, dtype,
                       device=scene.tri_p1.device)
    if integrator.plan(scene, cfg, o.device, o.dtype).impl == "bruteforce":
        print("kernel parity: skipped (brute-force impl active)", file=sys.stderr)
        return
    # keep the plain reference's dense (R, T) sweep small for huge scenes
    n_tris = max(int(scene.static.n_tris), 1)
    R = min(10240, max(512, (250_000_000 // n_tris) // 512 * 512))
    step = max(1, o.shape[0] // R)
    o, d = o[::step][:R].contiguous(), d[::step][:R].contiguous()

    t_k, i_k, _ = integrator.mesh_closest(scene, o, d, cfg)
    cfg_bf = dataclasses.replace(cfg, mesh_impl="bruteforce")
    chunk = max(128, (50_000_000 // n_tris) // 128 * 128)
    parts = [integrator.mesh_closest(scene, o[i:i + chunk], d[i:i + chunk], cfg_bf)
             for i in range(0, R, chunk)]
    t_b = torch.cat([p[0] for p in parts]).cpu().numpy()
    i_b = torch.cat([p[1] for p in parts]).cpu().numpy()
    t_k, i_k = t_k.cpu().numpy(), i_k.cpu().numpy()

    hit_k, hit_b = t_k < BIG * 0.5, t_b < BIG * 0.5
    if not (hit_k == hit_b).all():
        raise AssertionError(
            f"kernel/bruteforce hit masks differ on {(hit_k != hit_b).sum()} rays")
    dt = np.abs(t_k - t_b)[hit_k]
    if not (dt <= 1e-3).all():
        raise AssertionError(f"closest-hit t diverges: max {dt.max()}")
    # indices must match except at genuine ties (equal t to tolerance)
    idx_mismatch = hit_k & (i_k != i_b)
    if not (np.abs(t_k - t_b)[idx_mismatch] <= 1e-3).all():
        raise AssertionError("kernel picked a non-closest triangle")

    # any-hit parity from free-space points, mid-way to each hit (an
    # on-surface origin is a self-intersection knife edge at t ~ 0)
    live = torch.as_tensor(hit_k, device=o.device)
    t_safe = torch.as_tensor(np.where(hit_k, t_k * 0.5, 1.0), dtype=dtype,
                             device=o.device)
    point = (o + d * t_safe[:, None]).contiguous()
    occ_k = integrator.is_shadowed(scene, point, cfg, live=live).cpu().numpy()
    occ_b = torch.cat([integrator.is_shadowed(scene, point[i:i + chunk], cfg_bf,
                                              live=live[i:i + chunk])
                       for i in range(0, R, chunk)]).cpu().numpy()
    nd = int((occ_k != occ_b).sum())
    # silhouette knife-edges may still flip a whisker of rays
    if nd > max(2, R // 2048):
        raise AssertionError(f"occlusion parity: {nd} rays differ")
    print(f"kernel parity ok on {device_name(o.device)}: "
          f"max |dt|={float(dt.max()) if dt.size else 0.0:.2e}, "
          f"occlusion diffs={nd}/{R}", file=sys.stderr)


SUITE_SCENES = ("teapot_smooth", "glass_teapot", "cow_herd",
                "cow_herd_smooth")


def tile_for(tile: int | None = None) -> int:
    """tile if given, else the port's default, RenderConfig().ray_tile."""
    return tile if tile is not None else RenderConfig().ray_tile


FRAMES = 5  # timed frames a scene, as bench.py


def bench_scene(scene_name: str, width: int, tile: int, parity: bool,
                device="cuda") -> dict:
    """Compile scene_name at width and time its frames: one warm-up frame
    (the kernels' build included), the parity gate, then FRAMES frames back
    to back and one synchronize. Prints on stderr the per-frame times in ms
    (CUDA events between the frames on the card, the host clock on the
    CPU), the peak memory on the card in GiB (null on the CPU) and the
    compile and warm-up seconds; returns bench.py's metric dict."""
    world, cam = REGISTRY[scene_name](width)
    cfg = RenderConfig(dtype="float32", ray_tile=tile)
    t0 = time.perf_counter()
    scene = compile_scene(world, dtype=torch.float32, device=device)
    compile_s = time.perf_counter() - t0
    cuda = scene.tri_p1.is_cuda
    if cuda:  # the peak from here on: the tables, then the frames
        torch.cuda.reset_peak_memory_stats(device)

    def run():
        return torch.sum(render(scene, cam, cfg))

    t0 = time.perf_counter()
    run()
    synchronize(device)
    warmup_s = time.perf_counter() - t0
    if parity:
        check_kernel_parity(scene, cam, cfg)
    marks = []

    def mark():
        if cuda:
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()
        else:
            marks.append(time.perf_counter())

    t0 = time.perf_counter()
    mark()
    for _ in range(FRAMES):
        run()
        mark()
    synchronize(device)
    wall = (time.perf_counter() - t0) / FRAMES
    if cuda:
        ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    else:
        ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    n_pix = cam.hsize * cam.vsize
    casts = n_pix * rays_per_pixel(
        cfg.max_depth, scene.static.any_reflective, scene.static.any_refractive)
    rays_per_s = casts / wall
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30 if cuda else None
    print(json.dumps({"scene": scene_name, "tile": tile, "frame_ms": {
        "median": statistics.median(ms), "min": min(ms), "max": max(ms)},
        "peak_gib": peak, "compile_s": compile_s, "warmup_s": warmup_s}),
        file=sys.stderr, flush=True)
    return {
        "metric": f"rays/s ({scene_name} {cam.hsize}x{cam.vsize}, depth 5, "
                  f"f32, {device_name(device)})",
        "value": round(rays_per_s),
        "unit": "rays/s",
        "vs_baseline": round(rays_per_s / 1e8, 4),
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="rtc_tpu_torch.tools.bench",
                                     description=__doc__.split("\n\n")[0])
    parser.add_argument("width", nargs="?", type=int, default=1920)
    parser.add_argument("--scene", default="cow")
    parser.add_argument("--tile", type=int, default=None)
    parser.add_argument("--no-parity", action="store_true")
    parser.add_argument("--no-suite", action="store_true")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    tile = tile_for(args.tile)
    row = bench_scene(args.scene, args.width, tile, not args.no_parity, args.device)
    if not args.no_suite:
        for extra in SUITE_SCENES:
            if extra != args.scene:
                print(json.dumps(bench_scene(extra, args.width, tile, False,
                                             args.device)),
                      file=sys.stderr, flush=True)
    print(json.dumps(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
