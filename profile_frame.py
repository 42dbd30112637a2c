#!/usr/bin/env python3
"""Where the time of one rtc_tpu_torch frame goes, on one NVIDIA GPU.

Run from the repository root:

    python3 profile_frame.py [--scene cow] [--impl auto] [--tile 460800] [--frames 10]

--scene is any registry scene (cow, teapot, pumpkin, teapot_smooth,
glass_teapot, teddy, cow_herd, cow_herd_smooth) or a test world
(cow_herd_mesh, cow_herd_mesh_smooth: the herd baked into one mesh leaf,
whose table streams in superblocks); --impl is RenderConfig.mesh_impl
(auto, or elementwise for K7a/K7b). For the fused (default) and the split
(fused_shadow=False) frame of the scene (only the default one where the
route takes no fused kernel: analytic prims, instancing, a streamed
table, or the elementwise backend) it times --frames unprofiled frames at 1920x960, depth 5, f32 on the host
clock around render() and torch.cuda.synchronize(), after 3 warm-up
frames, then profiles one more with torch.profiler and sums the device
time of its kernels by name (the port's kernels K1-K7 under their own
CUDA names, e.g. closest_hit_tlas_kernel and any_hit_tlas_kernel for the
herds' K5 and K6). It prints one JSON line per frame kind and writes the
full record to build/profile/frame_<scene>[_<impl>].json.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from rtc_tpu_torch.models.scenes import REGISTRY, TEST_WORLDS
from rtc_tpu_torch.render import integrator
from rtc_tpu_torch.render.renderer import render
from rtc_tpu_torch.scene.compile import compile_scene
from rtc_tpu_torch.utils.config import RenderConfig
from rtc_tpu_torch.utils.profiling import rays_per_pixel

ROOT = os.path.dirname(os.path.abspath(__file__))
WIDTH, HEIGHT, DEPTH = 1920, 960, 5
OUR_KERNELS = ("closest_hit_kernel", "any_hit_kernel", "closest_shadow_kernel",
               "crossing_count_kernel", "closest_hit_tlas_kernel",
               "any_hit_tlas_kernel", "closest_hit_elementwise_kernel", "any_hit_elementwise_kernel")
SCENES = dict(REGISTRY, **TEST_WORLDS)


def frame_seconds(scene, cam, cfg) -> float:
    t0 = time.perf_counter()
    render(scene, cam, cfg)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def profiled_frame(scene, cam, cfg) -> dict:
    """One frame under torch.profiler: wall, device busy and idle share,
    and device time per kernel name."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_ms = frame_seconds(scene, cam, cfg) * 1e3
    ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not ops:
        raise RuntimeError("the profiler recorded no device operation")
    by_name: dict[str, list] = {}
    for e in ops:
        entry = by_name.setdefault(e.name, [0, 0.0])
        entry[0] += 1
        entry[1] += e.time_range.elapsed_us() / 1e3
    busy_ms = sum(ms for _, ms in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    return {
        "wall_ms_profiled": wall_ms,
        "device_busy_ms": busy_ms,
        "idle_share_of_wall": 1.0 - busy_ms / wall_ms,
        "n_device_ops": len(ops),
        "our_kernels_ms": {k: sum(ms for name, (_, ms) in by_name.items()
                                  if k in name) for k in OUR_KERNELS
                           if any(k in name for name in by_name)},
        "by_kernel": [{"name": name, "launches": n, "ms": ms}
                      for name, (n, ms) in top],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", default="cow", choices=sorted(SCENES))
    ap.add_argument("--impl", default="auto", choices=("auto", "elementwise"))
    ap.add_argument("--tile", type=int, default=460800,
                    help="RenderConfig.ray_tile (default: bench.py's cow tile)")
    ap.add_argument("--frames", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_frame: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    world, cam = SCENES[args.scene](WIDTH)
    scene = compile_scene(world, dtype=torch.float32, device="cuda")
    st = scene.static
    casts = WIDTH * HEIGHT * rays_per_pixel(DEPTH, st.any_reflective,
                                            st.any_refractive)
    record = {"card": card, "scene": args.scene, "impl": args.impl,
              "tile": args.tile, "casts": casts, "frames": {}}
    impl = "kernel" if args.impl == "auto" else args.impl  # f32 on the card
    fusable = integrator._use_fused_shadow(scene, RenderConfig(), impl)
    kinds = (("fused", True), ("split", False)) if fusable else (("default", True),)
    for kind, fused in kinds:
        cfg = RenderConfig(ray_tile=args.tile, fused_shadow=fused,
                           mesh_impl=args.impl)
        for _ in range(3):
            render(scene, cam, cfg)
        walls = sorted(frame_seconds(scene, cam, cfg) * 1e3
                       for _ in range(args.frames))
        median = statistics.median(walls)
        entry = {"wall_ms": walls, "median_ms": median,
                 "rays_per_s": casts / (median / 1e3),
                 **profiled_frame(scene, cam, cfg)}
        record["frames"][kind] = entry
        summary = {k: v for k, v in entry.items() if k != "by_kernel"}
        summary["top"] = [f"{k['ms']:.3f} ms x{k['launches']} {k['name'][:60]}"
                          for k in entry["by_kernel"][:6]]
        print(json.dumps({"card": card, "scene": args.scene, "impl": args.impl,
                          "tile": args.tile, "frame": kind, **summary}), flush=True)
    tag = "" if args.impl == "auto" else f"_{args.impl}"
    out = os.path.join(ROOT, "build", "profile", f"frame_{args.scene}{tag}.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        json.dump(record, f, indent=1)
    print(f"wrote {os.path.relpath(out, ROOT)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
