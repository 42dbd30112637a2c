#!/usr/bin/env python3
"""Where the time of one rtc_tpu_torch frame goes, on one NVIDIA GPU.

Run from the repository root:

    python3 profile_frame.py [--scene cow] [--impl auto] [--tile 460800] [--frames 10]

--scene is any of the 14 registry scenes (cow, teapot, pumpkin,
teapot_smooth, glass_teapot, teddy, cow_herd, cow_herd_smooth, and the
prim-only hexagon, table, single_sphere, three_spheres, glass_spheres and
default_world, the last two of those square) or a test world
(cow_herd_mesh, cow_herd_mesh_smooth: the herd baked into one mesh leaf,
whose table streams in superblocks); --impl is RenderConfig.mesh_impl
(auto, or elementwise for K7a/K7b). For the fused (default) and the split
(fused_shadow=False) frame of the scene (only the default one where the
route takes no fused kernel: analytic prims, instancing, a streamed
table, or the elementwise backend) it times --frames unprofiled frames at width 1920 (1920x960, or
1920x1920 for a square scene), depth 5, f32 on the host
clock around render() and torch.cuda.synchronize(), after 3 warm-up
frames, then profiles one more with torch.profiler and sums the device
time of its kernels by name (the port's kernels K1-K7 under their own
CUDA names, e.g. closest_hit_tlas_kernel and any_hit_tlas_kernel for the
herds' K5 and K6). It prints one JSON line per frame kind and writes the
full record to build/profile/frame_<scene>[_<impl>].json.

    python3 profile_frame.py --grad [--scene cow]

profiles the scene's gradient frame instead: at 1920x960, depth 5, f32,
the kernels (cow's fused K3), against a target rendered with
chip_smoke.py's perturbed material and light (phase 13), in tiles of --tile
rays. For each parameter set (GRAD_SETS) it times diff.render_grad's
loss_and_grad over the frame, one tile at a time, and one Adam step of
make_train_step over the whole frame in one graph (host clock around the
call and torch.cuda.synchronize(), after a warm-up); then profiles one
tile's loss_and_grad and one whole-frame step of the largest set under
torch.profiler: device time by kernel, the operators' self CPU and device
time, and the step's device time split into forward, backward and
update at spin kernels queued between them; and the cuBLAS launches of a
replayed graphed Adam step (capturable) of the color_light set. Record:
build/profile/grad_<scene>.json.

Both modes list the cuBLAS kernels (gemv or gemm in their names) of one
eager frame or step by the operation that launched them and its input
shapes, a backward kernel also by the forward operation whose autograd
node ran it ("cublas_sites"); "cublas_launches" counts them by name in a
graphed replay.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import statistics
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from rtc_tpu_torch.diff import render_grad as RG
from rtc_tpu_torch.models.scenes import REGISTRY, TEST_WORLDS
from rtc_tpu_torch.render import compiled, integrator
from rtc_tpu_torch.render.camera import camera_rays_for_pixels
from rtc_tpu_torch.render.renderer import blocked_pixels, render
from rtc_tpu_torch.scene.compile import compile_scene
from rtc_tpu_torch.utils.config import RenderConfig
from rtc_tpu_torch.utils import profiling
from rtc_tpu_torch.utils.profiling import rays_per_pixel

ROOT = os.path.dirname(os.path.abspath(__file__))
WIDTH, DEPTH = 1920, 5
OUR_KERNELS = ("closest_hit_kernel", "any_hit_kernel", "closest_shadow_kernel",
               "crossing_count_kernel", "closest_hit_tlas_kernel",
               "any_hit_tlas_kernel", "closest_hit_elementwise_kernel", "any_hit_elementwise_kernel",
               "prim_sweep_kernel")
SCENES = dict(REGISTRY, **TEST_WORLDS)
ACTIVITIES = [ProfilerActivity.CPU, ProfilerActivity.CUDA]


def frame_seconds(scene, cam, cfg) -> float:
    t0 = time.perf_counter()
    render(scene, cam, cfg)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def is_cublas(name: str) -> bool:
    return "gemv" in name or "gemm" in name


def cublas_launches(fn) -> dict:
    """{kernel name: launches} of the cuBLAS kernels fn() runs, under
    torch.profiler."""
    torch.cuda.synchronize()
    with profile(activities=ACTIVITIES) as prof:
        fn()
        torch.cuda.synchronize()
    return dict(collections.Counter(e.name for e in profiling.device_ops(prof.events())
                                    if is_cublas(e.name)))


def _autograd_node(e):
    """The backward function a profiler event ran inside, or None."""
    while e is not None:
        if e.name.startswith("autograd::engine::evaluate_function"):
            return e
        e = e.cpu_parent
    return None


def cublas_sites(fn) -> list:
    """The cuBLAS kernels of one eager fn() under torch.profiler, by the
    operation that launched them and its input shapes; a backward kernel
    also by its autograd node and the forward operation that made the
    node (the same sequence number). Shapes name the call site: the
    card's profiler records no Python stack. Most launches first."""
    torch.cuda.synchronize()
    with compiled.eager(), profile(activities=ACTIVITIES, record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    forward = collections.defaultdict(list)  # operations that share a number
    for e in events:
        if e.sequence_nr >= 0 and e.name.startswith("aten::") and _autograd_node(e) is None:
            forward[e.sequence_nr].append(e)
    counts = collections.Counter()
    for e in events:
        for k in e.kernels:
            if is_cublas(k.name):
                node, made = _autograd_node(e), ""
                if node is not None:
                    fn_name = node.name.split(": ")[-1]  # BmmBackward0 of aten::bmm
                    op = "aten::" + fn_name[:fn_name.find("Backward")].lower()
                    f = [x for x in forward[node.sequence_nr] if x.name == op]
                    made = (f"{fn_name} of {op} {f[0].input_shapes}" if f else fn_name)
                counts[(e.name, str(e.input_shapes), made, k.name)] += 1
    return [{"op": op, "shapes": shapes, "backward": made, "kernel": kernel, "launches": n}
            for (op, shapes, made, kernel), n in sorted(counts.items(), key=lambda kv: -kv[1])]


def _sites_line(sites: list) -> list:
    return [f"{s['launches']}x {s['op']} {s['shapes']} {s['backward']} {s['kernel'][:40]}"
            for s in sites]


def profiled_frame(scene, cam, cfg) -> dict:
    """One frame under torch.profiler: wall, device busy and idle share,
    device time per kernel name, the program's spans (host ms by name)
    and the device's idle gaps inside render() by the innermost span."""
    torch.cuda.synchronize()
    profiling.take_spans()
    with profile(activities=ACTIVITIES) as prof:
        wall_ms = frame_seconds(scene, cam, cfg) * 1e3
    events = prof.events()
    ops = profiling.device_ops(events)
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
        "spans_ms": {k: t.seconds * 1e3 for k, t in
                     profiling.totals(profiling.take_spans().spans).items()},
        "idle_gaps_ms": [[name, s * 1e3] for s, name, _ in profiling.idle_gaps(events)[:10]],
        "cublas_launches": {name: n for name, (n, _) in by_name.items()
                            if is_cublas(name)},
        "by_kernel": [{"name": name, "launches": n, "ms": ms}
                      for name, (n, ms) in top],
    }


# the gradient frame's parameter sets: the two chip_smoke.py phase 13
# trains, rtc_tpu's default set, and that with the triangle rows
GRAD_SETS = {"color_light": ("mat_color", "light_intensity"),
             "default": RG.DEFAULT_PARAMS,
             "default_rows": RG.DEFAULT_PARAMS + ("tri_p1",)}
GRAD_PERTURB = {"mat_color": -0.3, "light_intensity": -0.3}  # chip_smoke.PERTURB


def ops_table(prof, n: int = 15) -> dict:
    """The operators with the most self CPU and self device time."""
    avg = prof.key_averages()
    row = lambda e: {"name": e.key, "calls": e.count,
                     "self_cpu_ms": e.self_cpu_time_total / 1e3,
                     "self_device_ms": getattr(e, "self_device_time_total",
                                               getattr(e, "self_cuda_time_total", 0)) / 1e3}
    by = lambda k: [row(e) for e in sorted(avg, key=lambda e: -row(e)[k])[:n]]
    return {"by_cpu": by("self_cpu_ms"), "by_device": by("self_device_ms")}


def device_parts(prof, names) -> dict:
    """Device ms of the kernels between the spin kernels (torch.cuda._sleep)
    that the caller queued between the parts named in names, in device
    order; None when the profiler recorded no spin kernel."""
    ops = sorted(profiling.device_ops(prof.events()), key=lambda e: e.time_range.start)
    parts, k = dict.fromkeys(names, 0.0), 0
    for e in ops:
        if "spin" in e.name:
            k += 1
        elif k < len(names):
            parts[names[k]] += e.time_range.elapsed_us() / 1e3
    return parts if k == len(names) - 1 else None


def grad_frames(name: str, tile: int, card: str) -> dict:
    """The gradient frame of a scene (see the module's docstring)."""
    world, cam = SCENES[name](WIDTH)
    scene = compile_scene(world, dtype=torch.float32, device="cuda")
    cfg = RenderConfig(ray_tile=tile, mesh_impl="kernel")
    px, py = blocked_pixels(cam.vsize, cam.hsize, "cuda")
    o, d = (x.contiguous() for x in camera_rays_for_pixels(
        cam.transform_inverse, px, py, cam.half_width, cam.half_height, cam.pixel_size))
    tiles = [(o[i:i + tile].contiguous(), d[i:i + tile].contiguous())
             for i in range(0, o.shape[0], tile)]
    base = RG.extract_params(scene)
    with torch.no_grad():
        target_scene = RG.inject_params(scene, {k: base[k].detach() + v
                                                for k, v in GRAD_PERTURB.items()})
        target = torch.cat([integrator.color_at(target_scene, a, b, cfg)
                            for a, b in tiles])
    targets = list(target.split(tile))

    def frame_grad(params):
        for (a, b), t in zip(tiles, targets):
            RG.loss_and_grad(params, scene, a, b, t, cfg)

    def seconds(fn, runs: int = 3):
        fn()
        out = []
        for _ in range(runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    record = {"card": card, "scene": name, "tile": tile, "sets": {}}
    for set_name, names in GRAD_SETS.items():
        params = RG.extract_params(scene, names)
        step = RG.make_train_step(torch.optim.Adam(params.values(), lr=5e-2), cfg)
        entry = {"loss_and_grad_frame_ms": seconds(lambda: frame_grad(params)),
                 "train_step_ms": seconds(lambda: step(params, scene, o, d, target))}
        record["sets"][set_name] = entry
        print(json.dumps({"card": card, "grad_set": set_name, **entry}), flush=True)

    params = RG.extract_params(scene, GRAD_SETS["color_light"])
    step = RG.make_train_step(torch.optim.Adam(params.values(), lr=5e-2, capturable=True),
                              cfg)
    step(params, scene, o, d, target)  # the eager run and the capture
    record["step_cublas"] = {
        "cublas_launches": cublas_launches(lambda: step(params, scene, o, d, target)),
        "cublas_sites": cublas_sites(lambda: step(params, scene, o, d, target))}
    print(json.dumps({"card": card, "scene": name, "graphed_step_cublas_launches":
                      record["step_cublas"]["cublas_launches"],
                      "eager_step_cublas_sites":
                      _sites_line(record["step_cublas"]["cublas_sites"])}), flush=True)

    params = RG.extract_params(scene, GRAD_SETS["default_rows"])
    (a, b), t = tiles[0], targets[0]
    torch.cuda.synchronize()
    with profile(activities=ACTIVITIES) as prof:
        t0 = time.perf_counter()
        RG.loss_and_grad(params, scene, a, b, t, cfg)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = sum(e.time_range.elapsed_us() for e in profiling.device_ops(prof.events())) / 1e3
    record["tile_loss_and_grad"] = {"wall_ms": wall, "device_busy_ms": busy,
                                    **ops_table(prof)}
    opt = torch.optim.Adam(params.values(), lr=5e-2)
    torch.cuda.synchronize()
    with profile(activities=ACTIVITIES) as prof:
        t0 = time.perf_counter()
        opt.zero_grad()
        loss = RG.render_loss(params, scene, o, d, target, cfg)
        torch.cuda._sleep(1000)
        loss.backward()
        torch.cuda._sleep(1000)
        opt.step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    parts = device_parts(prof, ("forward", "backward", "update"))
    busy = sum(parts.values()) if parts else None
    record["frame_step"] = {"wall_ms": wall, "device_ms": parts,
                            "backward_share_of_device":
                                parts["backward"] / busy if busy else None,
                            **ops_table(prof)}
    for key in ("tile_loss_and_grad", "frame_step"):
        r = record[key]
        print(json.dumps({"card": card, "profiled": key,
                          **{k: v for k, v in r.items() if k not in ("by_cpu", "by_device")},
                          "top_cpu": [f"{e['self_cpu_ms']:.1f} ms x{e['calls']} {e['name'][:50]}"
                                      for e in r["by_cpu"][:8]],
                          "top_device": [f"{e['self_device_ms']:.2f} ms x{e['calls']} "
                                         f"{e['name'][:50]}" for e in r["by_device"][:8]]}),
              flush=True)
    return record


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", default="cow", choices=sorted(SCENES))
    ap.add_argument("--impl", default="auto", choices=("auto", "elementwise"))
    ap.add_argument("--tile", type=int, default=460800,
                    help="RenderConfig.ray_tile (default: bench.py's cow tile)")
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--grad", action="store_true",
                    help="profile the scene's gradient frame instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_frame: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    if args.grad:
        record = grad_frames(args.scene, args.tile, card)
        out = os.path.join(ROOT, "build", "profile", f"grad_{args.scene}.json")
        os.makedirs(os.path.dirname(out), exist_ok=True)
        with open(out, "w") as f:
            json.dump(record, f, indent=1)
        print(f"wrote {os.path.relpath(out, ROOT)}")
        return 0
    world, cam = SCENES[args.scene](WIDTH)
    scene = compile_scene(world, dtype=torch.float32, device="cuda")
    st = scene.static
    casts = cam.hsize * cam.vsize * rays_per_pixel(DEPTH, st.any_reflective,
                                                   st.any_refractive)
    record = {"card": card, "scene": args.scene, "impl": args.impl,
              "tile": args.tile, "casts": casts, "frames": {}}
    fusable = integrator.plan(scene, RenderConfig(mesh_impl=args.impl), "cuda",
                              torch.float32).fused
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
                 **profiled_frame(scene, cam, cfg),
                 "cublas_sites": cublas_sites(lambda: render(scene, cam, cfg))}
        record["frames"][kind] = entry
        summary = {k: v for k, v in entry.items() if k not in ("by_kernel", "cublas_sites")}
        summary["cublas_sites"] = _sites_line(entry["cublas_sites"])
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
