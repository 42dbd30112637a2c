"""CLI (counterpart of rtc_tpu/cli.py; reference: src/main.rs:43-81).

Reference contract: `ray-tracer-challenge-rust <filename.ppm> [width]`
renders the hard-coded cow scene at width x width/2. Here the scene is a
named argument with the same default:

    python -m rtc_tpu_torch <filename.ppm> [width]          # cow, on the card
    python -m rtc_tpu_torch --scene table out.ppm 800
    python -m rtc_tpu_torch --device cpu out.ppm 64
    python -m rtc_tpu_torch --list

plus the knobs the reference hardcodes: --depth (RECURSION_LIMIT,
src/world.rs:11), --dtype, --ray-tile, --report; and --device. The scene
is compiled onto the card unless --device cpu is given; without a card
that raises, as compile_scene does.
"""

from __future__ import annotations

import argparse
import sys

from .utils.config import DEFAULT_CONFIG


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="rtc_tpu_torch",
        description="Ray Tracer Challenge renderer on PyTorch and CUDA",
    )
    parser.add_argument("filename", nargs="?", help="output .ppm path")
    parser.add_argument("width", nargs="?", type=int, default=400,
                        help="width in px (default 400, height = width/2)")
    parser.add_argument("--scene", default="cow",
                        help="scene name (default: cow, matching the reference)")
    parser.add_argument("--depth", type=int, default=5,
                        help="recursion budget (default 5)")
    parser.add_argument("--dtype", default="float32", choices=["float32", "float64"])
    parser.add_argument("--ray-tile", type=int, default=DEFAULT_CONFIG.ray_tile)
    parser.add_argument("--device", default="cuda",
                        help="torch device of the scene and the render "
                             "(default cuda; cpu renders without a card)")
    parser.add_argument("--report", action="store_true",
                        help="print a JSON render report to stderr")
    parser.add_argument("--list", action="store_true", help="list scenes")
    args = parser.parse_args(argv)

    from .models.scenes import REGISTRY

    if args.list:
        for name in sorted(REGISTRY):
            print(name)
        return 0

    if not args.filename:
        print("Expected a filename argument!")
        print("usage: rtc_tpu_torch <filename.ppm> [width-in-px]")
        return 1

    if args.scene not in REGISTRY:
        print(f"Unknown scene {args.scene!r}; use --list")
        return 1

    import torch

    from .io.canvas import write_ppm
    from .render.renderer import render
    from .scene.compile import compile_scene
    from .utils.config import RenderConfig
    from .utils.profiling import RenderReport, rays_per_pixel, time_render

    world, camera = REGISTRY[args.scene](args.width)
    cfg = RenderConfig(max_depth=args.depth, dtype=args.dtype, ray_tile=args.ray_tile)
    scene = compile_scene(world, dtype=cfg.torch_dtype(), device=args.device)

    image, compile_s, wall_s = time_render(render, scene, camera, cfg)
    write_ppm(image, args.filename)

    if args.report:
        n_pix = camera.hsize * camera.vsize
        casts = n_pix * rays_per_pixel(
            cfg.max_depth, scene.static.any_reflective, scene.static.any_refractive)
        device = image.device
        report = RenderReport(
            scene=args.scene,
            width=camera.hsize,
            height=camera.vsize,
            wall_s=wall_s,
            compile_s=compile_s,
            primary_rays=n_pix,
            total_ray_casts=casts,
            rays_per_s=casts / wall_s if wall_s > 0 else 0.0,
            device=(torch.cuda.get_device_name(device) if device.type == "cuda"
                    else device.type),
            dtype=args.dtype,
        )
        print(report.to_json(), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
