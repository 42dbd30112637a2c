"""Component timing of the bench frame (counterpart of perf_probe.py).

    python -m rtc_tpu_torch.tools.perf_probe [width] [--scene=cow] [--tile=N]
        [--device=cuda|cpu] [--gathers | --visits | --kernel-micro]

Times each stage on the host clock around a synchronize, after a warm-up
call, so that the frame's time can be split into where it goes:

  full          the bench frame (tools/bench.py's run, at its tile)
  depth1        the primary node only (closest + shadow)
  noshadow      full depth, shadows off
  closest       one closest-hit sweep over the primary wavefront
  anyhit        one occlusion sweep over the primary hits' shadow rays
  refl_closest  one closest-hit sweep over the reflected wavefront
  colorat_full, colorat_d1_full   color_at on the whole wavefront at once
  shade_8192, shade_8192_d1       the tiled shading loop at 8,192 rays a tile

The wavefront is the frame's primary rays in render()'s order (16x16
blocks, block-major), the order the kernels see them in a frame. It
prints two JSON lines, perf_probe.py's: the stages in seconds, then the
rates.

--gathers times the shading's random-access gathers; --visits counts the
clusters K1's ordered walk visits on each ray of the primary and the
reflected wavefronts (tools/walk.py), with the scans and box tests
modelled from them; --kernel-micro times the closest-hit sweep on the
real wavefront, on an all-sky one that enters no box, and on halves and
quarters of each.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np
import torch

from ..models.scenes import REGISTRY
from ..ops.kernels import mesh_intersect as mi
from ..ops.vec import reflect
from ..render import integrator
from ..render import renderer as RR
from ..render.renderer import render
from ..scene.compile import compile_scene
from ..utils.config import RenderConfig
from ..utils.constants import FAR
from .bench import tile_for
from .common import device_name, frame_rays, timeit
from .walk import entered, k1_visits, walk_census


def _setup(scene_name: str, width: int, device, tile=None):
    world, cam = REGISTRY[scene_name](width)
    cfg = RenderConfig(dtype="float32", ray_tile=tile_for(tile))
    scene = compile_scene(world, dtype=torch.float32, device=device)
    return scene, cam, cfg


def reflected(scene, o, d, cfg, eps: float):
    """The reflected wavefront of the primary rays (o, d): from each hit,
    lifted eps along its normal, in the mirror direction; a miss parked
    far away with direction (1, 1, 1) / sqrt(3). Returns (o2, d2, hit)."""
    t, _, n = integrator.mesh_closest(scene, o, d, cfg)
    valid = t < 1e29
    p = o + d * torch.where(valid, t, 1.0)[:, None]
    o2 = torch.where(valid[:, None], p + n * eps, FAR)
    d2 = torch.where(valid[:, None], reflect(d, n), 0.5773502692)
    return o2.contiguous(), d2.contiguous(), valid


@torch.no_grad()
def main(width: int = 1920, scene_name: str = "cow", device="cuda", tile=None) -> dict:
    scene, cam, cfg = _setup(scene_name, width, device, tile)
    o, d = frame_rays(cam, device)
    R = o.shape[0]
    t = lambda fn: timeit(fn, device)
    res = {}
    res["full"] = t(lambda: torch.sum(render(scene, cam, cfg)))
    cfg_d1 = dataclasses.replace(cfg, max_depth=1)
    res["depth1"] = t(lambda: torch.sum(render(scene, cam, cfg_d1)))
    cfg_ns = dataclasses.replace(cfg, shadows=False)
    res["noshadow"] = t(lambda: torch.sum(render(scene, cam, cfg_ns)))
    res["closest"] = t(lambda: integrator.mesh_closest(scene, o, d, cfg))
    over, rdir, valid = reflected(scene, o, d, cfg, cfg.epsilon)
    res["anyhit"] = t(lambda: integrator.is_shadowed(scene, over, cfg, live=valid))
    res["refl_closest"] = t(lambda: integrator.mesh_closest(scene, over, rdir, cfg))
    res["colorat_full"] = t(lambda: torch.sum(integrator.color_at(scene, o, d, cfg)))
    res["colorat_d1_full"] = t(
        lambda: torch.sum(integrator.color_at(scene, o, d, cfg_d1)))
    cfg_8192 = dataclasses.replace(cfg, ray_tile=8192)
    res["shade_8192"] = t(lambda: torch.sum(RR._shade_rays(scene, o, d, cfg_8192)))
    res["shade_8192_d1"] = t(lambda: torch.sum(RR._shade_rays(
        scene, o, d, dataclasses.replace(cfg_8192, max_depth=1))))
    rates = {
        "primary_rays_per_s_closest": R / res["closest"],
        "anyhit_rays_per_s": R / res["anyhit"],
        "refl_rays_per_s": R / res["refl_closest"],
        "full_frame_ms": res["full"] * 1e3,
        "colorat_d1_ms": res["colorat_d1_full"] * 1e3,
        "pixels": cam.hsize * cam.vsize,
    }
    print(f"perf_probe: {scene_name} {cam.hsize}x{cam.vsize} at tile {cfg.ray_tile} "
          f"on {device_name(device)}", file=sys.stderr)
    print(json.dumps(res))
    print(json.dumps(rates))
    return dict(stages=res, rates=rates)


@torch.no_grad()
def gather_probe(width: int = 1920, device="cuda") -> dict:
    """The shading's per-ray gathers alone: the winner's normal and object
    (tri_n[idx], tri_obj[idx]) at random rows, and the colors' un-permute."""
    world, cam = REGISTRY["cow"](width)
    scene = compile_scene(world, dtype=torch.float32, device=device)
    R = cam.hsize * cam.vsize
    T = scene.tri_n.shape[0]
    rng = np.random.default_rng(0)
    idx = torch.as_tensor(rng.integers(0, T, size=R), dtype=torch.int64, device=device)
    perm = torch.as_tensor(rng.permutation(R), dtype=torch.int64, device=device)
    colors = torch.ones((R, 3), dtype=torch.float32, device=device)
    t = lambda fn: timeit(fn, device, iters=5)
    out = {"gather_tri_n_ms": t(lambda: torch.sum(scene.tri_n[idx])) * 1e3,
           "gather_tri_obj_ms": t(lambda: torch.sum(scene.tri_obj[idx])) * 1e3,
           "gather_unpermute_ms": t(lambda: torch.sum(colors[perm])) * 1e3,
           "R": R, "T": T}
    print(json.dumps(out))
    return out


def visit_stats(o, d, scene, t_final, label: str, L) -> dict:
    """The clusters K1's ordered walk visits on each ray of (o, d) that
    ends at t_final: counted (k1_visits), against the clusters each ray's
    line enters at all (overlap), with the pair tests they cost and, with
    the kernels' list length L (None: not known), the scans and box tests
    of the ordered walk and of a scan per visit, modelled (walk_census)."""
    st = scene.static
    C, leaf = st.n_clusters, st.cluster_size
    visits = k1_visits(o, d, scene.cluster_aabb, t_final)
    lines = entered(o, d, scene.cluster_aabb, torch.full_like(t_final, 1e30))[0]
    overlap = torch.bincount(lines, minlength=o.shape[0])
    v = visits.double()
    stats = {
        "sweep": label, "rays": o.shape[0], "clusters": C, "leaf": leaf,
        "visits_total": int(visits.sum()),
        "visits_per_ray_mean": float(v.mean()),
        "visits_per_ray_p95": float(torch.quantile(v.cpu(), 0.95)),
        "visits_per_ray_max": int(visits.max()),
        "overlap_per_ray_mean": float(overlap.double().mean()),
        "early_exit_saving": 1.0 - float(visits.sum()) / max(int(overlap.sum()), 1),
        "pair_tests_per_sweep": int(visits.sum()) * leaf,
        "list": L,
    }
    if L is not None:
        model = walk_census(visits, C, L)
        mean = lambda k: float(model[k].double().mean())
        stats.update(scans_per_ray_mean=mean("new_scans"),
                     box_tests_per_ray_mean=mean("new_tests"),
                     scan_per_visit_scans_per_ray_mean=mean("old_scans"),
                     scan_per_visit_box_tests_per_ray_mean=mean("old_tests"))
    print(json.dumps(stats), flush=True)
    return stats


@torch.no_grad()
def visit_sim(width: int = 1920, scene_name: str = "cow", device="cuda") -> list:
    """visit_stats of K1's walk on the primary wavefront and on its
    reflected wavefront (perf_probe.py's construction: lifted 1e-4), each
    ending at its closest hit."""
    scene, cam, cfg = _setup(scene_name, width, device)
    L = mi.walk_list()[0] if torch.device(device).type == "cuda" else None
    o, d = frame_rays(cam, device)
    t = integrator.mesh_closest(scene, o, d, cfg)[0]
    out = [visit_stats(o, d, scene, t, "primary_closest", L)]
    o2, d2, _ = reflected(scene, o, d, cfg, 1e-4)
    t2 = integrator.mesh_closest(scene, o2, d2, cfg)[0]
    out.append(visit_stats(o2, d2, scene, t2, "reflected_closest", L))
    return out


@torch.no_grad()
def kernel_micro(width: int = 1920, device="cuda") -> dict:
    """The closest-hit sweep's cost decomposed: the real primary
    wavefront, an all-sky one (origin far above, straight up: no box
    entered, the launch and cull floor), and halves and quarters of each."""
    scene, cam, cfg = _setup("cow", width, device)
    o, d = frame_rays(cam, device)
    closest = lambda o, d: integrator.mesh_closest(scene, o, d, cfg)
    t = lambda fn: timeit(fn, device) * 1e3
    res = {"R": o.shape[0]}
    res["real_ms"] = t(lambda: closest(o, d))
    o_sky = (torch.zeros_like(o) + torch.tensor([0.0, 100.0, 0.0], device=device))
    d_sky = (torch.zeros_like(d) + torch.tensor([0.0, 1.0, 0.0], device=device))
    res["sky_ms"] = t(lambda: closest(o_sky, d_sky))
    for frac in (2, 4):
        oo, dd = o[::frac].contiguous(), d[::frac].contiguous()
        so, sd = o_sky[::frac].contiguous(), d_sky[::frac].contiguous()
        res[f"real_R/{frac}_ms"] = t(lambda: closest(oo, dd))
        res[f"sky_R/{frac}_ms"] = t(lambda: closest(so, sd))
    print(json.dumps(res))
    return res


def cli(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="rtc_tpu_torch.tools.perf_probe",
                                     description=__doc__.split("\n\n")[0])
    parser.add_argument("width", nargs="?", type=int, default=1920)
    parser.add_argument("--scene", default="cow")
    parser.add_argument("--tile", type=int, default=None)
    parser.add_argument("--device", default="cuda")
    mode = parser.add_mutually_exclusive_group()
    mode.add_argument("--gathers", action="store_true")
    mode.add_argument("--visits", action="store_true")
    mode.add_argument("--kernel-micro", action="store_true")
    args = parser.parse_args(argv)
    if args.gathers:
        gather_probe(args.width, args.device)
    elif args.visits:
        visit_sim(args.width, args.scene, args.device)
    elif args.kernel_micro:
        kernel_micro(args.width, args.device)
    else:
        main(args.width, args.scene, args.device, args.tile)
    return 0


if __name__ == "__main__":
    sys.exit(cli())
