#!/usr/bin/env python3
"""Smoke test of rtc_tpu_torch's main path on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels from rtc_tpu_torch/csrc with nvcc and holds
each against its plain PyTorch version on the card: K1-K3 on the cow
(phases 3-4, with fused against split), K1/K3 with_sn on teapot_smooth
(phase 6, with fused against split) and the K4 census on glass_teapot
(phase 7, exact counts), each at its path's 460,800-ray wavefront; and
the instanced K5 (flat on cow_herd, with_sn on cow_herd_smooth) and K6
(phase 9), timed on the herds' 460,800-ray wavefronts and held against
their plain versions, which sweep every instance densely, on a
57,600-ray subset of them. It renders cow (phase 5), teapot_smooth,
glass_teapot, cow_herd and cow_herd_smooth (phase 8) at 1920x960, depth
5, f32 through render(), counting each kernel's launches in each frame,
and checks each image against the plain render and, where
tests/golden has one, the golden. Each phase prints lines with the
card's name and power limit. Before the last line it prints the kernels'
JSON record (times and max_abs_err from those wavefronts; launches from
the frame that runs each kernel, named in "frame") and the card line;
the last line is {"ok": true, "device": {...}}. Any failure raises and
exits non-zero. Without a CUDA device it exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from rtc_tpu_torch.models.scenes import REGISTRY
from rtc_tpu_torch.ops.kernels import mesh_intersect as mi
from rtc_tpu_torch.ops.vec import normalize, normalize3
from rtc_tpu_torch.render import integrator
from rtc_tpu_torch.render.camera import camera_rays, camera_rays_for_pixels
from rtc_tpu_torch.render.renderer import blocked_pixels, render
from rtc_tpu_torch.scene.compile import compile_scene
from rtc_tpu_torch.scene.materials import Material
from rtc_tpu_torch.scene.shapes import mesh
from rtc_tpu_torch.scene.world import PointLight, World
from rtc_tpu_torch.utils.config import RenderConfig
from rtc_tpu_torch.utils.constants import BIG, FAR
from rtc_tpu_torch.utils.profiling import rays_per_pixel

ROOT = os.path.dirname(os.path.abspath(__file__))
SOURCE = "rtc_tpu_torch/csrc/mesh_intersect.cu"
TPU_KERNELS = "rtc_tpu/ops/pallas/mesh_intersect.py"
WIDTH, HEIGHT, DEPTH = 1920, 960, 5
RAY_TILE = 460800          # the cow shading tile of bench.py
PARITY_RAYS = 10240        # bench.py check_kernel_parity's wavefront
# f32 render budget (tests/test_pallas_mesh.py): 99.9th-percentile error
# below 2e-3 and at most 3 pixels off by more than 0.05
P999_MAX, BIG_ERR, BIG_ERR_PIXELS = 2e-3, 0.05, 3
# The herds' kernel render intersects each instance in its object space,
# the plain render the world-baked table, so f32 rounds hit points
# differently (|dt| up to ~3e-5 at t ~ 40), and a shadow ray that leaves a
# surface only EPSILON = 1e-5 above it re-hits its own triangle ("acne")
# on different pixels in the two: a full shadow flip each. Measured on an
# H100: 30 (cow_herd) and 33 (cow_herd_smooth) of 28,800 pixels at
# 240x120, every one a shadow-flag flip with equal hit, object and t to
# within 3e-5. Budget: the 99th-percentile error below P999_MAX, and at
# most KNIFE_EDGE_SHARE of the pixels above BIG_ERR. The kernels equal
# their plain versions bit for bit (phase 9).
KNIFE_EDGE_SHARE = 0.0025
COW_F32_BUDGET = (0.98, 2)  # tests/test_golden.py F32_BUDGET["cow"]


class SmokeFailure(RuntimeError):
    pass


def check(ok, msg: str) -> None:
    if not ok:
        raise SmokeFailure(msg)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip()


def say(phase: str, msg: str) -> None:
    print(f"[{CARD}] {phase}: {msg}", flush=True)


def timed_ms(fn, warmup: int, iters: int):
    """Mean device time of fn() in ms, from CUDA events around iters calls,
    and the last call's result."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters, out


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def cow_scene(width: int):
    world, cam = REGISTRY["cow"](width)
    return compile_scene(world, dtype=torch.float32, device="cuda"), cam


def soup_scene(rng, n_tris: int = 26000):
    """A random triangle soup of >= 200 clusters, with rays from a sphere
    around it toward random points inside it."""
    centers = rng.uniform(-4.0, 4.0, (n_tris, 3))
    v = [centers + rng.normal(0.0, 0.2, (n_tris, 3)) for _ in range(3)]
    world = World(objects=[mesh(*v, material=Material(reflective=0.2))],
                  light=PointLight((0.0, 6.9, -5.0), (1.0, 1.0, 1.0)))
    scene = compile_scene(world, dtype=torch.float32, device="cuda")
    origin = rng.normal(size=(PARITY_RAYS, 3))
    origin *= 12.0 / np.linalg.norm(origin, axis=1, keepdims=True)
    d = rng.uniform(-4.0, 4.0, (PARITY_RAYS, 3)) - origin
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32, device="cuda")
    return scene, f32(origin), f32(d)


def tables(scene):
    return scene.tri_p1, scene.tri_e1, scene.tri_e2


def occlusion_rays(scene, o, d, t, idx):
    """Free-space occlusion queries (bench.py:84-96): from halfway to each
    hit toward the light, and from the light toward each hit stopping 0.05
    short of it. Misses are dead lanes."""
    hit = idx >= 0
    light = scene.light_pos[None, :]
    t_safe = torch.where(hit, t, 1.0)[:, None]
    half = o + d * (t_safe * 0.5)
    target = o + d * t_safe
    v = torch.cat([light - half, target - light])
    dist = torch.sqrt((v * v).sum(1))
    live = torch.cat([hit, hit])
    margin = torch.cat([torch.zeros_like(t), torch.full_like(t, 0.05)])
    max_t = torch.where(live, dist - margin, -1.0)
    origin = torch.cat([half, light.expand_as(target)]).contiguous()
    return origin, (v / dist[:, None]).contiguous(), max_t.contiguous()


# ---------------------------------------------------------------------------
# gates
# ---------------------------------------------------------------------------

def closest_gate(what: str, got, ref, n_atol: float = 0.0) -> float:
    """bench.py's gate: equal hit masks, |dt| <= 1e-3, index mismatches only
    at ties; the normal is the winner's row (bit-equal at equal idx, or
    within n_atol). Returns max |dt|."""
    t, idx, n = got[:3]
    tr, ir, nr = ref[:3]
    hit = idx >= 0
    check(torch.equal(hit, ir >= 0),
          f"{what}: hit masks differ on {int((hit != (ir >= 0)).sum())} rays")
    check(bool((t[~hit] == tr[~hit]).all()), f"{what}: miss t is not BIG")
    dt = (t - tr).abs()[hit]
    max_dt = float(dt.max()) if dt.numel() else 0.0
    check(max_dt <= 1e-3, f"{what}: closest-hit t diverges, max {max_dt}")
    tie = hit & (idx != ir)
    check(bool(((t - tr).abs()[tie] <= 1e-3).all()),
          f"{what}: the kernel picked a non-closest triangle")
    same = idx == ir
    bad = int(((n[same] - nr[same]).abs() > n_atol).any(1).sum())
    check(bad == 0, f"{what}: normals differ at equal idx on {bad} rays")
    return max_dt


def kernel_parity(name, scene, o, d, leaf, eps):
    """K1, K2 and K3 against their plain versions on one wavefront.
    Returns a summary string."""
    p1, e1, e2 = tables(scene)
    args = (p1, e1, e2, scene.tri_n)
    k1 = mi.mesh_closest_hit(o, d, *args, scene.cluster_aabb, leaf, eps)
    p = mi.closest_hit_plain(o, d, *args, eps)
    err1 = closest_gate(f"{name} K1", k1, p)

    so, sd, max_t = occlusion_rays(scene, o, d, p[0], p[1])
    k2 = mi.mesh_any_hit(so, sd, max_t, p1, e1, e2, scene.cluster_aabb, leaf, eps)
    p2 = mi.any_hit_plain(so, sd, max_t, p1, e1, e2, eps)
    flips2 = int((k2 != p2).sum())
    check(flips2 <= max(2, so.shape[0] // 2048),
          f"{name} K2: occlusion parity: {flips2} rays differ")

    k3 = mi.mesh_closest_shadow(o, d, *args, scene.cluster_aabb,
                                scene.light_pos, leaf, eps)
    p3 = mi.closest_shadow_plain(o, d, *args, scene.light_pos, eps)
    err3 = closest_gate(f"{name} K3", k3, p3)
    hits = int((p3[1] >= 0).sum())
    flips3 = int((k3[3] != p3[3]).sum())
    check(flips3 <= max(2, hits // 1000),
          f"{name} K3: shadow flags differ on {flips3} of {hits} hits")
    torch.cuda.synchronize()
    summary = (f"{name}: {o.shape[0]} rays, C={scene.cluster_aabb.shape[0]}, "
               f"hits {int((k1[1] >= 0).sum())}, K1 max|dt| {err1:.3g}; "
               f"K2 {int(p2.sum())} occluded, {flips2} flips of {so.shape[0]}; "
               f"K3 max|dt| {err3:.3g}, {int(p3[3].sum())} shadowed, "
               f"{flips3} flips")
    return summary


def image_gate(what: str, img, ref, knife_edges: bool = False) -> str:
    """The f32 render budget; knife_edges: the herds' budget (see
    KNIFE_EDGE_SHARE)."""
    err = (img - ref).abs().amax(dim=2).flatten().double()
    q = 0.99 if knife_edges else 0.999
    p = float(torch.quantile(err, q))
    big = int((err > BIG_ERR).sum())
    limit = int(KNIFE_EDGE_SHARE * err.numel()) if knife_edges else BIG_ERR_PIXELS
    check(p < P999_MAX and big <= limit,
          f"{what}: p{q * 100:g} error {p:.3g}, {big} pixels above {BIG_ERR} "
          f"(limit {limit})")
    return (f"p{q * 100:g} err {p:.3g}, {big} px > {BIG_ERR} (limit {limit}) "
            f"of {err.numel()}, max {float(err.max()):.3g}")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_environment() -> None:
    nvcc = subprocess.run([mi.find_nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    try:
        import triton
        triton_version = triton.__version__
    except ImportError:
        triton_version = "not installed (unused)"
    say("1 environment",
        f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, nvcc '{nvcc}', triton {triton_version}, "
        f"{torch.cuda.device_count()} device(s), "
        f"device 0 {torch.cuda.get_device_name(0)}")


def phase_build() -> None:
    t0 = time.perf_counter()
    lib = mi.build()
    mi.library()
    seconds = time.perf_counter() - t0
    with open(lib + ".log") as f:
        ptxas = [ln.strip() for ln in f if "registers" in ln or "spill" in ln]
    say("2 build", f"{os.path.relpath(lib, ROOT)} in {seconds:.1f} s; "
        + " | ".join(ptxas))


MAIN_RAYS = WIDTH * HEIGHT // 4  # main_path_rays' wavefront


def main_path_rays(cam):
    """The first K3 wavefront shape of the main path: 460,800 primary
    rays, block-major, taken every 4th ray across the whole frame."""
    px, py = blocked_pixels(cam.vsize, cam.hsize, "cuda")
    o, d = camera_rays_for_pixels(cam.transform_inverse, px[::4], py[::4],
                                  cam.half_width, cam.half_height,
                                  cam.pixel_size)
    return o.contiguous(), d.contiguous()


def phase_parity(scene, cam, leaf, eps):
    o, d = camera_rays(cam.transform_inverse, cam.hsize, cam.vsize,
                       cam.half_width, cam.half_height, cam.pixel_size,
                       device="cuda")
    step = o.shape[0] // PARITY_RAYS
    o, d = o[::step][:PARITY_RAYS].contiguous(), d[::step][:PARITY_RAYS].contiguous()
    say("3 kernel parity", kernel_parity("cow", scene, o, d, leaf, eps))
    soup, so, sd = soup_scene(np.random.default_rng(0))
    check(soup.static.n_clusters >= 200, "soup has fewer than 200 clusters")
    say("3 kernel parity", kernel_parity("soup", soup, so, sd,
                                         soup.static.cluster_size, eps))


def phase_timing(scene, cam, leaf, eps):
    """Each kernel against its plain version at the main path's shapes:
    the times of both, and the parity gates on the timed calls' outputs.
    Returns {kernel: (ms, plain_ms)} and {kernel: (max_abs_err, flips)}."""
    o, d = main_path_rays(cam)
    p1, e1, e2 = tables(scene)
    t, idx, n = mi.mesh_closest_hit(o, d, p1, e1, e2, scene.tri_n,
                                    scene.cluster_aabb, leaf, eps)
    so, sd, max_t = mi.shadow_rays_plain(o, d, t, idx, n, scene.light_pos, eps)
    so, sd = so.contiguous(), sd.contiguous()
    runs = {
        "closest_hit": (
            lambda: mi.mesh_closest_hit(o, d, p1, e1, e2, scene.tri_n,
                                        scene.cluster_aabb, leaf, eps),
            lambda: mi.closest_hit_plain(o, d, p1, e1, e2, scene.tri_n, eps)),
        "any_hit": (
            lambda: mi.mesh_any_hit(so, sd, max_t, p1, e1, e2,
                                    scene.cluster_aabb, leaf, eps),
            lambda: mi.any_hit_plain(so, sd, max_t, p1, e1, e2, eps)),
        "closest_shadow": (
            lambda: mi.mesh_closest_shadow(o, d, p1, e1, e2, scene.tri_n,
                                           scene.cluster_aabb,
                                           scene.light_pos, leaf, eps),
            lambda: mi.closest_shadow_plain(o, d, p1, e1, e2, scene.tri_n,
                                            scene.light_pos, eps)),
    }
    times, outs = {}, {}
    for name, (kernel, plain) in runs.items():
        # plain, kernel, kernel, plain: both see the same card state
        a, _ = timed_ms(plain, 1, 2)
        b, got = timed_ms(kernel, 2, 10)
        c, _ = timed_ms(kernel, 0, 10)
        e, ref = timed_ms(plain, 0, 2)
        times[name] = ((b + c) / 2, (a + e) / 2)
        outs[name] = (got, ref)

    # the same gates as phase 3, on the outputs of the timed calls
    err1 = closest_gate("main-path K1", *outs["closest_hit"])
    k2, p2 = outs["any_hit"]
    flips2 = int((k2 != p2).sum())
    check(flips2 <= max(2, so.shape[0] // 2048),
          f"main-path K2: occlusion parity: {flips2} rays differ")
    k3, p3 = outs["closest_shadow"]
    err3 = closest_gate("main-path K3", k3, p3)
    hits = int((p3[1] >= 0).sum())
    flips3 = int((k3[3] != p3[3]).sum())
    check(flips3 <= max(2, hits // 1000),
          f"main-path K3: shadow flags differ on {flips3} of {hits} hits")
    parity = {"closest_hit": (err1, None), "any_hit": (float(flips2 > 0), flips2),
              "closest_shadow": (err3, flips3)}
    say("3 kernel timing",
        f"{o.shape[0]} primary rays ({hits} hits, "
        f"{int((max_t > 0).sum())} live shadow rays): " + "; ".join(
            f"{k} {v[0]:.3f} ms vs plain {v[1]:.1f} ms" for k, v in times.items())
        + f"; vs plain: K1 max|dt| {err1:.3g}, K2 {flips2} flips of "
        f"{so.shape[0]}, K3 max|dt| {err3:.3g}, {flips3} shadow flips")
    return times, parity


def split_path(scene, o, d):
    """The split path of one node (fused_shadow=False): K1, then K2 on the
    shadow rays the integrator derives. Returns (hit, shadowed)."""
    cfg = RenderConfig(fused_shadow=False)
    hit = integrator.closest_hit(scene, o, d, cfg)
    comps = integrator.prepare_hit3(scene, o, d, hit, cfg)
    over = torch.stack([torch.where(hit.valid, c, FAR)
                        for c in comps.over_point], 1)
    lvx, lvy, lvz = normalize3(*(scene.light_pos[k] - comps.point[k]
                                 for k in range(3)))
    nx, ny, nz = comps.normalv
    facing = (lvx * nx + lvy * ny + lvz * nz) >= 0.0
    return hit, integrator.is_shadowed(scene, over, cfg, live=hit.valid & facing)


def phase_fused_vs_split(scene, cam, eps):
    """K3 against K1, then K2 on the shadow rays the integrator derives."""
    o, d = main_path_rays(cam)
    leaf = scene.static.cluster_size
    t, idx, n, sh = mi.mesh_closest_shadow(
        o, d, *tables(scene), scene.tri_n, scene.cluster_aabb,
        scene.light_pos, leaf, eps)
    hit, sh_split = split_path(scene, o, d)
    valid = idx >= 0
    check(torch.equal(valid, hit.valid), "fused/split hit masks differ")
    check(torch.equal(t, hit.t), "fused/split t differ")
    check(torch.equal(idx.clamp_min(0), hit.tri), "fused/split idx differ")
    check(torch.equal(n, hit.tri_n), "fused/split normals differ")
    hits = int(valid.sum())
    flips = int((sh != sh_split).sum())
    check(flips <= max(2, hits // 1000),
          f"fused/split shadow flags differ on {flips} of {hits} hits")
    say("4 fused vs split", f"{o.shape[0]} rays, {hits} hits: t, idx, n "
        f"bit-equal; shadow flags differ on {flips} ({int(sh.sum())} shadowed)")


def phase_slice():
    """The main path: render() of the cow frame, fused (the default) then
    split (fused_shadow=False), with each frame's own launch counts; then
    two image checks. Returns {frame: {kernel: launches}}."""
    t0 = time.perf_counter()
    scene, cam = cow_scene(WIDTH)
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    fused = RenderConfig(ray_tile=RAY_TILE)
    split = RenderConfig(ray_tile=RAY_TILE, fused_shadow=False)
    for cfg in (fused, split):  # warm-up
        render(scene, cam, cfg)
    torch.cuda.synchronize()

    walls, images, launches = {}, {}, {}
    for key, cfg in (("fused", fused), ("split", split)):
        mi.reset_launch_counts()
        t0 = time.perf_counter()
        images[key] = render(scene, cam, cfg)
        torch.cuda.synchronize()
        walls[key] = time.perf_counter() - t0
        launches[key] = dict(mi.LAUNCHES)

    n_tiles = -(-WIDTH * HEIGHT // RAY_TILE)
    nodes = n_tiles * 2  # two bounce nodes per tile at depth 5
    none = dict.fromkeys(mi.LAUNCHES, 0)
    expected = {"fused": dict(none, closest_shadow=nodes),
                "split": dict(none, closest_hit=nodes, any_hit=nodes)}
    for key in expected:
        check(launches[key] == expected[key],
              f"{key} frame: launch counts {launches[key]}, "
              f"expected {expected[key]}")
    img = images["fused"]
    check(img.shape == (HEIGHT, WIDTH, 3), f"image shape {tuple(img.shape)}")
    check(bool(torch.isfinite(img).all()), "image has non-finite values")
    check(float(img.min()) >= 0.0 and float(img.amax()) > 0.1,
          "image is black or negative")
    same = float((images["fused"] == images["split"]).all(dim=2).float().mean())
    casts = WIDTH * HEIGHT * rays_per_pixel(DEPTH, scene.static.any_reflective,
                                            False)
    rates = {k: casts / w for k, w in walls.items()}
    say("5 slice",
        f"cow {WIDTH}x{HEIGHT} depth {DEPTH} f32, tile {RAY_TILE}: compile "
        f"{compile_s:.2f} s; fused frame {walls['fused'] * 1e3:.1f} ms = "
        f"{rates['fused'] / 1e6:.1f}M rays/s; split frame "
        f"{walls['split'] * 1e3:.1f} ms = {rates['split'] / 1e6:.1f}M rays/s "
        f"({casts} casts); launches {launches}; fused == split on "
        f"{same:.6f} of pixels")

    small, cam_s = cow_scene(480)
    kern = render(small, cam_s, RenderConfig())
    plain = render(small, cam_s, RenderConfig(mesh_impl="bruteforce"))
    say("5 slice", "480x240 kernels vs plain render on the card: "
        + image_gate("480x240 kernels vs plain", kern, plain))

    golden = np.load(os.path.join(ROOT, "tests", "golden", "cow.npy"))
    tiny, cam_t = cow_scene(golden.shape[1])
    img32 = render(tiny, cam_t, RenderConfig(ray_tile=512)).cpu().numpy()
    q = lambda a: np.clip(np.asarray(a, np.float64) * 255 + 0.5, 0, 255).astype(np.uint8)
    match = float(np.all(q(golden) == q(img32), axis=2).mean())
    flips = int((np.abs(golden - img32).max(axis=2) > 0.15).sum())
    check(match >= COW_F32_BUDGET[0] and flips <= COW_F32_BUDGET[1],
          f"f32 kernels vs f64 golden: match {match:.4f}, flips {flips}")
    say("5 slice", f"width {golden.shape[1]} kernels vs tests/golden/cow.npy "
        f"(f64): 8-bit match {match:.4f}, structural flips {flips}")
    return launches


# ---------------------------------------------------------------------------
# the smooth and glass meshes: K1/K3 with_sn and the K4 crossing census
# ---------------------------------------------------------------------------

SCENES = {}  # name -> (scene on the card, compile seconds)


def slice_scene(name: str, width: int):
    """A registry scene on the card (compiled once per name: the tables do
    not depend on the canvas) and its camera at width."""
    world, cam = REGISTRY[name](width)
    if name not in SCENES:
        t0 = time.perf_counter()
        scene = compile_scene(world, dtype=torch.float32, device="cuda")
        torch.cuda.synchronize()
        SCENES[name] = (scene, time.perf_counter() - t0)
    return SCENES[name][0], cam


def time_pair(kernel, plain, plain_warmup: int = 1, plain_iters: int = 2):
    """Device ms of a kernel and its plain version at one input, in the
    order plain, kernel, kernel, plain; and the last outputs of both."""
    a, _ = timed_ms(plain, plain_warmup, plain_iters)
    b, got = timed_ms(kernel, 2, 10)
    c, _ = timed_ms(kernel, 0, 10)
    e, ref = timed_ms(plain, 0, plain_iters)
    return (b + c) / 2, (a + e) / 2, got, ref


def phase_smooth(eps):
    """K1 and K3 with_sn against their plain versions on teapot_smooth's
    460,800-ray primary wavefront (timed calls' outputs gated as phase 3),
    then fused K3 with_sn against the split path through the integrator."""
    scene, cam = slice_scene("teapot_smooth", WIDTH)
    o, d = main_path_rays(cam)
    tabs = (*tables(scene), integrator.corner_normals(scene))
    leaf = scene.static.cluster_size
    light = scene.light_pos
    ms1, pms1, k1, p1 = time_pair(
        lambda: mi.mesh_closest_hit_sn(o, d, *tabs, scene.cluster_aabb, leaf, eps),
        lambda: mi.closest_hit_sn_plain(o, d, *tabs, eps))
    ms3, pms3, k3, p3 = time_pair(
        lambda: mi.mesh_closest_shadow_sn(o, d, *tabs, scene.cluster_aabb,
                                          light, leaf, eps),
        lambda: mi.closest_shadow_sn_plain(o, d, *tabs, light, eps))
    err1 = closest_gate("teapot_smooth K1 with_sn", k1, p1)
    err3 = closest_gate("teapot_smooth K3 with_sn", k3, p3)
    hits = int((p3[1] >= 0).sum())
    flips3 = int((k3[3] != p3[3]).sum())
    check(flips3 <= max(2, hits // 1000),
          f"teapot_smooth K3 with_sn: shadow flags differ on {flips3} of {hits} hits")
    say("6 smooth kernels",
        f"teapot_smooth {o.shape[0]} primary rays ({hits} hits, C="
        f"{scene.static.n_clusters}): K1 with_sn {ms1:.3f} ms vs plain "
        f"{pms1:.1f} ms, max|dt| {err1:.3g}; K3 with_sn {ms3:.3f} ms vs plain "
        f"{pms3:.1f} ms, max|dt| {err3:.3g}, {flips3} shadow flips "
        f"({int(p3[3].sum())} shadowed)")

    # fused against split: rtc_tpu's split path normalizes the blend with a
    # sum-reduced dot, so the two may differ by an ulp there; the port's
    # split path normalizes as the kernel does. Gate with the parity gate,
    # unit normals within 1e-6, and report what differs.
    t, idx, n, sh = k3
    hit, sh_split = split_path(scene, o, d)
    split = (hit.t, torch.where(hit.valid, hit.tri, -1), hit.tri_n)
    fused = (t, idx, torch.where(hit.valid[:, None], normalize(n), 0.0))
    err = closest_gate("teapot_smooth fused vs split", fused, split, n_atol=1e-6)
    n_diff = int((fused[2] != split[2]).any(1).sum())
    t_diff = int((t != hit.t).sum())
    flips = int((sh != sh_split).sum())
    check(flips <= max(2, hits // 1000),
          f"teapot_smooth fused/split shadow flags differ on {flips} of {hits}")
    say("6 smooth kernels",
        f"fused vs split on {hits} hits: max|dt| {err:.3g}; t differs on "
        f"{t_diff}, unit n on {n_diff}, shadow flags on {flips} rays")
    return ({"closest_hit_sn": (ms1, pms1), "closest_shadow_sn": (ms3, pms3)},
            {"closest_hit_sn": (err1, None), "closest_shadow_sn": (err3, flips3)})


def census_gate(what: str, got, ref) -> tuple:
    """Exact counts; the latest crossing equal where counts agree (so
    everywhere). Returns (max |d last| where any crossing, crossings)."""
    cnt, last = got
    pcnt, plast = ref
    bad = int((cnt != pcnt).any(1).sum())
    check(bad == 0, f"{what}: counts differ on {bad} rays")
    check(torch.equal(last, plast), f"{what}: latest crossings differ")
    some = cnt > 0
    err = float((last - plast).abs()[some].max()) if bool(some.any()) else 0.0
    return err, int(cnt.sum())


def phase_census(eps):
    """K4 against its plain version on glass_teapot's 460,800-ray primary
    wavefront with the main path's inputs (t_hit of the transparent hits,
    -BIG elsewhere; hit_gid of triangle hits, -2 elsewhere), and on the
    same rays re-seated 1e-3 past their hit with t_hit = BIG, so
    negative-t crossings and counts from inside the glass are exercised.
    Both timed; the kernels line takes the main-path input's."""
    scene, cam = slice_scene("glass_teapot", WIDTH)
    o, d = main_path_rays(cam)
    leaf = scene.static.cluster_size
    K = len(scene.static.refr_mesh_obj_ids)
    hit = integrator.closest_hit(scene, o, d, RenderConfig())
    live = hit.valid & (integrator.object_record(scene, hit.obj)["transparency"] > 0.0)
    t_main = torch.where(live, hit.t, -BIG).contiguous()
    g_main = torch.where(hit.is_tri, hit.tri, -2).to(torch.int32).contiguous()
    o2 = (o + d * (torch.where(hit.valid, hit.t, 0.0)[:, None] + 1e-3)).contiguous()
    t_in = torch.full_like(hit.t, BIG)
    g_in = torch.full_like(g_main, -2)
    tabs = tables(scene)
    out = {}
    for key, (oo, tt, gg) in (("main path", (o, t_main, g_main)),
                              ("re-seated", (o2, t_in, g_in))):
        ms, pms, got, ref = time_pair(
            lambda: mi.mesh_crossing_count(oo, d, tt, gg, *tabs,
                                           scene.cluster_aabb, scene.tri_cid,
                                           K, leaf, eps),
            lambda: mi.crossing_count_plain(oo, d, tt, gg, *tabs,
                                            scene.tri_cid, K, eps))
        err, crossings = census_gate(f"glass_teapot K4 {key}", got, ref)
        out[key] = (ms, pms, err, crossings, int((tt > -BIG).sum()))
    say("7 census", f"glass_teapot {o.shape[0]} primary rays, K={K}, "
        f"{int(live.sum())} transparent hits: " + "; ".join(
            f"{k}: {v[4]} live lanes, {v[3]} crossings, K4 {v[0]:.3f} ms vs "
            f"plain {v[1]:.1f} ms, 0 count mismatches, max|d last| {v[2]:.3g}"
            for k, v in out.items()))
    ms, pms, err = out["main path"][:3]
    return ({"crossing_count": (ms, pms)},
            {"crossing_count": (max(err, out["re-seated"][2]), 0)})


# the slice's frames: each kernel of the scene's path, launches per frame
FRAME_KERNELS = {
    "teapot_smooth": lambda tiles: {"closest_shadow_sn": tiles},
    # root node + its reflected and refracted children; census at the root
    "glass_teapot": lambda tiles: {"closest_hit_sn": 3 * tiles,
                                   "any_hit": 3 * tiles,
                                   "crossing_count": tiles},
    # instanced and not reflective: one node per tile, K5 then K6
    "cow_herd": lambda tiles: {"closest_hit_tlas": tiles,
                               "any_hit_tlas": tiles},
    "cow_herd_smooth": lambda tiles: {"closest_hit_tlas_sn": tiles,
                                      "any_hit_tlas": tiles},
}
# tests/test_golden.py: (width, depth) and F32_BUDGET; the herds have none
GOLDEN_SPECS = {"teapot_smooth": (24, 5, (0.99, 2)),
                "glass_teapot": (24, 8, (0.99, 0))}
# the kernels-vs-plain image gate's canvas width: the herds' plain render
# sweeps the whole 523,264-row world table for every ray
GATE_WIDTHS = {"cow_herd": 240, "cow_herd_smooth": 240}


def phase_frames():
    """render() of teapot_smooth, glass_teapot, cow_herd and
    cow_herd_smooth at 1920x960, depth 5, f32: each frame run with the
    counts set to 0 just before it and read just after; then the 480x240
    (herds: 240x120) kernel render against the plain render and, where
    tests/golden has the scene, the golden-width kernel render against it.
    Returns {scene: {kernel: launches}}."""
    launches = {}
    n_tiles = -(-WIDTH * HEIGHT // RAY_TILE)
    q = lambda a: np.clip(np.asarray(a, np.float64) * 255 + 0.5, 0, 255).astype(np.uint8)
    for name, want in FRAME_KERNELS.items():
        scene, cam = slice_scene(name, WIDTH)
        compile_s = SCENES[name][1]
        cfg = RenderConfig(ray_tile=RAY_TILE)
        render(scene, cam, cfg)  # warm-up
        walls = []
        for _ in range(3):
            mi.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            img = render(scene, cam, cfg)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            counts = dict(mi.LAUNCHES)
            expected = dict(dict.fromkeys(mi.LAUNCHES, 0), **want(n_tiles))
            check(counts == expected,
                  f"{name} frame: launch counts {counts}, expected {expected}")
        launches[name] = counts
        check(img.shape == (HEIGHT, WIDTH, 3), f"{name}: image shape {tuple(img.shape)}")
        check(bool(torch.isfinite(img).all()), f"{name}: non-finite values")
        check(float(img.min()) >= 0.0 and float(img.amax()) > 0.1,
              f"{name}: image is black or negative")
        st = scene.static
        casts = WIDTH * HEIGHT * rays_per_pixel(DEPTH, st.any_reflective,
                                                st.any_refractive)
        wall = sorted(walls)[1]
        say("8 slice frames",
            f"{name} {WIDTH}x{HEIGHT} depth {DEPTH} f32, tile {RAY_TILE}: "
            f"compile {compile_s:.2f} s; frame median {wall * 1e3:.1f} ms of "
            f"[{', '.join(f'{w * 1e3:.1f}' for w in walls)}] = "
            f"{casts / wall / 1e6:.1f}M rays/s ({casts} casts); launches "
            f"{ {k: v for k, v in counts.items() if v} }")

        gw = GATE_WIDTHS.get(name, 480)
        small, cam_s = slice_scene(name, gw)
        kern = render(small, cam_s, RenderConfig())
        plain = render(small, cam_s, RenderConfig(mesh_impl="bruteforce"))
        gate = image_gate(f"{name} {gw}x{gw // 2} kernels vs plain", kern,
                          plain, knife_edges=bool(scene.static.tlas_n_inst))
        if name not in GOLDEN_SPECS:
            say("8 slice frames",
                f"{name}: {gw}x{gw // 2} kernels vs plain render: {gate}")
            continue
        width, depth, (min_frac, flip_budget) = GOLDEN_SPECS[name]
        golden = np.load(os.path.join(ROOT, "tests", "golden", f"{name}.npy"))
        tiny, cam_t = slice_scene(name, width)
        img32 = render(tiny, cam_t, RenderConfig(ray_tile=512, max_depth=depth)
                       ).cpu().numpy()
        match = float(np.all(q(golden) == q(img32), axis=2).mean())
        flips = int((np.abs(golden - img32).max(axis=2) > 0.15).sum())
        check(match >= min_frac and flips <= flip_budget,
              f"{name} f32 kernels vs f64 golden: match {match:.4f}, flips {flips}")
        say("8 slice frames",
            f"{name}: {gw}x{gw // 2} kernels vs plain render: {gate}; width {width} "
            f"depth {depth} kernels vs tests/golden/{name}.npy (f64): 8-bit "
            f"match {match:.4f}, structural flips {flips}")
    return launches


# ---------------------------------------------------------------------------
# instanced meshes: K5 (flat and with_sn) and K6
# ---------------------------------------------------------------------------

# every 8th ray of the 460,800-ray wavefront: the plain versions sweep all
# 90 instances' rows for every ray (5.5e5 pair tests a ray)
TLAS_PLAIN_STEP = 8


def phase_tlas(eps):
    """K5 flat on cow_herd, K5 with_sn on cow_herd_smooth, and K6 on
    cow_herd's free-space occlusion rays: each kernel timed on the full
    460,800-ray primary wavefront (K6: its 921,600 occlusion rays), then
    timed with its plain version on every 8th ray of it, and the two held
    to the parity gate there (max |dt| expected 0). Returns
    ({kernel: (ms, plain_ms)}, {kernel: (max_abs_err, flips)},
    {kernel: sizes})."""
    times, parity, sizes = {}, {}, {}
    for name in ("cow_herd", "cow_herd_smooth"):
        scene, cam = slice_scene(name, WIDTH)
        st, tl = scene.static, scene.tlas
        check((st.tlas_n_inst, st.tlas_n_mesh, st.tlas_cm) == (96, 1, 48),
              f"{name}: TLAS tables {st.tlas_n_inst} instances, "
              f"{st.tlas_n_mesh} meshes, cm {st.tlas_cm}")
        key = "closest_hit_tlas_sn" if st.tlas_sn else "closest_hit_tlas"
        kernel = getattr(mi, f"mesh_{key}")
        plain = getattr(mi, f"{key}_plain")
        pay = tl.sn if st.tlas_sn else tl.n
        inst = (tl.inst_ab, tl.inst_aabb, tl.inst_mesh)
        leaf_cm = (st.cluster_size, st.tlas_cm, eps)
        o, d = main_path_rays(cam)
        os_, ds_ = (x[::TLAS_PLAIN_STEP].contiguous() for x in (o, d))
        k5 = lambda oo, dd: kernel(oo, dd, tl.p1, tl.e1, tl.e2, pay, tl.caabb,
                                   *inst, tl.inst_obj, *leaf_cm)
        ms_full, full = timed_ms(lambda: k5(o, d), 2, 10)
        ms, pms, got, ref = time_pair(
            lambda: k5(os_, ds_),
            lambda: plain(os_, ds_, tl.p1, tl.e1, tl.e2, pay, *inst,
                          tl.inst_obj, *leaf_cm),
            plain_warmup=0, plain_iters=1)
        check(all(torch.equal(a[::TLAS_PLAIN_STEP], b) for a, b in zip(full, got)),
              f"{name} K5: the subset's outputs differ from the full run's")
        err = closest_gate(f"{name} K5", (got[0], got[1], got[3]),
                           (ref[0], ref[1], ref[3]))
        same = got[1] == ref[1]
        check(torch.equal(got[2][same], ref[2][same]),
              f"{name} K5: object ids differ at equal enc")
        hits = int((ref[1] >= 0).sum())
        times[key], parity[key] = (ms_full, pms), (err, None)
        sizes[key] = dict(rays=o.shape[0], plain_rays=os_.shape[0],
                          ms_at_plain_rays=ms)
        summary = (f"{name} ({st.tlas_n_inst} instances, cm {st.tlas_cm}): "
                   f"K5{' with_sn' if st.tlas_sn else ''} {ms_full:.3f} ms on "
                   f"{o.shape[0]} rays ({int((full[1] >= 0).sum())} hits); on "
                   f"{os_.shape[0]} rays {ms:.3f} ms vs plain {pms:.1f} ms, "
                   f"{hits} hits, max|dt| {err:.3g}, "
                   f"{int((~same).sum())} enc mismatches")
        if not st.tlas_sn:
            k6 = lambda so, sd, mt: mi.mesh_any_hit_tlas(
                so, sd, mt, tl.p1, tl.e1, tl.e2, tl.caabb, *inst, *leaf_cm)
            fo, fd, fmax = occlusion_rays(scene, o, d, full[0], full[1])
            so, sd, smax = occlusion_rays(scene, os_, ds_, ref[0], ref[1])
            ms6_full, _ = timed_ms(lambda: k6(fo, fd, fmax), 2, 10)
            ms6, pms6, k6_out, p6_out = time_pair(
                lambda: k6(so, sd, smax),
                lambda: mi.any_hit_tlas_plain(so, sd, smax, tl.p1, tl.e1,
                                              tl.e2, *inst, *leaf_cm),
                plain_warmup=0, plain_iters=1)
            flips = int((k6_out != p6_out).sum())
            check(flips <= max(2, so.shape[0] // 2048),
                  f"{name} K6: occlusion parity: {flips} rays differ")
            times["any_hit_tlas"] = (ms6_full, pms6)
            parity["any_hit_tlas"] = (float(flips > 0), flips)
            sizes["any_hit_tlas"] = dict(rays=fo.shape[0],
                                         plain_rays=so.shape[0],
                                         ms_at_plain_rays=ms6)
            summary += (f"; K6 {ms6_full:.3f} ms on {fo.shape[0]} occlusion "
                        f"rays ({int((fmax > 0).sum())} live); on "
                        f"{so.shape[0]} rays {ms6:.3f} ms vs plain "
                        f"{pms6:.1f} ms, {int(p6_out.sum())} occluded, "
                        f"{flips} flips")
        say("9 instanced kernels", summary)
    return times, parity, sizes


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    global CARD
    CARD = card()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_environment()
    phase_build()
    eps = RenderConfig().epsilon
    scene, cam = cow_scene(WIDTH)
    leaf = scene.static.cluster_size
    phase_parity(scene, cam, leaf, eps)
    times, parity = phase_timing(scene, cam, leaf, eps)
    phase_fused_vs_split(scene, cam, eps)
    launches = phase_slice()
    for phase in (phase_smooth, phase_census):
        t, p = phase(eps)
        times.update(t)
        parity.update(p)
    launches.update(phase_frames())
    t, p, sizes = phase_tlas(eps)
    times.update(t)
    parity.update(p)

    # each kernel's launches come from the frame that runs it: K3 from the
    # cow's default fused frame, K1 and K2 from its fused_shadow=False
    # frame, K3 with_sn from teapot_smooth's, K1 with_sn and K4 from
    # glass_teapot's, K5 and K6 from cow_herd's, K5 with_sn from
    # cow_herd_smooth's. "ms" is at "rays" and "plain_ms" at "plain_rays"
    # (the same count, except for K5 and K6)
    lines = {"closest_hit": ("K1 closest hit", 413, "split"),
             "any_hit": ("K2 any-hit occlusion", 861, "split"),
             "closest_shadow": ("K3 fused closest hit + shadow", 720, "fused"),
             "closest_hit_sn": ("K1 closest hit, with_sn", 413, "glass_teapot"),
             "closest_shadow_sn": ("K3 fused closest hit + shadow, with_sn",
                                   720, "teapot_smooth"),
             "crossing_count": ("K4 crossing census", 643, "glass_teapot"),
             "closest_hit_tlas": ("K5 instanced closest hit", 978, "cow_herd"),
             "closest_hit_tlas_sn": ("K5 instanced closest hit, with_sn", 978,
                                     "cow_herd_smooth"),
             "any_hit_tlas": ("K6 instanced any-hit occlusion", 1169,
                              "cow_herd")}
    record = {"kernels": [
        {"name": label, "route": "cuda", "source": SOURCE,
         "replaces": f"{TPU_KERNELS}:{line}", "frame": frame,
         "launches": launches[frame][key], "max_abs_err": parity[key][0],
         "flips": parity[key][1], "ms": times[key][0],
         "plain_ms": times[key][1],
         **sizes.get(key, dict(rays=MAIN_RAYS, plain_rays=MAIN_RAYS))}
        for key, (label, line, frame) in lines.items()]}
    print(json.dumps(record))
    print(f"card: {CARD}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


CARD = "no card"

if __name__ == "__main__":
    sys.exit(main())
