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
their plain versions, which sweep every instance densely, on every 8th
ray of them; K6 on two wavefronts, cow_herd's 921,600 free-space
occlusion rays and the 460,800 shadow rays its frame casts from its
surfaces, its flags equal to the plain version's on every ray of the
subset. Phases 3 and 6 also hold K3's shadow flags equal, on every ray,
to K2's on K3's own shadow rays, and phases 3, 7 and 11 K2's flags to
K7b's, whose tile walk (the world table in table order, a block of rays
at a time) shares no table with K2's occlusion walk.
Phase 3 prints K3's phases 2-3 alone (K3 less K1 on one wavefront).
K2's, K3's, K4's and K6's bound is the lesser of two: the tests their
walk needs, and those of the table-order loop it replaced, which their
lines keep beside it. Phase 7 also times K2 on glass_teapot's surface
shadow rays. Phase 10 holds the elementwise kernels K7a and K7b on cow's
and cow_herd's world-table wavefronts to their plain versions on a
subset and to one K1/K2 launch on every ray; phase 11 checks K1's t0
contract, the superblock drivers (streamed K1, K2 and K4 against one
launch, at 2 clusters a block) and, on the 90-cow herd baked into one
mesh leaf (11 superblocks), streamed K1 t0 and K1 uv against K7a on
every ray, and times streamed K2 against one launch on the herd's
surface shadow rays. It renders cow (phase 5), teapot_smooth, glass_teapot,
cow_herd and cow_herd_smooth (phase 8), and the new routes (phase 12:
cow and cow_herd under mesh_impl="elementwise", the one-mesh herds
streamed, teapot and pumpkin) at 1920x960 (the smooth one-mesh herd at
480x240), depth 5, f32 through render(), counting each kernel's
launches in each frame, and checks each image against the plain render
and, where tests/golden has one, the golden. Phase 8 also holds the prim
kernel (mi.prim_closest, mi.prim_any) to its plain version, bit for bit,
on the six calls of one glass_teapot frame at 1920x960 and the default
tile, and times each call against the plain version and its bound; the
kernels' record takes its two lines. Phase 13 runs the gradient
path (render/integrator.py's autograd Functions, diff.render_grad): the
cow frame's loss_and_grad in 4 tiles through K3 (8 launches under
autograd) against the whole frame in one call, the split route and
central finite differences, three Adam steps whose loss falls, a profiled
step, each of the eight Functions with its kernel against autograd through
the dense plain sweep, and K3 after inject_params moves triangles; it
prints a "grads" JSON line before the kernels' record. Phase 14 runs the
port's entry point as a user does: `python -m rtc_tpu_torch` in a
subprocess (cow at 1920 with --ray-tile 460800 --report, glass_teapot at
1920), each run's exit code 0 and its PPM (header, line width, values)
held to render() of the same scene and config here, bit for bit after
quantization or under the knife-edge budget with the count printed; the
PPM writers (C++ and Python) timed on the cow frame; the CLI's main path
(cow at the default tile) called in this process with its K3 launches
counted; the cow's render_with_checkpoints frame (K3 counted) against
render(); and the six prim-only scenes at their golden widths under
tests/test_golden.py's F32_BUDGET and at width 1920 timed (median of 7,
peak memory, the prim kernel's launches counted, the image bit-equal to
the plain render). It prints a "cli" JSON line after the
"grads" line. Phase 15 runs rtc_tpu_torch.parallel: grids of ranks, each
a process of this script (--parallel-worker) on the one card, the kernels
built once by this process first. Cow at 1920x960 on a 2x2 grid over gloo
(rays dealt over 'rays', the triangle table cut in two over 'prims', K1
and K2 on each shard's own tables, the hits combined by least t and the
occlusion ORed) and glass_teapot on a 1x2 grid (K1 with_sn, K2, and K4's
census summed over the shards), each rank's image held to the single-rank
render() under the knife-edge budget, its launches counted from a frame
run with the counts set to 0 just before it, its frame timed beside the
single-rank frame; on one glass_teapot tile the sharded closest hit and
the reduced K4 counts against one K1 and one K4 on the whole table,
exactly; train_step_multihost on 2 ranks against the single-rank
loss_and_grad; and a 1x1 grid on NCCL whose render_sharded equals
render() bit for bit. It prints a "parallel" JSON line after the "cli"
line, and the K1, K2, K1 with_sn and K4 lines of the kernels' record gain
"sharded_launches" (per rank, for each grid). Phase 16 runs the book API
(rtc_tpu_torch.testing, intersect_all, hit_index): hit_index(intersect_all
(k=8)) on the cow's 460,800-ray main-path wavefront in tiles of 8,192 rays
(wall time, peak memory), held to one K1 with_n launch on every ray with
the bit-equal rays counted; on default_world's 1920x1920 primary frame
in f32 and f64 against closest_hit, exactly (the rays from camera_rays
on a camera matrix on the card); the book's world numbers through the
testing helpers in f64 on the card (color_at, six shade_hit cases, the
refracted ray, three Schlick cases) at each book test's tolerance; and
color_at_single in f32 on 64 cow pixels against render()'s pixels, bit
for bit, and is_shadowed on 64 cow surface points against one K2 launch,
with the K3 and K2 launches the helpers made counted from counts set to
0 just before (K3's and K2's lines gain "book_launches"). It prints a
"book" JSON line after the "parallel" line. Phase 17 runs the tools
(rtc_tpu_torch/tools) as a user does: `python -m rtc_tpu_torch.tools.bench
1920` in a subprocess (cow with the kernel parity gate, then the suite:
one stdout line shaped like bench.py's, the card's name in its metric),
tools.perf_probe on cow at 1920 (the stages, and K1's visits on the
primary and reflected wavefronts), tools.kernel_sweep at its defaults
(leaf 64, 128, 256 x 64, 128, 256 threads a block, K1's t bit-equal to
plain at every pair before it is timed), the cow frame at leaf 64 and 256
(K3 fused, then K1 + K2 split, each kernel counted) and at those leaves
the routes of K1 with_sn, K2 and K4 (glass_teapot), K5 with_sn and K6
(cow_herd_smooth), K7a and K7b (cow, elementwise) and the streamed K1 t0
and K2 (the one-mesh herd), each under the f32 image budget (the herds'
knife-edge budget) against leaf 128, graft_entry.entry() and
graft_entry.dryrun_multichip(4) (four gloo ranks on the card, every gate
of __graft_entry__.py); it prints a "tools" JSON line after the "book"
line. Phase 18 runs the compiled frame (rtc_tpu_torch/render/compiled.py):
for cow, teapot, teapot_smooth, pumpkin, glass_teapot, cow_herd,
cow_herd_smooth, table and cow under mesh_impl="elementwise" at 1920x960
and the default tile, the route render() takes (each graphed), the
graphed frame (the first call's eager run and capture, then a replay)
bit-equal to the eager frame (compiled.eager()), a replay's kernel
launches equal to the eager frame's, a second camera on the same canvas
replayed with no new capture and bit-equal to its own eager frame, the
capture's seconds, the eager and graphed frames timed in turns (7 each,
medians) and their peak memory with the graph's pool; the cow frame's
device busy share under torch.profiler, eager and graphed; and the
progressive cow frame at tile 8,192, eager and graphed, every tile
bit-equal. It prints a "compiled" JSON line after the "tools" line.
Phase 19 runs the compiled gradient step (render/compiled.py step_route,
diff/render_grad.py): on the cow frame at 1920x960, depth 5, f32, with
DEFAULT_PARAMS, loss_and_grad in 4 tiles of 460,800 rays (one capture,
then replays with the other tiles' values) and of the whole frame in one
call, fused K3 and split K1 + K2, each graphed result bit-equal to the
eager one (compiled.eager()) or, where eager runs differ, within twice
their spread, with central finite differences on the graphed gradients;
5 Adam steps (capturable=True) graphed and eager on one trajectory, the
loss falling at each; loss_and_grad and the step timed eager and graphed
in turns (7 each, medians), with the captures, first calls, pools and
the step's device busy share under torch.profiler; a traced replay's
kernels by name against the eager step's; loss_and_grad at 480x240 on
teapot_smooth, glass_teapot, cow_herd, cow_herd_smooth and cow under
mesh_impl="elementwise", every autograd Function but the streamed
KernelClosestUv applied inside a capture; the eager routes (triangle
rows among the parameters, an Adam with capturable=False, eager()); and
K3's backward on 460,800 rays timed with the misses' stand-in rows spread
and on row 0 against the nonzero backward it replaced. It prints a
"compiled_grads" JSON line after the "compiled" line. Phase 13's
tri_p1 parameters and default Adam take the eager route by rule, which
it asserts.
Phases 1-17 render() on the graphed route too, where the frame's route
is graphed. Phase 2 prints the ordered
walk's list lengths and the registers, memory and resident blocks of the
kernels that walk (K1-K6); phases 3, 6, 9 and 11 print the boxes
each ray visits (median, 99th percentile, maximum: clusters, and for K5
instances) and the scans and box tests a ray of the ordered walk against
a scan per visit, modelled from those visits. Each phase prints lines
with the card's name and power limit. Before the last line it prints the
kernels' JSON record (times and max_abs_err from those wavefronts;
launches from the frame that runs each kernel, named in "frame") and the
card line; the last line is {"ok": true, "device": {...}}. Any failure raises and
exits non-zero. Without a CUDA device it exits non-zero and prints no
result.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import io
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

from rtc_tpu_torch import Camera, default_world, testing
from rtc_tpu_torch.diff import render_grad as RG
from rtc_tpu_torch.models.scenes import REGISTRY, TEST_WORLDS
from rtc_tpu_torch.ops import transforms as X
from rtc_tpu_torch.ops.kernels import mesh_intersect as mi
from rtc_tpu_torch.ops.vec import normalize, normalize3
from rtc_tpu_torch.render import compiled, integrator
from rtc_tpu_torch.render.camera import camera_rays, camera_rays_for_pixels
from rtc_tpu_torch.render.renderer import blocked_pixels, render
from rtc_tpu_torch.scene.compile import GROUP, compile_scene
from rtc_tpu_torch.scene.materials import Material, test_pattern
from rtc_tpu_torch.scene.shapes import glass_sphere, mesh, plane, sphere
from rtc_tpu_torch.scene.world import PointLight, World
from rtc_tpu_torch.tools import graft_entry, kernel_sweep, perf_probe
from rtc_tpu_torch.tools.walk import (block_census, entered, k1_walk_line, walk_census,
                                     walk_line)
from rtc_tpu_torch.utils.config import RenderConfig
from rtc_tpu_torch.utils.constants import BIG, FAR, VMEM_TRI_BUDGET
from rtc_tpu_torch.utils import profiling
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


DEVICE_MS = {}  # kernel key -> device_ms() of the call its "ms" times
# a spin of ~25 ms at the card's clock, longer than the host takes to queue
# a timed run's calls
SPIN_CYCLES = 50_000_000


def device_ms(fn, iters: int = 10, tries: int = 3):
    """Mean device time of a call of fn() with the host's dispatch hidden:
    CUDA events around iters calls that the host queues behind a spin
    kernel (torch.cuda._sleep), so that the device runs them back to back
    once the spin ends. timed_ms also holds the dispatch where it outlasts
    a short kernel. None when the host did not queue every call before the
    spin ended in any of tries runs: a call that waits on the device (a
    streaming driver's block order) cannot be hidden so."""
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        spun, start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        spun.record()
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        queued_ms = (time.perf_counter() - t0) * 1e3
        stop.record()
        torch.cuda.synchronize()
        if queued_ms < spun.elapsed_time(start):
            return start.elapsed_time(stop) / iters
    return None


def shown(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


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


def k3_shadow_rays(scene, o, d, eps, hit=None, unit_n: bool = True):
    """K3's phase-2 shadow rays from the closest hits hit = (t, idx, n) of
    rays (o, d) (K1's, launched here, when None): shadow_rays_plain, which
    rounds as K3's phase 2 (unit_n=False: a smooth blend, normalized first)."""
    if hit is None:
        hit = mi.mesh_closest_hit(o, d, *tables(scene), scene.tri_n, scene.cluster_aabb,
                                  scene.static.cluster_size, eps)
    so, sd, max_t = mi.shadow_rays_plain(o, d, *hit[:3], scene.light_pos, eps,
                                         unit_n=unit_n)
    return so.contiguous(), sd.contiguous(), max_t.contiguous()


# ---------------------------------------------------------------------------
# gates
# ---------------------------------------------------------------------------

def k3_flags_gate(what: str, k3_flags, k2_flags, max_t) -> None:
    """K3's shadow flags equal, on every ray, K2's on K3's phase-2 shadow
    rays (k3_shadow_rays). A flag is the OR of pair tests that K3's phase 3
    and K2 compute alike, so a culled hit is the only way they can differ."""
    flips = int((k3_flags != k2_flags).sum())
    check(flips == 0, f"{what}: K3's shadow flags differ from K2's on {flips} of "
          f"{int((max_t > 0).sum())} live shadow rays")


def k2_table_order_gate(what: str, scene, k2_flags, o, d, max_t, eps) -> None:
    """K2's flags equal, on every ray, K7b's: its tile walk over the world
    table in table order (supers, clusters, rows; a block's vote, staged
    rows, a warp a ray) is another independent structure computing the same
    flags, and reads none of the occlusion tables K2 walks."""
    k7b = mi.mesh_any_hit_elementwise(o, d, max_t, *tables(scene), scene.cluster_aabb,
                                      scene.super_aabb, scene.static.cluster_size, eps)
    flags_gate(f"{what} vs the table-order loop (K7b)", k2_flags, k7b, exact=True)


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
    k2 = mi.mesh_any_hit(so, sd, max_t, p1, e1, e2, scene.cluster_aabb, leaf, eps,
                         occ=scene.occ)
    p2 = mi.any_hit_plain(so, sd, max_t, p1, e1, e2, eps)
    flips2 = int((k2 != p2).sum())
    check(flips2 <= max(2, so.shape[0] // 2048),
          f"{name} K2: occlusion parity: {flips2} rays differ")
    k2_table_order_gate(f"{name} K2", scene, k2, so, sd, max_t, eps)

    k3 = mi.mesh_closest_shadow(o, d, *args, scene.cluster_aabb,
                                scene.light_pos, leaf, eps, occ=scene.occ)
    p3 = mi.closest_shadow_plain(o, d, *args, scene.light_pos, eps)
    err3 = closest_gate(f"{name} K3", k3, p3)
    hits = int((p3[1] >= 0).sum())
    flips3 = int((k3[3] != p3[3]).sum())
    check(flips3 <= max(2, hits // 1000),
          f"{name} K3: shadow flags differ on {flips3} of {hits} hits")
    s3o, s3d, s3max = k3_shadow_rays(scene, o, d, eps, k3)
    k3_flags_gate(f"{name} K3", k3[3],
                  mi.mesh_any_hit(s3o, s3d, s3max, p1, e1, e2, scene.cluster_aabb, leaf, eps,
                                  occ=scene.occ), s3max)
    torch.cuda.synchronize()
    summary = (f"{name}: {o.shape[0]} rays, C={scene.cluster_aabb.shape[0]}, "
               f"hits {int((k1[1] >= 0).sum())}, K1 max|dt| {err1:.3g}; "
               f"K2 {int(p2.sum())} occluded, {flips2} flips of {so.shape[0]}, 0 "
               "against the table-order loop; "
               f"K3 max|dt| {err3:.3g}, {int(p3[3].sum())} shadowed, "
               f"{flips3} flips against plain, 0 against K2 on its shadow rays")
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
# bounds: the least time the card could take for a kernel's work
# ---------------------------------------------------------------------------
#
# bound_ms = max(operation time, bytes / HBM_RATE). The bytes are those
# the function must move (each input read once, each output written once).
# The operations are those of the box and pair tests THESE inputs need,
# counted on the card from the wavefront itself, by type: FP32 add, sub and
# mul (FLOPs); FP32 compare, min and max (abs is a free operand modifier);
# reciprocals. Rates for an H100 SXM at its 700 W limit, 132 SMs at 1.98
# GHz: NVIDIA's data sheet gives 67 TFLOP/s, which counts an FMA as two
# FLOPs (128 FP32 lanes a clock an SM), so FLOPs over it assume every mul
# fuses with an add; the CUDA C++ Programming Guide's throughput table for
# compute capability 9.0 gives 64 compares/min/max and 16 reciprocals
# (MUFU) a clock an SM. The operation time is the largest of the three
# units' times and the dispatch time (one instruction a lane a clock:
# FLOPs / 2 + compares + reciprocals).

FP32_PEAK = 67e12              # FLOP/s, an FMA counted as two
INSTR_RATE = FP32_PEAK / 2     # instructions/s
CMP_RATE = 132 * 64 * 1.98e9   # compares, min, max /s
RCP_RATE = 132 * 16 * 1.98e9   # reciprocals/s
HBM_RATE = 3.35e12             # bytes/s
# Operations as (FLOPs, compares, reciprocals). tri_hit
# (csrc/mesh_intersect.cu) by where it stops: the det guard (h 9 and det 5
# FLOPs, |det| >= eps), u (1/det, s 3, u 6, two compares), v (q 9, v 6,
# u + v 1, two compares), or t (t 6 and the caller's t >= 0 and t < bound)
STAGES = ("det", "u", "v", "t")
PAIR_OPS = np.array([[14, 1, 0], [23, 3, 1], [39, 5, 1], [45, 7, 1]], float)
PAIR_CHUNK = 1 << 22  # pair tests per counting pass


class Work:
    """A kernel's needed work: operations by type (FLOPs, compares,
    reciprocals), its pair tests by the stage where they stop, and its box
    tests."""

    def __init__(self, ops=(0, 0, 0), stages=(0, 0, 0, 0), boxes=0):
        self.ops = np.asarray(ops, dtype=float)
        self.stages = np.asarray(stages, dtype=np.int64)
        self.boxes = int(boxes)

    @staticmethod
    def pairs(stages) -> "Work":
        stages = np.asarray(stages, dtype=np.int64)
        return Work(stages.astype(float) @ PAIR_OPS, stages)

    def __add__(self, other: "Work") -> "Work":
        return Work(self.ops + other.ops, self.stages + other.stages,
                    self.boxes + other.boxes)

    def __mul__(self, n) -> "Work":
        return Work(self.ops * float(n), self.stages * int(n), self.boxes * int(n))


# a ray's slab test of one box (three axes of 2 sub, 2 mul and 4 min/max)
# and cluster_entry's three compares with the caller's one (the occlusion
# walk's enters: three compares); the census's signed test has two
BOX = Work((12, 16, 0), boxes=1)
SIGNED_BOX = Work((12, 14, 0), boxes=1)
# the box's own emptiness test, scale, pad and widening: once per box
WIDEN = Work((7, 8, 0))
# make_ray's slab reciprocals and near-zero guards: once per ray
RAY = Work((0, 3, 3))
# instance_ray: o' 18 and d' 15 FLOPs, then make_ray
INSTANCE = Work((33, 3, 3))


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# the shading stages' launch counts (mi.LAUNCHES keys)
SHADE_STAGES = ("shade_surface", "shade_node", "shade_blend")


def shading(nodes: int, blends: int, surfaces: int | None = None) -> dict:
    """The shading stages' launches of a frame: a node launch a shaded
    node, a surface launch a node that K3 does not give the shadow flag
    (surfaces; default every node), a blend launch a node that branches."""
    return {"shade_surface": nodes if surfaces is None else surfaces,
            "shade_node": nodes, "shade_blend": blends}


def live_bytes(live, *tensors) -> int:
    """The bytes of the rows of tensors (R, ...) on the lanes where live
    (R,) holds. An any-hit or census lane that is dead (max_t <= 0, t_hit
    <= -BIG) has its output fixed by that value alone, so the function
    needs its ray (and hit row) only on a live lane."""
    n = int(live.sum())
    return sum(n * (t.numel() // max(t.shape[0], 1)) * t.element_size() for t in tensors)


# the occlusion tables' fields the occlusion walk reads, and those the
# census walk reads besides its boxes and rows
WALK_FIELDS = ("rows", "sub_box", "cluster_box", "group_box", "inst_perm", "inst_box",
               "inst_group")
CENSUS_FIELDS = ("rows", "sub_box", "cluster_box", "group_box", "row_id", "row_cid",
                 "cluster_census", "group_census")


def occ_bytes(occ, fields=WALK_FIELDS) -> int:
    """The bytes of the occlusion tables a walk reads."""
    return nbytes(*(getattr(occ, k) for k in fields))


def bound(work: Work, n_bytes: float):
    """(bound_ms, bound_by, pair tests by stage) of a kernel's work."""
    flops, cmp, rcp = work.ops
    t_ops = max(flops / FP32_PEAK, cmp / CMP_RATE, rcp / RCP_RATE,
                (flops / 2 + cmp + rcp) / INSTR_RATE)
    t_bytes = n_bytes / HBM_RATE
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes",
            dict(zip(STAGES, work.stages.tolist())))


def least(*bounds):
    """The least of bound()'s results for one function's work as different
    walks do it: the least time the card could take for that function."""
    return min(bounds, key=lambda b: b[0])


def pair_stages(o, d, p1, e1, e2, eps, rays, clusters, leaf, cid=None,
                self_row=None, row_id=None) -> np.ndarray:
    """(4,) counts of the pair tests of every row of each (ray, cluster)
    pair, by the stage where tri_hit stops (STAGES), in tri_hit's
    arithmetic. The census's rows: cid (T,) skips rows with no container
    slot, self_row (R,) each ray's own hit row (a table row: row_id (T,)
    maps a packed copy's rows to it)."""
    counts = torch.zeros(4, dtype=torch.int64, device=o.device)
    lane = torch.arange(leaf, device=o.device)
    step = max(1, PAIR_CHUNK // leaf)
    for s in range(0, rays.numel(), step):
        r = rays[s:s + step]
        j = clusters[s:s + step, None] * leaf + lane
        (ox, oy, oz), (dx, dy, dz) = (x[r][:, None].unbind(2) for x in (o, d))
        (ax, ay, az), (bx, by, bz), (cx, cy, cz) = (x[j].unbind(2) for x in (e1, e2, p1))
        hx, hy, hz = dy * bz - dz * by, dz * bx - dx * bz, dx * by - dy * bx
        det = ax * hx + ay * hy + az * hz
        f = 1.0 / det
        sx, sy, sz = ox - cx, oy - cy, oz - cz
        u = f * (sx * hx + sy * hy + sz * hz)
        qx, qy, qz = sy * az - sz * ay, sz * ax - sx * az, sx * ay - sy * ax
        v = f * (dx * qx + dy * qy + dz * qz)
        stage = torch.where((v >= 0.0) & (u + v <= 1.0), 3, 2)
        stage = torch.where((u >= 0.0) & (u <= 1.0), stage, 1)
        stage = torch.where(det.abs() >= eps, stage, 0)
        test = torch.ones_like(stage, dtype=torch.bool)
        if cid is not None:
            test &= cid[j] >= 0
        if self_row is not None:
            test &= (j if row_id is None else row_id[j]) != self_row[r][:, None]
        counts += torch.bincount(stage[test], minlength=4)
    return counts.cpu().numpy()


def cluster_work(o, d, tabs, aabb, leaf, eps, limit, strict=False, signed=False,
                 keep=None, cid=None, self_row=None, offset=0):
    """A box test for every (ray, cluster) pair entered by limit, and the
    pair tests of the cluster's rows (offset: the clusters' first index in
    the tables). Returns (Work, rays, clusters): the pairs' indices."""
    rays, clus = entered(o, d, aabb, limit, strict, signed, keep)
    work = BOX * rays.numel() + Work.pairs(
        pair_stages(o, d, *tabs, eps, rays, clus + offset, leaf, cid, self_row))
    return work, rays, clus


def one_cluster(leaf: int) -> Work:
    """The least an occluded lane can cost: one cluster's box test and its
    leaf pair tests, all but the occluder's stopping at det."""
    return BOX + Work.pairs((leaf - 1, 0, 0, 1))


def closest_work(o, d, tabs, aabb, t_final, leaf, eps):
    """K1's work: every cluster entered at or before the ray's final t
    (every cluster it enters, on a miss). Returns (Work, rays, clusters):
    the (ray, cluster) pairs, which are K1's visits."""
    work, rays, clus = cluster_work(o, d, tabs, aabb, leaf, eps, t_final)
    return work + RAY * o.shape[0] + WIDEN * aabb.shape[0], rays, clus


def any_work(o, d, tabs, aabb, max_t, hit, leaf, eps) -> Work:
    """K2's work: every cluster entered before max_t on an unoccluded live
    lane, one cluster on an occluded lane."""
    live = max_t > 0
    free = torch.where(live & ~hit, max_t, -1.0)
    return (cluster_work(o, d, tabs, aabb, leaf, eps, free, strict=True)[0]
            + one_cluster(leaf) * int((live & hit).sum())
            + RAY * int(live.sum()) + WIDEN * aabb.shape[0])


def census_work(o, d, tabs, aabb, t_hit, hit_gid, tri_cid, leaf, eps) -> Work:
    """K4's work: on a live lane, every container cluster whose signed slab
    interval starts before t_hit, and there each container row but the
    ray's own hit."""
    live = (t_hit > -BIG).nonzero().squeeze(1)
    has = (tri_cid.view(-1, leaf) >= 0).any(1)
    return (cluster_work(o[live], d[live], tabs, aabb, leaf, eps, t_hit[live],
                         signed=True, keep=has, cid=tri_cid, self_row=hit_gid[live])[0]
            + RAY * live.numel() + WIDEN * aabb.shape[0])


def tlas_work(o, d, tl, st, eps, limit, strict: bool = False, occluded=None):
    """K5's work (limit: the final t) or K6's (limit: max_t, strict; one
    instance and one cluster on an occluded lane): every real instance
    entered by the limit (its box test and ray transform), and in its
    object space every cluster of its mesh entered by the limit. Returns
    (Work, instance visits and cluster visits per ray, the walk_census of
    K5's two walks per ray: the instances, and in each visited instance
    its mesh's clusters)."""
    leaf, cm, I = st.cluster_size, st.tlas_cm, tl.inst_aabb.shape[0]
    tabs = (tl.p1, tl.e1, tl.e2)
    work = RAY * o.shape[0] + WIDEN * (tl.caabb.shape[0] + I)
    if occluded is not None:
        limit = torch.where(occluded, -1.0, limit)
        work += (BOX + INSTANCE + one_cluster(leaf)) * int(occluded.sum())
    inst_visits = torch.zeros(o.shape[0], dtype=torch.int64, device=o.device)
    clus_visits = torch.zeros_like(inst_visits)
    L = WALK_L["K5"]
    census = walk_census(torch.zeros_like(inst_visits), 0, L)
    for k, m in mi._real_instances(tl.p1, tl.inst_aabb, tl.inst_mesh, cm * leaf):
        inside, _ = entered(o, d, tl.inst_aabb[k:k + 1], limit, strict)
        oi, di = mi.instance_rays(o[inside], d[inside], tl.inst_ab[k])
        w, rays, _ = cluster_work(oi, di, tabs, tl.caabb[m * cm:(m + 1) * cm], leaf,
                                  eps, limit[inside], strict, offset=m * cm)
        work += (BOX + INSTANCE) * inside.numel() + w
        inst_visits[inside] += 1
        visits = torch.bincount(rays, minlength=inside.numel())
        clus_visits.index_add_(0, inside, visits)
        for key, v in walk_census(visits, cm, L).items():
            census[key].index_add_(0, inside, v)
    outer = walk_census(inst_visits, I, L)
    return (work, inst_visits, clus_visits,
            {k: census[k] + outer[k] for k in census})


def occ_rows(occ):
    """The occlusion copy's p1, e1 and e2 (T, 3) views."""
    return occ.rows[:, 0:3], occ.rows[:, 4:7], occ.rows[:, 8:11]


def slab_pairs(o, d, boxes, rays, which, limit, signed: bool = False):
    """(P,) whether ray rays[p] enters widened box which[p], pair by pair in
    the kernels' slab arithmetic (mi.slab_interval, as box_slabs does it
    densely): the occlusion walk's test (at some t in [0, limit)), or
    signed, the census's (a slab interval starting before limit, behind
    the origin included)."""
    out = [torch.zeros((0,), dtype=torch.bool, device=o.device)]
    inv = mi.slab_reciprocal(d)
    for s in range(0, rays.numel(), PAIR_CHUNK):
        r, w = rays[s:s + PAIR_CHUNK], which[s:s + PAIR_CHUNK]
        b = boxes[w]
        tmin, tmax = mi.slab_interval(o[r], inv[r], b[:, :3], b[:, 3:])
        ok = (tmax >= tmin) & (tmin < limit[r])
        out.append(ok if signed else ok & (tmax >= 0.0))
    return torch.cat(out)


def descend(o, d, boxes, limit, rays, parents, fanout: int, lo: int, hi: int,
            keep=None, signed: bool = False):
    """One level of a walk below the entered (ray, parent) pairs: the
    children parent * fanout + [0, fanout) that lie in [lo, hi) (and keep),
    each box-tested (slab_pairs). Returns (tests, rays, children) of the
    pairs entered."""
    none = torch.zeros((0,), dtype=torch.int64, device=o.device)
    tests, out_r, out_c = 0, [none], [none]
    lane = torch.arange(fanout, device=o.device)
    step = max(1, PAIR_CHUNK // fanout)
    for s in range(0, rays.numel(), step):
        r = rays[s:s + step, None].expand(-1, fanout).reshape(-1)
        c = (parents[s:s + step, None] * fanout + lane).reshape(-1)
        m = (c >= lo) & (c < hi)
        if keep is not None:
            m &= keep[c.clamp(0, keep.numel() - 1)]
        r, c = r[m], c[m]
        ok = slab_pairs(o, d, boxes, r, c, limit, signed)
        tests += r.numel()
        out_r.append(r[ok])
        out_c.append(c[ok])
    return tests, torch.cat(out_r), torch.cat(out_c)


def walk_levels(o, d, occ, leaf, eps, limit, c0: int, c1: int, signed: bool = False,
                self_row=None) -> Work:
    """The tests of a walk over clusters [c0, c1) of occ, each level below
    the boxes entered at the one above (a group box holds its clusters',
    and they their sub-boxes'). The occlusion walk, for the lanes that find
    no occluder (limit: max_t, -1 elsewhere): every group box of the range,
    the range's clusters of each entered group, the sub-boxes of each
    entered cluster and the rows of each entered sub-box. signed, K4's
    census walk (limit: t_hit, -BIG on dead lanes): the same with the
    signed test, over the groups and clusters that hold a container row,
    and of each entered sub-box its container rows but the ray's own hit
    (self_row (R,), a table row)."""
    C = occ.cluster_box.shape[0]
    n_sub = occ.sub_box.shape[0] // C
    sub_rows = leaf // n_sub
    g0, g1 = c0 // GROUP, -(-c1 // GROUP)
    gkeep = occ.group_census[g0:g1] if signed else None
    lanes = int(((limit > -BIG) if signed else (limit > 0)).sum())
    gr, gg = entered(o, d, occ.group_box[g0:g1], limit, strict=True, signed=signed,
                     keep=gkeep, widen=False)
    n_groups = (g1 - g0) if gkeep is None else int(gkeep.sum())
    tc, cr, cc = descend(o, d, occ.cluster_box, limit, gr, gg + g0, GROUP, c0, c1,
                         occ.cluster_census if signed else None, signed)
    ts, sr, sb = descend(o, d, occ.sub_box, limit, cr, cc, n_sub, 0, C * n_sub,
                         signed=signed)
    stages = pair_stages(o, d, *occ_rows(occ), eps, sr, sb, sub_rows,
                         occ.row_cid if signed else None, self_row,
                         occ.row_id if signed else None)
    box = SIGNED_BOX if signed else BOX
    return box * (lanes * n_groups + tc + ts) + Work.pairs(stages)


def walk_least(occ, leaf: int) -> Work:
    """The least an occluded lane costs the walk: a box test at each level
    and one sub-box's rows, all but the occluder stopping at det."""
    sub_rows = leaf * occ.cluster_box.shape[0] // occ.sub_box.shape[0]
    return BOX * 3 + Work.pairs((sub_rows - 1, 0, 0, 1))


def occlusion_walk_work(o, d, occ, leaf, eps, max_t, hit) -> Work:
    """The tests K3's phase 3 needs with the occlusion walk (the second
    bound, beside any_work's): walk_levels on the free live lanes, the
    least on the occluded ones."""
    live = max_t > 0
    free = torch.where(live & ~hit, max_t, -1.0)
    return (walk_levels(o, d, occ, leaf, eps, free, 0, occ.cluster_box.shape[0])
            + walk_least(occ, leaf) * int((live & hit).sum()) + RAY * int(live.sum()))


def census_walk_work(o, d, occ, leaf, eps, t_hit, hit_gid) -> Work:
    """The tests K4's census walk needs (the second bound, beside
    census_work's table-order ones): walk_levels' signed walk on every
    live lane (t_hit > -BIG)."""
    return (walk_levels(o, d, occ, leaf, eps, t_hit, 0, occ.cluster_box.shape[0],
                        signed=True, self_row=hit_gid)
            + RAY * int((t_hit > -BIG).sum()))


def tlas_walk_work(o, d, tl, st, occ, eps, max_t, hit) -> Work:
    """K6's work with the occlusion walk: on a free live lane every
    instance group box, the 8 slot boxes of each entered group and, for
    each entered instance, its ray transform and walk_levels over its
    mesh's groups in object space; the least on an occluded lane (an
    instance group, a slot and a mesh walk's least)."""
    leaf, cm = st.cluster_size, st.tlas_cm
    live = max_t > 0
    free = torch.where(live & ~hit, max_t, -1.0)
    n_free = int((free > 0).sum())
    groups = entered(o, d, occ.inst_group, free, True, widen=False)[0].numel()
    work = (BOX * (n_free * occ.inst_group.shape[0] + GROUP * groups)
            + (BOX * 2 + INSTANCE + walk_least(occ, leaf)) * int((live & hit).sum())
            + RAY * int(live.sum()))
    for s, k in enumerate(occ.inst_perm.tolist()):
        if k < 0:
            continue
        m = int(tl.inst_mesh[k])
        inside, _ = entered(o, d, occ.inst_box[s:s + 1], free, True, widen=False)
        oi, di = mi.instance_rays(o[inside], d[inside], tl.inst_ab[k])
        work += INSTANCE * inside.numel() + walk_levels(
            oi, di, occ, leaf, eps, free[inside], m * cm, (m + 1) * cm)
    return work


BOUNDS = {}  # kernel key -> bound(): (bound_ms, bound_by, pair tests)
# K2, K3, K4 and K6: bound() of the tests of the table-order loop, which
# their walk replaced; their BOUNDS entry is the lesser of it and the
# walk's (least)
TABLE_ORDER_BOUNDS = {}
EXTRA = {}  # kernel key -> further keys of its kernels line


# the built kernels' list lengths, {"K1": L, "K5": L} (phase 2); the walk
# lines model the scans from the visits (rtc_tpu_torch/tools/walk.py)
WALK_L = {}


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
    global WALK_L
    k1, k5 = mi.walk_list()
    WALK_L = {"K1": k1, "K5": k5}
    report = mi.walk_kernel_report()
    line = lambda k, r: (f"{k} {r['registers']} registers, {r['local_bytes']} B "
                         f"local (spills), {r['shared_bytes']} B shared a block of "
                         f"{r['block_threads']} threads, {r['blocks_per_sm']} blocks "
                         f"= {r['threads_per_sm']} threads an SM")
    say("2 build", f"ordered walk: lists of {k1} keys (K1, K3) and {k5} keys "
        "(each of K5's two) in registers; " + "; ".join(
            line(k, r) for k, r in report.items() if not k.startswith("K7")))
    say("2 build", f"K7's tile walk: {mi.ELEMENTWISE_TILE} rays a block; shared memory "
        "holds two staged clusters of 128 rows and a chunk of widened super boxes; "
        + "; ".join(
            line(k, r) for k, r in report.items() if k.startswith("K7")))


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
    t = mi.mesh_closest_hit(so, sd, *tables(soup), soup.tri_n, soup.cluster_aabb,
                            soup.static.cluster_size, eps)[0]
    say("3 walk", k1_walk_line(f"soup K1 ({soup.static.n_clusters} clusters)",
                               entered(so, sd, soup.cluster_aabb, t)[0], so.shape[0],
                               soup.static.n_clusters, WALK_L["K1"]))


def k2_bounds(scene, o, d, max_t, flags, eps) -> tuple:
    """(the lesser, the table-order loop's) of K2's two bounds on a
    wavefront of one launch over the whole table: any_work's tests, and
    those of the occlusion walk (occlusion_walk_work)."""
    leaf, aabb, tabs = scene.static.cluster_size, scene.cluster_aabb, tables(scene)
    in_bytes = nbytes(max_t) + o.shape[0] + live_bytes(max_t > 0, o, d)
    old = bound(any_work(o, d, tabs, aabb, max_t, flags, leaf, eps),
                in_bytes + nbytes(*tabs, aabb))
    new = bound(occlusion_walk_work(o, d, scene.occ, leaf, eps, max_t, flags),
                in_bytes + occ_bytes(scene.occ))
    return least(old, new), old


def phase_timing(scene, cam, leaf, eps):
    """Each kernel against its plain version at the main path's shapes:
    the times of both, and the parity gates on the timed calls' outputs.
    Returns {kernel: (ms, plain_ms)} and {kernel: (max_abs_err, flips)}."""
    o, d = main_path_rays(cam)
    p1, e1, e2 = tables(scene)
    so, sd, max_t = k3_shadow_rays(scene, o, d, eps)
    runs = {
        "closest_hit": (
            lambda: mi.mesh_closest_hit(o, d, p1, e1, e2, scene.tri_n,
                                        scene.cluster_aabb, leaf, eps),
            lambda: mi.closest_hit_plain(o, d, p1, e1, e2, scene.tri_n, eps)),
        "any_hit": (
            lambda: mi.mesh_any_hit(so, sd, max_t, p1, e1, e2,
                                    scene.cluster_aabb, leaf, eps, occ=scene.occ),
            lambda: mi.any_hit_plain(so, sd, max_t, p1, e1, e2, eps)),
        "closest_shadow": (
            lambda: mi.mesh_closest_shadow(o, d, p1, e1, e2, scene.tri_n,
                                           scene.cluster_aabb,
                                           scene.light_pos, leaf, eps, occ=scene.occ),
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
        DEVICE_MS[name] = device_ms(kernel)

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
    k3_flags_gate("main-path K3", k3[3], k2, max_t)
    k2_table_order_gate("main-path K2", scene, k2, so, sd, max_t, eps)
    parity = {"closest_hit": (err1, None), "any_hit": (float(flips2 > 0), flips2),
              "closest_shadow": (err3, flips3)}
    tab_bytes = nbytes(p1, e1, e2, scene.cluster_aabb)
    R = o.shape[0]
    tri = (p1, e1, e2)
    work1, rays1, _ = closest_work(o, d, tri, scene.cluster_aabb,
                                   outs["closest_hit"][0][0], leaf, eps)
    say("3 walk", k1_walk_line(f"cow main path K1, K3's phase 1 ({scene.static.n_clusters} "
                               "clusters)", rays1, R, scene.static.n_clusters,
                               WALK_L["K1"]))
    BOUNDS["closest_hit"] = bound(work1, nbytes(o, d, scene.tri_n) + tab_bytes + R * 20)
    BOUNDS["any_hit"], TABLE_ORDER_BOUNDS["any_hit"] = k2_bounds(scene, so, sd, max_t,
                                                                 k2, eps)
    k3_bytes = nbytes(o, d, scene.tri_n, scene.light_pos) + tab_bytes + R * 21
    old = bound(work1 + any_work(so, sd, tri, scene.cluster_aabb, max_t, k3[3], leaf, eps),
                k3_bytes)
    new = bound(work1 + occlusion_walk_work(so, sd, scene.occ, leaf, eps, max_t, k3[3]),
                k3_bytes + occ_bytes(scene.occ))
    BOUNDS["closest_shadow"], TABLE_ORDER_BOUNDS["closest_shadow"] = least(old, new), old
    phases_23 = times["closest_shadow"][0] - times["closest_hit"][0]
    EXTRA["closest_shadow"] = {"phases_2_3_ms": phases_23}
    say("3 kernel timing",
        f"{o.shape[0]} primary rays ({hits} hits, "
        f"{int((max_t > 0).sum())} live shadow rays): " + "; ".join(
            f"{k} {v[0]:.3f} ms (dispatch hidden {shown(DEVICE_MS[k])}) vs plain "
            f"{v[1]:.1f} ms"
            for k, v in times.items())
        + f"; K3's phases 2-3 (K3 - K1) {phases_23:.3f} ms; vs plain: K1 max|dt| "
        f"{err1:.3g}, K2 {flips2} flips of {so.shape[0]}, K3 max|dt| {err3:.3g}, "
        f"{flips3} shadow flips against plain, 0 against K2; K2 0 flips against the "
        f"table-order loop; K2 bound {TABLE_ORDER_BOUNDS['any_hit'][0]:.4f} ms (the "
        f"table-order loop's tests), {BOUNDS['any_hit'][0]:.4f} ms (the lesser); K3 "
        f"bound {old[0]:.4f} ms (the table-order loop's tests), {new[0]:.4f} ms (the "
        "occlusion walk's)")
    return times, parity


def surface_points(scene, o, d, cfg):
    """A node's closest hits and the points its shadow rays leave from, as
    color_at derives them: (hit, over_point (FAR on misses), live: hits
    whose normal faces the light)."""
    hit = integrator.closest_hit(scene, o, d, cfg)
    comps = integrator.prepare_hit3(scene, o, d, hit, cfg)
    over = torch.stack([torch.where(hit.valid, c, FAR)
                        for c in comps.over_point], 1)
    lvx, lvy, lvz = normalize3(*(scene.light_pos[k] - comps.point[k]
                                 for k in range(3)))
    nx, ny, nz = comps.normalv
    facing = (lvx * nx + lvy * ny + lvz * nz) >= 0.0
    return hit, over, hit.valid & facing


def split_path(scene, o, d):
    """The split path of one node (fused_shadow=False): K1, then K2 on the
    shadow rays the integrator derives. Returns (hit, shadowed)."""
    cfg = RenderConfig(fused_shadow=False)
    hit, over, live = surface_points(scene, o, d, cfg)
    return hit, integrator.is_shadowed(scene, over, cfg, live=live)


def surface_shadow_rays(scene, o, d):
    """The shadow rays a frame casts from its surfaces for primary rays
    (o, d), on its default route: (origin, direction, max_t), dead lanes
    at max_t -1 (integrator.shadow_query)."""
    _, over, live = surface_points(scene, o, d, RenderConfig())
    direction, distance = integrator.shadow_query(scene, over, live)
    return over.contiguous(), direction.contiguous(), distance.contiguous()


def phase_fused_vs_split(scene, cam, eps):
    """K3 against K1, then K2 on the shadow rays the integrator derives."""
    o, d = main_path_rays(cam)
    leaf = scene.static.cluster_size
    t, idx, n, sh = mi.mesh_closest_shadow(
        o, d, *tables(scene), scene.tri_n, scene.cluster_aabb,
        scene.light_pos, leaf, eps, occ=scene.occ)
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
    # the root branches (cow is reflective); K3 gives the fused nodes' flag
    expected = {"fused": dict(none, closest_shadow=nodes, **shading(nodes, n_tiles, 0)),
                "split": dict(none, closest_hit=nodes, any_hit=nodes,
                              **shading(nodes, n_tiles))}
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
    """A registry scene or test world on the card (compiled once per name:
    the tables do not depend on the canvas) and its camera at width."""
    world, cam = (REGISTRY.get(name) or TEST_WORLDS[name])(width)
    if name not in SCENES:
        t0 = time.perf_counter()
        scene = compile_scene(world, dtype=torch.float32, device="cuda")
        torch.cuda.synchronize()
        SCENES[name] = (scene, time.perf_counter() - t0)
    return SCENES[name][0], cam


PLAIN_IMAGES = {}  # (scene, width) -> the plain render on the card


def plain_render(name: str, width: int):
    """The plain (bruteforce) render of a scene at width, rendered once."""
    if (name, width) not in PLAIN_IMAGES:
        scene, cam = slice_scene(name, width)
        PLAIN_IMAGES[name, width] = render(scene, cam,
                                           RenderConfig(mesh_impl="bruteforce"))
    return PLAIN_IMAGES[name, width]


def time_pair(kernel, plain, plain_warmup: int = 1, plain_iters: int = 2, key=None):
    """Device ms of a kernel and its plain version at one input, in the
    order plain, kernel, kernel, plain; and the last outputs of both. key:
    also the kernel alone (device_ms) into DEVICE_MS[key]."""
    a, _ = timed_ms(plain, plain_warmup, plain_iters)
    b, got = timed_ms(kernel, 2, 10)
    c, _ = timed_ms(kernel, 0, 10)
    e, ref = timed_ms(plain, 0, plain_iters)
    if key is not None:
        DEVICE_MS[key] = device_ms(kernel)
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
        lambda: mi.closest_hit_sn_plain(o, d, *tabs, eps), key="closest_hit_sn")
    ms3, pms3, k3, p3 = time_pair(
        lambda: mi.mesh_closest_shadow_sn(o, d, *tabs, scene.cluster_aabb,
                                          light, leaf, eps, occ=scene.occ),
        lambda: mi.closest_shadow_sn_plain(o, d, *tabs, light, eps),
        key="closest_shadow_sn")
    err1 = closest_gate("teapot_smooth K1 with_sn", k1, p1)
    err3 = closest_gate("teapot_smooth K3 with_sn", k3, p3)
    aabb, R = scene.cluster_aabb, o.shape[0]
    work1, rays1, _ = closest_work(o, d, tabs[:3], aabb, k1[0], leaf, eps)
    say("6 walk", k1_walk_line(f"teapot_smooth K1 and K3 with_sn ({scene.static.n_clusters} "
                               "clusters)", rays1, R, scene.static.n_clusters,
                               WALK_L["K1"]))
    in_bytes = nbytes(o, d, *tabs, aabb)
    BOUNDS["closest_hit_sn"] = bound(work1, in_bytes + R * 20)
    so, sd, smax = k3_shadow_rays(scene, o, d, eps, k3, unit_n=False)
    old = bound(work1 + any_work(so, sd, tabs[:3], aabb, smax, k3[3], leaf, eps),
                in_bytes + nbytes(light) + R * 21)
    new = bound(work1 + occlusion_walk_work(so, sd, scene.occ, leaf, eps, smax, k3[3]),
                in_bytes + nbytes(light) + occ_bytes(scene.occ) + R * 21)
    BOUNDS["closest_shadow_sn"] = least(old, new)
    TABLE_ORDER_BOUNDS["closest_shadow_sn"] = old
    hits = int((p3[1] >= 0).sum())
    flips3 = int((k3[3] != p3[3]).sum())
    check(flips3 <= max(2, hits // 1000),
          f"teapot_smooth K3 with_sn: shadow flags differ on {flips3} of {hits} hits")
    k3_flags_gate("teapot_smooth K3 with_sn", k3[3],
                  mi.mesh_any_hit(so, sd, smax, *tabs[:3], aabb, leaf, eps, occ=scene.occ),
                  smax)
    say("6 smooth kernels",
        f"teapot_smooth {o.shape[0]} primary rays ({hits} hits, C="
        f"{scene.static.n_clusters}): K1 with_sn {ms1:.3f} ms vs plain "
        f"{pms1:.1f} ms, max|dt| {err1:.3g}; K3 with_sn {ms3:.3f} ms vs plain "
        f"{pms3:.1f} ms, max|dt| {err3:.3g}, {flips3} shadow flips against plain, "
        f"0 against K2 ({int(p3[3].sum())} shadowed); K3 with_sn bound {old[0]:.4f} ms "
        f"(the table-order loop's tests), {new[0]:.4f} ms (the occlusion walk's)")

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
    Both timed, each with its two bounds (census_work's tests of the
    table-order census, census_walk_work's of the census walk); the kernels
    line takes the main-path input's. Then K2 on glass_teapot's surface
    shadow rays (glass_teapot_k2)."""
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
                                           K, leaf, eps, occ=scene.occ),
            lambda: mi.crossing_count_plain(oo, d, tt, gg, *tabs,
                                            scene.tri_cid, K, eps),
            key="crossing_count" if key == "main path" else "crossing_count_reseated")
        err, crossings = census_gate(f"glass_teapot K4 {key}", got, ref)
        in_bytes = nbytes(tt) + oo.shape[0] * K * 8 + live_bytes(tt > -BIG, oo, d, gg)
        old = bound(census_work(oo, d, tabs, scene.cluster_aabb, tt, gg, scene.tri_cid,
                                leaf, eps),
                    in_bytes + nbytes(*tabs, scene.tri_cid, scene.cluster_aabb))
        new = bound(census_walk_work(oo, d, scene.occ, leaf, eps, tt, gg),
                    in_bytes + occ_bytes(scene.occ, CENSUS_FIELDS))
        out[key] = (ms, pms, err, crossings, int((tt > -BIG).sum()), old, new)
    main, again = out["main path"], out["re-seated"]
    BOUNDS["crossing_count"] = least(main[5], main[6])
    TABLE_ORDER_BOUNDS["crossing_count"] = main[5]
    EXTRA["crossing_count"] = dict(
        reseated_ms=again[0], reseated_device_ms=DEVICE_MS.pop("crossing_count_reseated"),
        reseated_plain_ms=again[1],
        reseated_bound_ms=least(again[5], again[6])[0],
        reseated_table_order_bound_ms=again[5][0], reseated_crossings=again[3])
    say("7 census", f"glass_teapot {o.shape[0]} primary rays, K={K}, "
        f"{int(live.sum())} transparent hits: " + "; ".join(
            f"{k}: {v[4]} live lanes, {v[3]} crossings, K4 {v[0]:.3f} ms vs "
            f"plain {v[1]:.1f} ms, 0 count mismatches, max|d last| {v[2]:.3g}, bound "
            f"{v[5][0]:.4f} ms (the table-order census's tests), {v[6][0]:.4f} ms (the "
            "census walk's)" for k, v in out.items()))
    glass_teapot_k2(scene, o, d, eps)
    return ({"crossing_count": (main[0], main[1])},
            {"crossing_count": (max(main[2], again[2]), 0)})


def glass_teapot_k2(scene, o, d, eps) -> None:
    """K2 on the shadow rays glass_teapot's root node casts from its
    surfaces for the primary rays (o, d): timed, its flags equal to the
    table-order loop's on every ray, with its two bounds (k2_bounds); into
    the K2 line's glass_teapot_* keys."""
    so, sd, smax = surface_shadow_rays(scene, o, d)
    k2 = lambda: mi.mesh_any_hit(so, sd, smax, *tables(scene), scene.cluster_aabb,
                                 scene.static.cluster_size, eps, occ=scene.occ)
    ms, flags = timed_ms(k2, 2, 10)
    dev = device_ms(k2)
    k2_table_order_gate("glass_teapot K2", scene, flags, so, sd, smax, eps)
    lesser, old = k2_bounds(scene, so, sd, smax, flags, eps)
    EXTRA.setdefault("any_hit", {}).update(
        glass_teapot_rays=so.shape[0], glass_teapot_ms=ms, glass_teapot_device_ms=dev,
        glass_teapot_bound_ms=lesser[0], glass_teapot_table_order_bound_ms=old[0])
    say("7 census", f"glass_teapot K2 on {so.shape[0]} surface shadow rays "
        f"({int((smax > 0).sum())} live, {int(flags.sum())} occluded): {ms:.3f} ms "
        f"(dispatch hidden {shown(dev)}), 0 "
        f"flips against the table-order loop; bound {old[0]:.4f} ms (the table-order "
        f"loop's tests), {lesser[0]:.4f} ms (the lesser)")


# the slice's frames: each kernel of the scene's path, launches per frame
FRAME_KERNELS = {
    "teapot_smooth": lambda tiles: {"closest_shadow_sn": tiles, **shading(tiles, 0, 0)},
    # root node + its reflected and refracted children; census at the root;
    # the checkered plane's closest hit and shadow flag at each node; the
    # blend at the root
    "glass_teapot": lambda tiles: {"closest_hit_sn": 3 * tiles,
                                   "any_hit": 3 * tiles,
                                   "crossing_count": tiles,
                                   "prim_closest": 3 * tiles,
                                   "prim_any": 3 * tiles,
                                   **shading(3 * tiles, tiles)},
    # instanced and not reflective: one node per tile, K5 then K6
    "cow_herd": lambda tiles: {"closest_hit_tlas": tiles,
                               "any_hit_tlas": tiles, **shading(tiles, 0)},
    "cow_herd_smooth": lambda tiles: {"closest_hit_tlas_sn": tiles,
                                      "any_hit_tlas": tiles, **shading(tiles, 0)},
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
        plain = plain_render(name, gw)
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


PRIM_SCENE = "glass_teapot"  # the frame whose prims' sweep the kernels line times


def prim_sweep_lines() -> list:
    """The prims' sweep on the inputs the main path hands it: the calls of
    mi.prim_closest (closest_hit's) and mi.prim_any (is_shadowed's), one a
    shading node, recorded in one eager PRIM_SCENE frame at 1920x960 and
    the default tile (1,843,200 rays a call), with the launches that frame
    counted from 0. Each call's kernel against its plain version bit for
    bit (t's bits, the prim ids, the flags); each timed (time_pair, and
    device_ms) against the plain version and the bound: the rays (o, d,
    and max_t in the any mode) read once and the results written, at
    HBM_RATE. Returns the two kernels lines, each "ms", "device_ms",
    "plain_ms" and "bound_ms" a call (the mean of the frame's calls)."""
    scene, cam = slice_scene(PRIM_SCENE, WIDTH)
    taken = {"prim_closest": [], "prim_any": []}
    real = {name: getattr(mi, name) for name in taken}

    def keeper(name):
        def keep(*args):
            taken[name].append(tuple(a.clone() if torch.is_tensor(a) else a for a in args))
            return real[name](*args)
        return keep

    with compiled.eager():
        render(scene, cam, RenderConfig())  # warm-up
        torch.cuda.synchronize()
        mi.reset_launch_counts()
        for name in taken:
            setattr(mi, name, keeper(name))
        try:
            render(scene, cam, RenderConfig())
            torch.cuda.synchronize()
        finally:
            for name in taken:
                setattr(mi, name, real[name])
    launches = dict(mi.LAUNCHES)
    plains = {"prim_closest": mi.prim_closest_plain, "prim_any": mi.prim_any_plain}
    lines = []
    for name, label in (("prim_closest", "prims' sweep, closest (t, prim)"),
                        ("prim_any", "prims' sweep, shadow flag")):
        calls = taken[name]
        check(launches[name] == len(calls) == 3, f"{PRIM_SCENE} frame: {launches[name]} "
              f"{name} launches for {len(calls)} calls, expected 3")
        per = []
        for args in calls:
            kernel = lambda: real[name](*args)
            plain = lambda: plains[name](*args)
            ms, plain_ms, got, ref = time_pair(kernel, plain, plain_warmup=1, plain_iters=3)
            if name == "prim_closest":
                same = (torch.equal(got[0].view(torch.int32), ref[0].view(torch.int32))
                        and torch.equal(got[1], ref[1]))
                n_bytes = nbytes(*args[:2], *got)
                found = int((got[0] < BIG).sum())
            else:
                same = torch.equal(got, ref)
                n_bytes = nbytes(*args[:3], got)
                found = int(got.sum())
            check(same, f"{name} on {PRIM_SCENE}'s frame inputs: kernel differs from plain")
            b = bound(Work(), n_bytes)
            per.append(dict(ms=ms, device_ms=device_ms(kernel), plain_ms=plain_ms,
                            bound_ms=b[0], bound_by=b[1], found=found))
        mean = lambda k: (None if any(c[k] is None for c in per)
                          else sum(c[k] for c in per) / len(per))
        line = {"name": label, "route": "cuda", "source": SOURCE,
                "replaces": "intersect.prims and its reduction (the torch sweep)",
                "frame": PRIM_SCENE, "launches": launches[name], "max_abs_err": 0.0,
                "flips": 0, "pair_tests": None, "library_ms": None,
                **{k: mean(k) for k in ("ms", "device_ms", "plain_ms", "bound_ms")},
                "bound_by": per[0]["bound_by"], "rays": calls[0][0].shape[0],
                "plain_rays": calls[0][0].shape[0], "calls": per}
        lines.append(line)
        say("8 prim sweep",
            f"{name} on {PRIM_SCENE}'s {WIDTH}x{HEIGHT} frame inputs: {len(calls)} calls "
            f"of {line['rays']} rays ({[c['found'] for c in per]} hits or shadowed), "
            f"{launches[name]} launches a frame, bit-equal to plain; a call: kernel "
            f"{shown(line['ms'])} (device {shown(line['device_ms'])}), plain "
            f"{shown(line['plain_ms'])}, bound {shown(line['bound_ms'])} ({line['bound_by']})")
    return lines


SHADE_PLAIN = {"shade_surface": mi.shade_surface_plain, "shade_node": mi.shade_node_plain,
               "shade_blend": mi.shade_blend_plain}


def shade_calls(name: str = PRIM_SCENE, width: int = WIDTH) -> list:
    """Every call of the shading stages' wrappers (mi.shade_surface,
    shade_node, shade_blend) in one eager frame of name at width and the
    default tile (1,843,200 rays a call at 1920): [(stage, args, kwargs,
    outputs)], in the frame's order. The launch counts are set to 0 just
    before that frame, so mi.LAUNCHES holds its launches on return."""
    scene, cam = slice_scene(name, width)
    calls = []
    real = {k: getattr(mi, k) for k in SHADE_STAGES}

    def keeper(k):
        def keep(*a, **kw):
            out = real[k](*a, **kw)
            calls.append((k, a, kw, out))
            return out
        return keep

    with compiled.eager():
        render(scene, cam, RenderConfig())  # warm-up
        for k in SHADE_STAGES:
            setattr(mi, k, keeper(k))
        try:
            mi.reset_launch_counts()
            render(scene, cam, RenderConfig())
            torch.cuda.synchronize()
        finally:
            for k in SHADE_STAGES:
                setattr(mi, k, real[k])
    return calls


def shade_outputs(stage: str, out) -> list:
    """A stage's output tensors, the plain version's weights stacked as the
    kernel's (R, 4) (a column the plain version leaves out: the kernel's,
    which no caller reads)."""
    if stage == "shade_surface":
        return list(out)
    if stage == "shade_blend":
        return [out]
    rays = [x for child in (out.refl, out.refr) if child is not None for x in child]
    return [out.color, *rays] + ([] if out.weights is None else [out.weights])


def shade_equal(stage: str, got, ref) -> bool:
    """The kernel's outputs equal the plain version's bit for bit (a
    node's weights on the columns the plain version fills)."""
    g, r = shade_outputs(stage, got), shade_outputs(stage, ref)
    if stage == "shade_node" and got.weights is not None:
        g.pop()
        r.pop()
        for k, w in enumerate(ref.weights):
            if w is not None:
                g.append(got.weights[:, k])
                r.append(w)
    return all(map(bit_equal, g, r))


def bit_equal(a, b) -> bool:
    """a and b hold the same bits (so -0.0 and NaN compare by theirs)."""
    return torch.equal(a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def shade_bytes(stage: str, args, got) -> int:
    """The bytes a stage's kernel reads and writes once: its outputs, and
    its per-ray inputs on the lanes that read them. The surface and node
    stages read the rays and the hits' valid on every lane, t on a valid
    one; with prims, is_tri on every lane, prim on a prim's (is_tri
    false) and tri_n on a triangle's; without, tri_n on every lane. The
    node stage reads besides the hits' obj and, where given, the shadow
    flag, n1 and n2. The blend stage reads valid, the surface colour, the
    children's colours where given and the weights."""
    if stage == "shade_blend":
        return nbytes(*(a for a in args[:5] if torch.is_tensor(a)), got)
    o, d, hit = args[:3]
    prims = args[3] if stage == "shade_surface" else args[6]
    ins = nbytes(o, d, hit.valid) + live_bytes(hit.valid, hit.t)
    if prims is None:
        ins += nbytes(hit.tri_n)
    else:
        ins += (nbytes(hit.is_tri) + live_bytes(~hit.is_tri, hit.prim)
                + live_bytes(hit.is_tri, hit.tri_n))
    if stage == "shade_node":
        ins += nbytes(hit.obj, *(a for a in args[3:6] if torch.is_tensor(a)))
    return ins + nbytes(*shade_outputs(stage, got))


# a tile's shading launches (shading()) in the frames shade_lines records:
# the root and its reflection and refraction children, the blend at the root
SHADE_FRAMES = {"glass_teapot": (3, 1), "table": (3, 1)}


def shade_lines(name: str = PRIM_SCENE) -> list:
    """Each shading stage on the inputs the main path hands it (shade_calls
    of an eager 1920x960 frame of name): the frame's launches of each stage
    (counted from 0 just before it) equal to its wrapper's calls and to
    SHADE_FRAMES' count; each call's kernel against its plain version bit
    for bit, and timed (time_pair, and device_ms, the host's dispatch
    hidden) against the plain version and the bound, the bytes it reads
    and writes once at HBM_RATE (shade_bytes). Returns one kernels line a
    stage, "launches" the frame's, "ms", "device_ms", "plain_ms" and
    "bound_ms" a call (the mean of the frame's calls), "calls" each
    call's."""
    calls = shade_calls(name)
    launched = {k: mi.LAUNCHES[k] for k in SHADE_STAGES}
    n_tiles = -(-WIDTH * HEIGHT // RenderConfig().ray_tile)
    want = shading(*(n * n_tiles for n in SHADE_FRAMES[name]))
    got = {k: sum(c[0] == k for c in calls) for k in SHADE_STAGES}
    check(launched == got == want, f"shading on {name}'s frame: launches {launched}, "
          f"wrapper calls {got}, expected {want}")
    lines = []
    for stage in SHADE_STAGES:
        mine = [(a, kw) for k, a, kw, _ in calls if k == stage]
        per = []
        for a, kw in mine:
            kernel = lambda: getattr(mi, stage)(*a, **kw)
            plain = lambda: SHADE_PLAIN[stage](*a, **kw)
            ms, plain_ms, got, ref = time_pair(kernel, plain, plain_warmup=1, plain_iters=3)
            check(shade_equal(stage, got, ref),
                  f"{stage} on {name}'s frame inputs: kernel differs from plain")
            b = bound(Work(), shade_bytes(stage, a, got))
            per.append(dict(ms=ms, device_ms=device_ms(kernel), plain_ms=plain_ms,
                            bound_ms=b[0], bound_by=b[1], bytes=shade_bytes(stage, a, got)))
        if not per:
            continue
        mean = lambda k: (None if any(c[k] is None for c in per)
                          else sum(c[k] for c in per) / len(per))
        rays = (mine[0][0][1] if stage == "shade_blend" else mine[0][0][0]).shape[0]
        line = {"name": f"shading, {stage}", "route": "cuda", "source": SOURCE,
                "replaces": "ops/shading.py's elementwise chain (the plain version)",
                "frame": name, "launches": launched[stage], "max_abs_err": 0.0, "flips": 0,
                "pair_tests": None, "library_ms": None,
                **{k: mean(k) for k in ("ms", "device_ms", "plain_ms", "bound_ms")},
                "bound_by": per[0]["bound_by"], "rays": rays, "plain_rays": rays,
                "calls": per}
        lines.append(line)
        say("8 shading", f"{stage} on {name}'s {WIDTH}x{HEIGHT} frame inputs: "
            f"{len(mine)} calls of {rays} rays, bit-equal to plain; a call: kernel "
            f"{shown(line['ms'])} (device {shown(line['device_ms'])}), plain "
            f"{shown(line['plain_ms'])}, bound {shown(line['bound_ms'])} "
            f"({line['bound_by']}, {per[0]['bytes']} bytes)")
    return lines


# a fit's shading under autograd (integrator's "grad" route): the node
# stage's factors instance and the backward's two stages, each wrapper with
# its plain twin
SHADE_GRAD_PLAIN = {"shade_node": mi.shade_node_plain,
                    "shade_node_grad": mi.shade_node_grad_plain,
                    "shade_blend_grad": mi.shade_blend_grad_plain}
# the launches of one gradient of shade_grad_lines' glass_teapot fit: a
# factors node launch a node (the root and its two children), a backward
# launch a node and one more for the root's blend
SHADE_GRAD_FIT = {"shade_node": 3, "shade_grad": 4}


def shade_grad_calls(name: str = "glass_teapot") -> list:
    """Every call of the node stage's factors instance (mi.shade_node with
    factors) and of the shading backward's wrappers (mi.shade_node_grad,
    shade_blend_grad) in one eager gradient of a 1920x960 fit of name:
    loss_and_grad on the fit cells' parameters (mat_color and
    light_intensity) over every pixel's ray in 16x16 blocks, against a
    flat target. [(wrapper, args, kwargs, outputs)], in the order of the
    calls. The launch counts are set to 0 just before that gradient (after
    one to warm up), so mi.LAUNCHES holds its launches on return."""
    scene, cam = slice_scene(name, WIDTH)
    px, py = blocked_pixels(cam.vsize, cam.hsize, "cuda")
    o, d = camera_rays_for_pixels(cam.transform_inverse, px, py, cam.half_width,
                                  cam.half_height, cam.pixel_size)
    o, d = o.contiguous(), d.contiguous()
    params = RG.extract_params(scene, ("mat_color", "light_intensity"))
    fit = lambda: RG.loss_and_grad(params, scene, o, d, torch.full_like(o, 0.25),
                                   RenderConfig())
    calls = []
    real = {k: getattr(mi, k) for k in SHADE_GRAD_PLAIN}

    def keeper(k):
        def keep(*a, **kw):
            out = real[k](*a, **kw)
            calls.append((k, a, kw, out))
            return out
        return keep

    with compiled.eager():
        fit()  # warm-up
        torch.cuda.synchronize()
        for k in SHADE_GRAD_PLAIN:
            setattr(mi, k, keeper(k))
        try:
            mi.reset_launch_counts()
            fit()
            torch.cuda.synchronize()
        finally:
            for k in SHADE_GRAD_PLAIN:
                setattr(mi, k, real[k])
    return calls


def shade_grad_bytes(args, outs) -> int:
    """The bytes a backward stage reads and writes once: the upstream
    gradient and the saved (R, 4) factors or weights, the blend's valid
    and the node's intensity, and the partials it writes."""
    return nbytes(*(a for a in args if torch.is_tensor(a)),
                  *(x for x in outs if x is not None))


def shade_grad_lines(name: str = "glass_teapot") -> list:
    """The fit's shading kernels under autograd on the inputs the main path
    hands them (shade_grad_calls of an eager 1920x960 gradient of name):
    the gradient's launches of the factors instance and of the backward
    (counted from 0 just before it) equal to the wrappers' calls and to
    SHADE_GRAD_FIT; each call's kernel against its plain twin bit for bit
    (the node's outputs as shade_equal, and its factors), twice the same
    bits, and timed (time_pair, and device_ms) against the twin and the
    bound, the bytes it reads and writes once at HBM_RATE (shade_bytes
    and the factors for the node, shade_grad_bytes for the backward).
    Returns one kernels line a wrapper, as shade_lines'."""
    calls = shade_grad_calls(name)
    launched = {k: mi.LAUNCHES[k] for k in SHADE_GRAD_FIT}
    got = {"shade_node": sum(c[0] == "shade_node" for c in calls),
           "shade_grad": sum(c[0] != "shade_node" for c in calls)}
    check(all(c[2].get("factors") for c in calls if c[0] == "shade_node"),
          f"shading on {name}'s fit: a node call without the factors")
    check(launched == got == SHADE_GRAD_FIT, f"shading on {name}'s fit: launches "
          f"{launched}, wrapper calls {got}, expected {SHADE_GRAD_FIT}")
    lines = []
    for stage, plain_fn in SHADE_GRAD_PLAIN.items():
        mine = [(a, kw, out) for k, a, kw, out in calls if k == stage]
        per = []
        for a, kw, first in mine:
            kernel = lambda: getattr(mi, stage)(*a, **kw)
            plain = lambda: plain_fn(*a, **kw)
            ms, plain_ms, got, ref = time_pair(kernel, plain, plain_warmup=1, plain_iters=3)
            if stage == "shade_node":
                outputs_of = lambda n: [*shade_outputs(stage, n), n.factors]
                same = (shade_equal(stage, got, ref) and bit_equal(got.factors, ref.factors)
                        and all(map(bit_equal, outputs_of(got), outputs_of(first))))
                n_bytes = shade_bytes(stage, a, got) + nbytes(got.factors)
            else:
                outs = lambda xs: [x for x in xs if x is not None]
                same = all(len(outs(got)) == len(outs(x)) > 0
                           and all(map(bit_equal, outs(got), outs(x))) for x in (ref, first))
                n_bytes = shade_grad_bytes(a, got)
            check(same, f"{stage} on {name}'s fit inputs: kernel differs from its plain "
                  f"twin or from its first run")
            b = bound(Work(), n_bytes)
            per.append(dict(ms=ms, device_ms=device_ms(kernel), plain_ms=plain_ms,
                            bound_ms=b[0], bound_by=b[1], bytes=n_bytes))
        mean = lambda k: (None if any(c[k] is None for c in per)
                          else sum(c[k] for c in per) / len(per))
        rays = mine[0][0][0].shape[0]
        label = ("shading, shade_node with the factors" if stage == "shade_node"
                 else f"shading backward, {stage}")
        line = {"name": label, "route": "cuda", "source": SOURCE,
                "replaces": "autograd's backward of ops/shading.py's elementwise chain"
                if stage != "shade_node" else
                "ops/shading.py's elementwise chain under autograd (the plain version)",
                "frame": f"{name} fit", "launches": len(mine), "max_abs_err": 0.0,
                "flips": 0, "pair_tests": None, "library_ms": None,
                **{k: mean(k) for k in ("ms", "device_ms", "plain_ms", "bound_ms")},
                "bound_by": per[0]["bound_by"], "rays": rays, "plain_rays": rays,
                "calls": per}
        lines.append(line)
        say("8 shading", f"{label} on {name}'s {WIDTH}x{HEIGHT} fit inputs: {len(mine)} "
            f"calls of {rays} rays, bit-equal to the plain twin and to the first run; a "
            f"call: kernel {shown(line['ms'])} (device {shown(line['device_ms'])}), plain "
            f"{shown(line['plain_ms'])}, bound {shown(line['bound_ms'])} "
            f"({line['bound_by']}, {per[0]['bytes']} bytes)")
    return lines


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
        DEVICE_MS[key] = device_ms(lambda: k5(o, d))
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
        work5, inst_visits, clus_visits, census = tlas_work(o, d, tl, st, eps, full[0])
        BOUNDS[key] = bound(work5, nbytes(o, d, tl.p1, tl.e1, tl.e2, pay, tl.caabb,
                                          *inst, tl.inst_obj) + o.shape[0] * 24)
        say("9 walk", walk_line(f"{name} K5 ({st.tlas_n_inst} instance boxes, "
                                f"{st.tlas_cm} cluster boxes each)",
                                {"instances": inst_visits, "clusters": clus_visits},
                                census, WALK_L["K5"]))
        sizes[key] = dict(rays=o.shape[0], plain_rays=os_.shape[0],
                          ms_at_plain_rays=ms)
        summary = (f"{name} ({st.tlas_n_inst} instances, cm {st.tlas_cm}): "
                   f"K5{' with_sn' if st.tlas_sn else ''} {ms_full:.3f} ms on "
                   f"{o.shape[0]} rays ({int((full[1] >= 0).sum())} hits); on "
                   f"{os_.shape[0]} rays {ms:.3f} ms vs plain {pms:.1f} ms, "
                   f"{hits} hits, max|dt| {err:.3g}, "
                   f"{int((~same).sum())} enc mismatches")
        if not st.tlas_sn:
            summary += "; " + k6_wavefronts(name, scene, o, d, full, eps, times,
                                            parity, sizes)
        say("9 instanced kernels", summary)
    return times, parity, sizes


def k6_wavefronts(name, scene, o, d, k5_out, eps, times, parity, sizes) -> str:
    """K6 on two wavefronts of cow_herd's primary rays (o, d) and their K5
    outputs: the 921,600 free-space occlusion rays (occlusion_rays: the
    kernels line's) and the 460,800 shadow rays the frame casts from its
    surfaces (surface_shadow_rays). Each timed in full, and with its plain
    version on every TLAS_PLAIN_STEP-th ray, where the flags must agree
    on every ray; each with its two bounds (tlas_work's tests of the
    table-order walk, tlas_walk_work's of the occlusion walk), the lesser
    its bound_ms. Returns the phase's summary."""
    st, tl, occ = scene.static, scene.tlas, scene.tlas_occ
    inst = (tl.inst_ab, tl.inst_aabb, tl.inst_mesh)
    leaf_cm = (st.cluster_size, st.tlas_cm, eps)
    k6 = lambda so, sd, mt: mi.mesh_any_hit_tlas(so, sd, mt, tl.p1, tl.e1, tl.e2,
                                                 tl.caabb, *inst, *leaf_cm, occ=occ)
    plain = lambda so, sd, mt: mi.any_hit_tlas_plain(so, sd, mt, tl.p1, tl.e1, tl.e2,
                                                     *inst, *leaf_cm)
    sub = lambda x: x[::TLAS_PLAIN_STEP].contiguous()
    waves = {"free-space": occlusion_rays(scene, o, d, k5_out[0], k5_out[1]),
             "surface": surface_shadow_rays(scene, o, d)}
    parts = []
    for wave, (fo, fd, fmax) in waves.items():
        ms_full, occluded = timed_ms(lambda: k6(fo, fd, fmax), 2, 10)
        dev = device_ms(lambda: k6(fo, fd, fmax))
        ms, pms, got, ref = time_pair(lambda: k6(sub(fo), sub(fd), sub(fmax)),
                                      lambda: plain(sub(fo), sub(fd), sub(fmax)),
                                      plain_warmup=0, plain_iters=1)
        check(torch.equal(occluded[::TLAS_PLAIN_STEP], got),
              f"{name} K6 {wave}: the subset's flags differ from the full run's")
        flips = flags_gate(f"{name} K6 {wave} vs plain", got, ref, exact=True)
        live = fmax > 0
        in_bytes = (nbytes(fmax, tl.p1, tl.e1, tl.e2, tl.caabb, *inst) + fo.shape[0]
                    + live_bytes(live, fo, fd))
        old = bound(tlas_work(fo, fd, tl, st, eps, fmax, strict=True,
                              occluded=occluded & live)[0], in_bytes)
        new = bound(tlas_walk_work(fo, fd, tl, st, occ, eps, fmax, occluded),
                    in_bytes + occ_bytes(occ))
        if wave == "free-space":
            BOUNDS["any_hit_tlas"], TABLE_ORDER_BOUNDS["any_hit_tlas"] = least(old, new), old
            times["any_hit_tlas"] = (ms_full, pms)
            DEVICE_MS["any_hit_tlas"] = dev
            parity["any_hit_tlas"] = (float(flips > 0), flips)
            sizes["any_hit_tlas"] = dict(rays=fo.shape[0], plain_rays=got.shape[0],
                                         ms_at_plain_rays=ms)
        else:
            EXTRA["any_hit_tlas"] = dict(
                surface_rays=fo.shape[0], surface_ms=ms_full, surface_device_ms=dev,
                surface_bound_ms=least(old, new)[0], surface_table_order_bound_ms=old[0],
                surface_flips=flips)
        parts.append(f"K6 {wave} {ms_full:.3f} ms on {fo.shape[0]} rays "
                     f"({int(live.sum())} live, {int(occluded.sum())} occluded); on "
                     f"{got.shape[0]} rays {ms:.3f} ms vs plain {pms:.1f} ms, {flips} "
                     f"flips; bound {old[0]:.4f} ms (table-order walk's tests), "
                     f"{new[0]:.4f} ms (the occlusion walk's)")
    return "; ".join(parts)


# ---------------------------------------------------------------------------
# the elementwise backend (K7a, K7b), K1's t0 and uv modes, and streaming
# ---------------------------------------------------------------------------

# the plain versions' subsets: every 8th ray on cow, every 64th on the
# herd's 523,264-row world table
PLAIN_STEPS = {"cow": 8, "cow_herd": 64}


def winners_gate(what: str, got, ref, exact: bool = True):
    """Equal hit masks and t bit-equal (exact) or within bench.py's 1e-3;
    idx may differ only at ties. Returns (max |dt|, idx mismatches)."""
    err = closest_gate(what, (got[0], got[1], torch.zeros_like(got[0])[:, None]),
                       (ref[0], ref[1], torch.zeros_like(ref[0])[:, None]))
    if exact:
        check(torch.equal(got[0], ref[0]), f"{what}: t is not bit-equal")
    return err, int((got[1] != ref[1]).sum())


def flags_gate(what: str, got, ref, exact: bool = False) -> int:
    flips = int((got != ref).sum())
    limit = 0 if exact else max(2, got.shape[0] // 2048)
    check(flips <= limit, f"{what}: {flips} occlusion flags differ (limit {limit})")
    return flips


def phase_elementwise(eps):
    """K7a and K7b on cow's 460,800-ray wavefront and on cow_herd's
    world-table wavefront (4,088 clusters, 511 supers), timed with CUDA
    events, held to their plain versions on every 8th (cow) or 64th (herd)
    ray, and on every ray to K1 and K2 launched once over the same table:
    K7a's t bit-equal to K1's, K7b's flags equal to K2's on free-space
    occlusion rays. Returns the cow wavefront's (times, parity, sizes)."""
    times, parity, sizes = {}, {}, {}
    for name, step in PLAIN_STEPS.items():
        scene, cam = slice_scene(name, WIDTH)
        st = scene.static
        leaf, aabb, sup = st.cluster_size, scene.cluster_aabb, scene.super_aabb
        tabs = tables(scene)
        o, d = main_path_rays(cam)
        sub = lambda x: x[::step].contiguous()
        k7a = lambda oo, dd: mi.mesh_closest_hit_elementwise(oo, dd, *tabs, aabb,
                                                             sup, leaf, eps)
        ms_a, full = timed_ms(lambda: k7a(o, d), 1, 5)
        ms_a_sub, pms_a, got, ref = time_pair(
            lambda: k7a(sub(o), sub(d)),
            lambda: mi._closest_plain(sub(o), sub(d), *tabs, eps),
            plain_warmup=0, plain_iters=1)
        check(all(torch.equal(a[::step], b) for a, b in zip(full, got)),
              f"{name} K7a: the subset's outputs differ from the full run's")
        err_a, ties_plain = winners_gate(f"{name} K7a vs plain", got, ref)
        k1 = mi.mesh_closest_hit(o, d, *tabs, scene.tri_n, aabb, leaf, eps)
        _, ties_k1 = winners_gate(f"{name} K7a vs K1", full, k1)

        fo, fd, fmax = occlusion_rays(scene, o, d, full[0], full[1])
        k7b = lambda oo, dd, mm: mi.mesh_any_hit_elementwise(oo, dd, mm, *tabs, aabb,
                                                             sup, leaf, eps)
        ms_b, hit = timed_ms(lambda: k7b(fo, fd, fmax), 1, 5)
        ms_b_sub, pms_b, got_b, ref_b = time_pair(
            lambda: k7b(sub(fo), sub(fd), sub(fmax)),
            lambda: mi.any_hit_plain(sub(fo), sub(fd), sub(fmax), *tabs, eps),
            plain_warmup=0, plain_iters=1)
        check(torch.equal(hit[::step], got_b), f"{name} K7b: subset differs")
        flips_plain = flags_gate(f"{name} K7b vs plain", got_b, ref_b)
        k2 = mi.mesh_any_hit(fo, fd, fmax, *tabs, aabb, leaf, eps, occ=scene.occ)
        flags_gate(f"{name} K7b vs K2", hit, k2, exact=True)
        say("10 elementwise",
            f"{name} (C={st.n_clusters}, S={st.n_super}): K7a {ms_a:.3f} ms on "
            f"{o.shape[0]} rays ({int((full[1] >= 0).sum())} hits), t bit-equal "
            f"to one K1 launch on every ray ({ties_k1} idx ties); on {got[0].shape[0]} "
            f"rays {ms_a_sub:.3f} ms vs plain {pms_a:.1f} ms, max|dt| {err_a:.3g}, "
            f"{ties_plain} idx mismatches; K7b {ms_b:.3f} ms on {fo.shape[0]} "
            f"occlusion rays ({int(hit.sum())} occluded), equal to K2 on every "
            f"ray; on {got_b.shape[0]} rays {ms_b_sub:.3f} ms vs plain "
            f"{pms_b:.1f} ms, {flips_plain} flips")
        R, t_bytes = o.shape[0], nbytes(*tabs, aabb, sup)
        work_a = closest_work(o, d, tabs, aabb, full[0], leaf, eps)[0]  # K1's: the same function
        bound_a = bound(work_a, nbytes(o, d) + t_bytes + R * 8)
        bound_b = bound(any_work(fo, fd, tabs, aabb, fmax, hit, leaf, eps),
                        nbytes(fmax) + live_bytes(fmax > 0, fo, fd) + t_bytes + fo.shape[0])
        say("10 elementwise", f"{name}: bound K7a {bound_a[0]:.4f} ms ({bound_a[1]}), "
            f"{ms_a / bound_a[0]:.0f}x; K7b {bound_b[0]:.4f} ms ({bound_b[1]}), "
            f"{ms_b / bound_b[0]:.0f}x")
        if name != "cow":  # the herd's world table, beside the cow's line
            for key, ms, b, rays in (("closest_hit_elementwise", ms_a, bound_a, R),
                                     ("any_hit_elementwise", ms_b, bound_b, fo.shape[0])):
                EXTRA.setdefault(key, {}).update(
                    herd_rays=rays, herd_clusters=st.n_clusters, herd_ms=ms,
                    herd_bound_ms=b[0], herd_bound_by=b[1])
            continue
        DEVICE_MS["closest_hit_elementwise"] = device_ms(lambda: k7a(o, d), 5)
        DEVICE_MS["any_hit_elementwise"] = device_ms(lambda: k7b(fo, fd, fmax), 5)
        BOUNDS["closest_hit_elementwise"] = bound_a
        BOUNDS["any_hit_elementwise"] = bound_b
        times.update(closest_hit_elementwise=(ms_a, pms_a), any_hit_elementwise=(ms_b, pms_b))
        parity.update(closest_hit_elementwise=(err_a, None),
                      any_hit_elementwise=(float(flips_plain > 0), flips_plain))
        sizes.update(closest_hit_elementwise=dict(rays=R, plain_rays=got[0].shape[0],
                                                  ms_at_plain_rays=ms_a_sub),
                     any_hit_elementwise=dict(rays=fo.shape[0], plain_rays=got_b.shape[0],
                                              ms_at_plain_rays=ms_b_sub))
    return times, parity, sizes


def streamed_vs_single(name, eps):
    """At 2 clusters a block: streamed K1 (t0 launches) and K2 against one
    launch each on a scene's main-path wavefront and its occlusion rays; on
    glass_teapot also streamed K4, on the main path's census input and on
    the rays re-seated past their hits (t_hit = BIG)."""
    scene, cam = slice_scene(name, WIDTH)
    leaf, aabb = scene.static.cluster_size, scene.cluster_aabb
    tabs = tables(scene)
    n_blocks = mi._blocked(scene.tri_p1, leaf, 2 * leaf)
    o, d = main_path_rays(cam)
    single = mi.mesh_closest_hit(o, d, *tabs, scene.tri_n, aabb, leaf, eps)
    streamed = mi.closest_hit_blocked(o, d, *tabs, aabb, n_blocks, leaf, eps,
                                      tri_n=scene.tri_n)
    _, ties = winners_gate(f"{name} streamed K1", streamed, single)
    same = streamed[1] == single[1]
    check(torch.equal(streamed[2][same], single[2][same]),
          f"{name} streamed K1: normals differ at equal idx")
    fo, fd, fmax = occlusion_rays(scene, o, d, single[0], single[1])
    k2 = (fo, fd, fmax, *tabs, aabb)
    flags_gate(f"{name} streamed K2",
               mi.any_hit_blocked(*k2, n_blocks, leaf, eps, occ=scene.occ),
               mi.mesh_any_hit(*k2, leaf, eps, occ=scene.occ), exact=True)
    line = (f"{name} in {n_blocks} blocks: K1 t bit-equal on {o.shape[0]} rays "
            f"({ties} idx ties across blocks), K2 flags equal on {fo.shape[0]}")
    if scene.static.refr_mesh_obj_ids:
        K = len(scene.static.refr_mesh_obj_ids)
        hit = integrator.closest_hit(scene, o, d, RenderConfig())
        gid = torch.where(hit.is_tri, hit.tri, -2).to(torch.int32).contiguous()
        o2 = (o + d * (torch.where(hit.valid, hit.t, 0.0)[:, None] + 1e-3)).contiguous()
        crossings = 0
        for oo, tt, gg in ((o, hit.t.contiguous(), gid),
                           (o2, torch.full_like(hit.t, BIG), torch.full_like(gid, -2))):
            k4 = (oo, d, tt, gg, *tabs, aabb, scene.tri_cid, K)
            crossings += census_gate(
                f"{name} streamed K4",
                mi.crossing_count_blocked(*k4, n_blocks, leaf, eps, occ=scene.occ),
                mi.mesh_crossing_count(*k4, leaf, eps, occ=scene.occ))[1]
        line += f", K4 counts and latest crossings equal ({crossings} crossings)"
    say("11 streaming", line)


def herd_k2(scene, o, d, n_blocks: int, eps) -> str:
    """K2 on the one-mesh herd's surface shadow rays for its primary rays
    (o, d), the frame's K2 input: streamed (n_blocks launches) and in one
    launch over all its clusters, timed in turns, the flags of both equal
    to the table-order loop's on every ray; the bounds of the function
    (k2_bounds, over the whole table) into the K2 line's herd_* keys.
    Returns the phase's summary."""
    so, sd, smax = surface_shadow_rays(scene, o, d)
    leaf, k2 = scene.static.cluster_size, (so, sd, smax, *tables(scene), scene.cluster_aabb)
    call = lambda: mi.any_hit_blocked(*k2, n_blocks, leaf, eps, occ=scene.occ)
    one = lambda: mi.mesh_any_hit(*k2, leaf, eps, occ=scene.occ)
    mi.reset_launch_counts()
    streamed = call()
    check(mi.LAUNCHES["any_hit"] == n_blocks, f"{mi.LAUNCHES}")
    ms_single, single = timed_ms(one, 1, 5)
    ms_streamed, streamed = timed_ms(call, 1, 5)
    ms_single2, _ = timed_ms(one, 0, 5)
    flags_gate("one-mesh herd streamed K2 vs one launch", streamed, single, exact=True)
    k2_table_order_gate("one-mesh herd streamed K2", scene, streamed, so, sd, smax, eps)
    lesser, old = k2_bounds(scene, so, sd, smax, streamed, eps)
    dev_single = device_ms(one)
    EXTRA.setdefault("any_hit", {}).update(
        herd_rays=so.shape[0], herd_streamed_ms=ms_streamed,
        herd_single_launch_device_ms=dev_single,
        herd_launches_per_call=n_blocks, herd_single_launch_ms=(ms_single + ms_single2) / 2,
        herd_bound_ms=lesser[0], herd_table_order_bound_ms=old[0])
    return (f"K2 on {so.shape[0]} surface shadow rays ({int((smax > 0).sum())} live, "
            f"{int(streamed.sum())} occluded): streamed ({n_blocks} launches) "
            f"{ms_streamed:.3f} ms, one launch {ms_single:.3f} / {ms_single2:.3f} ms "
            f"(dispatch hidden {shown(dev_single)}), "
            f"flags equal to each other and to the table-order loop; bound "
            f"{old[0]:.4f} ms (the table-order loop's tests), {lesser[0]:.4f} ms (the "
            "lesser)")


def phase_streaming(eps):
    """The t0 contract on cow; streamed against single-launch K1, K2 and K4
    on cow and glass_teapot at 2 clusters a block; then the 90-cow one-mesh
    world (11 blocks of rtc_tpu's budget): streamed K1 (t0), K1 uv and K2
    against K7a and K7b on every ray and against their plain versions on
    every 64th, and streamed K1 timed against one K1 launch over all 4,088
    clusters. Returns (times, parity, sizes) of K1 t0 and K1 uv."""
    scene, cam = slice_scene("cow", WIDTH)
    leaf, aabb = scene.static.cluster_size, scene.cluster_aabb
    tabs = tables(scene)
    o, d = main_path_rays(cam)
    t, idx, n = mi.mesh_closest_hit(o, d, *tabs, scene.tri_n, aabb, leaf, eps)
    hit = idx >= 0
    k1 = lambda t0: mi.mesh_closest_hit(o, d, *tabs, scene.tri_n, aabb, leaf, eps,
                                        t0=t0.contiguous())
    low = k1(torch.where(hit, t * 0.5, 1e-3))
    at = k1(torch.where(hit, t, 1e-3))
    for what, out in (("below", low), ("at", at)):
        check(bool((out[1] == -1).all() & (out[0] == BIG).all() & (out[2] == 0).all()),
              f"t0 {what} each hit: a hit was reported")
    high = k1(torch.where(hit, t * 1.5, BIG))
    check(all(torch.equal(a, b) for a, b in zip(high, (t, idx, n))),
          "t0 above each hit: the free winners did not come back exactly")
    say("11 streaming", f"t0 contract on cow's {o.shape[0]} rays ({int(hit.sum())} "
        "hits): a bound below or at each hit reports every lane as a miss, a "
        "bound above it gives back t, idx and n bit for bit")
    for name in ("cow", "glass_teapot"):
        streamed_vs_single(name, eps)

    scene, cam = slice_scene("cow_herd_mesh", WIDTH)
    st = scene.static
    leaf, aabb, sup = st.cluster_size, scene.cluster_aabb, scene.super_aabb
    tabs = tables(scene)
    n_blocks = mi._blocked(scene.tri_p1, leaf, VMEM_TRI_BUDGET)
    check(n_blocks == 11 and st.n_clusters == 4088,
          f"one-mesh herd: {n_blocks} blocks of {st.n_clusters} clusters")
    step = PLAIN_STEPS["cow_herd"]
    sub = lambda x: x[::step].contiguous()
    o, d = main_path_rays(cam)
    k7a = mi.mesh_closest_hit_elementwise(o, d, *tabs, aabb, sup, leaf, eps)
    streamed = lambda: mi.closest_hit_blocked(o, d, *tabs, aabb, n_blocks, leaf, eps,
                                              tri_n=scene.tri_n)
    mi.reset_launch_counts()
    out = streamed()
    check(mi.LAUNCHES["closest_hit_t0"] == n_blocks, f"{mi.LAUNCHES}")
    ms_single, single = timed_ms(lambda: mi.mesh_closest_hit(
        o, d, *tabs, scene.tri_n, aabb, leaf, eps), 1, 3)
    ms_t0, out = timed_ms(streamed, 1, 3)
    DEVICE_MS["closest_hit_t0"] = None  # device_ms: a streamed call waits on the device
    ms_single2, _ = timed_ms(lambda: mi.mesh_closest_hit(
        o, d, *tabs, scene.tri_n, aabb, leaf, eps), 0, 3)
    _, ties_k7a = winners_gate("one-mesh herd streamed K1 vs K7a", out, k7a)
    _, ties_single = winners_gate("one-mesh herd streamed K1 vs one launch", out, single)
    pms_t0, ref = timed_ms(lambda: mi.closest_hit_plain(sub(o), sub(d), *tabs,
                                                       scene.tri_n, eps), 0, 1)
    err_t0, _ = winners_gate("one-mesh herd streamed K1 vs plain",
                             tuple(x[::step] for x in out), ref)
    uv_call = lambda: mi.closest_hit_blocked(o, d, *tabs, aabb, n_blocks, leaf, eps,
                                             want_uv=True)
    ms_uv, uv = timed_ms(uv_call, 1, 3)
    DEVICE_MS["closest_hit_uv"] = None
    _, ties_uv = winners_gate("one-mesh herd streamed K1 uv vs K7a", uv, k7a)
    pms_uv, uv_ref = timed_ms(lambda: mi.closest_hit_uv_plain(sub(o), sub(d), *tabs,
                                                             eps), 0, 1)
    uv_sub = tuple(x[::step] for x in uv)
    err_uv, _ = winners_gate("one-mesh herd streamed K1 uv vs plain", uv_sub, uv_ref)
    same = uv_sub[1] == uv_ref[1]
    check(torch.equal(uv_sub[2][same], uv_ref[2][same]),
          "one-mesh herd streamed K1 uv: (u, v) differ from plain at equal idx")
    fo, fd, fmax = occlusion_rays(scene, o, d, k7a[0], k7a[1])
    k7b = mi.mesh_any_hit_elementwise(fo, fd, fmax, *tabs, aabb, sup, leaf, eps)
    flags_gate("one-mesh herd streamed K2 vs K7b",
               mi.any_hit_blocked(fo, fd, fmax, *tabs, aabb, n_blocks, leaf, eps,
                                  occ=scene.occ), k7b,
               exact=True)
    k2_line = herd_k2(scene, o, d, n_blocks, eps)
    say("11 streaming",
        f"one-mesh 90-cow herd, {n_blocks} blocks of {-(-st.n_clusters // n_blocks)} "
        f"clusters: streamed K1 ({n_blocks} t0 launches) {ms_t0:.3f} ms vs one K1 "
        f"launch over all {st.n_clusters} clusters {ms_single:.3f} / "
        f"{ms_single2:.3f} ms on {o.shape[0]} rays ({int((out[1] >= 0).sum())} "
        f"hits); t bit-equal to K7a ({ties_k7a} idx ties) and to one launch "
        f"({ties_single} ties); on {ref[0].shape[0]} rays vs plain "
        f"{pms_t0:.1f} ms, max|dt| {err_t0:.3g}; streamed K1 uv {ms_uv:.3f} ms, "
        f"t bit-equal to K7a ({ties_uv} ties), (u, v) bit-equal to plain "
        f"({pms_uv:.1f} ms) at equal idx; streamed K2 equal to K7b on "
        f"{fo.shape[0]} occlusion rays; " + k2_line)
    R, t_bytes = o.shape[0], nbytes(*tabs, aabb)
    work, rays, boxes = closest_work(o, d, tabs, aabb, k7a[0], leaf, eps)
    C, L = st.n_clusters, WALK_L["K1"]
    say("11 walk", k1_walk_line(f"one-mesh herd, one K1 launch over {C} clusters",
                                rays, R, C, L))
    counts = torch.bincount(rays * n_blocks + boxes // -(-C // n_blocks),
                            minlength=R * n_blocks).view(R, n_blocks)
    say("11 walk", walk_line(f"one-mesh herd, streamed K1 t0 and uv ({n_blocks} blocks)",
                             {"clusters a ray and block": counts.flatten()},
                             block_census(counts, C, L), L))
    BOUNDS["closest_hit_t0"] = bound(work, nbytes(o, d, scene.tri_n) + t_bytes + R * 20)
    BOUNDS["closest_hit_uv"] = bound(work, nbytes(o, d) + t_bytes + R * 16)
    size = dict(rays=R, plain_rays=ref[0].shape[0], launches_per_call=n_blocks,
                single_launch_ms=(ms_single + ms_single2) / 2)
    return ({"closest_hit_t0": (ms_t0, pms_t0), "closest_hit_uv": (ms_uv, pms_uv)},
            {"closest_hit_t0": (err_t0, None), "closest_hit_uv": (err_uv, None)},
            {"closest_hit_t0": size, "closest_hit_uv": dict(size)})


# the new routes' frames: (scene, canvas width, mesh_impl, launches(tiles))
# (each node's shading stages: cow's two nodes and the blend at its root;
# the herds, teapot and pumpkin one node, K3's flag on the last two)
NEW_FRAMES = {
    "cow elementwise": ("cow", WIDTH, "elementwise",
                        lambda n: {"closest_hit_elementwise": 2 * n,
                                   "any_hit_elementwise": 2 * n, **shading(2 * n, n)}),
    "cow_herd elementwise": ("cow_herd", WIDTH, "elementwise",
                             lambda n: {"closest_hit_elementwise": n,
                                        "any_hit_elementwise": n, **shading(n, 0)}),
    "cow_herd_mesh": ("cow_herd_mesh", WIDTH, "auto",
                      lambda n: {"closest_hit_t0": 11 * n, "any_hit": 11 * n,
                                 **shading(n, 0)}),
    "cow_herd_mesh_smooth": ("cow_herd_mesh_smooth", 480, "auto",
                             lambda n: {"closest_hit_uv": 11 * n, "any_hit": 11 * n,
                                        **shading(n, 0)}),
    "teapot": ("teapot", WIDTH, "auto",
               lambda n: {"closest_shadow": n, **shading(n, 0, 0)}),
    "pumpkin": ("pumpkin", WIDTH, "auto",
                lambda n: {"closest_shadow_sn": n, **shading(n, 0, 0)}),
}
NEW_GOLDENS = {"teapot": (24, 5, (0.99, 2)), "pumpkin": (24, 5, (0.98, 2))}


def phase_new_frames():
    """render() of each new route (NEW_FRAMES) at depth 5, f32, tile
    460,800, with the counts set to 0 just before each frame and read just
    after; then its kernel render against the plain render at 480x240
    (herds 240x120, with the knife-edge budget) and, for teapot and pumpkin,
    the golden-width render against tests/golden. Returns {frame:
    launches}."""
    launches = {}
    q = lambda a: np.clip(np.asarray(a, np.float64) * 255 + 0.5, 0, 255).astype(np.uint8)
    for frame, (name, width, impl, want) in NEW_FRAMES.items():
        scene, cam = slice_scene(name, width)
        n_tiles = -(-cam.hsize * cam.vsize // RAY_TILE)
        cfg = RenderConfig(ray_tile=RAY_TILE, mesh_impl=impl)
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
                  f"{frame} frame: launch counts {counts}, expected {expected}")
        launches[frame] = counts
        check(img.shape == (cam.vsize, cam.hsize, 3), f"{frame}: image shape")
        check(bool(torch.isfinite(img).all()), f"{frame}: non-finite values")
        check(float(img.min()) >= 0.0 and float(img.amax()) > 0.1,
              f"{frame}: image is black or negative")
        st = scene.static
        casts = cam.hsize * cam.vsize * rays_per_pixel(DEPTH, st.any_reflective,
                                                       st.any_refractive)
        wall = sorted(walls)[1]
        line = (f"{frame} {cam.hsize}x{cam.vsize} depth {DEPTH} f32, tile "
                f"{RAY_TILE}: compile {SCENES[name][1]:.2f} s; frame median "
                f"{wall * 1e3:.1f} ms of [{', '.join(f'{w * 1e3:.1f}' for w in walls)}]"
                f" = {casts / wall / 1e6:.1f}M rays/s ({casts} casts); launches "
                f"{ {k: v for k, v in counts.items() if v} }")
        herd = name.startswith("cow_herd")
        gw = 240 if herd else 480
        small, cam_s = slice_scene(name, gw)
        kern = render(small, cam_s, RenderConfig(mesh_impl=impl))
        line += f"; {gw}x{gw // 2} vs plain: " + image_gate(
            f"{frame} {gw}x{gw // 2} vs plain", kern, plain_render(name, gw),
            knife_edges=herd)
        if name in NEW_GOLDENS:
            gwid, depth, (min_frac, flip_budget) = NEW_GOLDENS[name]
            golden = np.load(os.path.join(ROOT, "tests", "golden", f"{name}.npy"))
            tiny, cam_t = slice_scene(name, gwid)
            img32 = render(tiny, cam_t, RenderConfig(ray_tile=512, max_depth=depth)
                           ).cpu().numpy()
            match = float(np.all(q(golden) == q(img32), axis=2).mean())
            flips = int((np.abs(golden - img32).max(axis=2) > 0.15).sum())
            check(match >= min_frac and flips <= flip_budget,
                  f"{name} f32 kernels vs f64 golden: match {match:.4f}, flips {flips}")
            line += (f"; width {gwid} vs tests/golden/{name}.npy (f64): 8-bit "
                     f"match {match:.4f}, structural flips {flips}")
        say("12 new routes", line)
    return launches


# ---------------------------------------------------------------------------
# phase 13: gradients through the kernels (render/integrator.py's autograd
# Functions and diff.render_grad)
# ---------------------------------------------------------------------------

# the target frame: the cow's material colour and light intensity both
# lowered, which darkens the frame by half (most of it scales with their
# product), so ADAM_STEPS steps of both (each moves a parameter by about
# the learning rate) stay on the near side of the optimum; moves of
# opposite sign nearly cancel in the product, and the first step overshoots
PERTURB = {"mat_color": -0.3, "light_intensity": -0.3}
GRAD_TILES = 4              # tiles of the gradient frame, 460,800 rays each
FD_EPS, FD_RTOL = 1e-2, 2e-3
ADAM_LR, ADAM_STEPS = 5e-2, 3
FN_TOL = dict(rtol=1e-3, atol=1e-5)   # tests/test_pallas_mesh.py:109-110
# each Function: its scene and the rays of that scene's wavefront it takes
FUNCTIONS = {"K1 with_n": ("cow", 8192), "K3": ("cow", 8192),
             "K7a": ("cow", 8192), "K1 with_sn": ("teapot_smooth", 8192),
             "K3 with_sn": ("teapot_smooth", 8192),
             "K1 with_uv streamed": ("cow_herd_mesh_smooth", 1024),
             "K5": ("cow_herd", 1024), "K5 with_sn": ("cow_herd_smooth", 1024)}


def frame_tiles(cam, n_tiles: int):
    """The frame's primary rays in block order (as render() generates
    them), cut into n_tiles tiles."""
    px, py = blocked_pixels(cam.vsize, cam.hsize, "cuda")
    o, d = camera_rays_for_pixels(cam.transform_inverse, px, py, cam.half_width,
                                  cam.half_height, cam.pixel_size)
    step = -(-o.shape[0] // n_tiles)
    return [(o[i:i + step].contiguous(), d[i:i + step].contiguous())
            for i in range(0, o.shape[0], step)]


def tiled_loss_and_grad(params, scene, tiles, targets, cfg):
    """The frame's loss_and_grad, one tile at a time (a backward each),
    each tile's loss and gradients weighted by its share of the rays: the
    frame mean's. The loss is accumulated in f64."""
    n = sum(o.shape[0] for o, _ in tiles)
    loss, grads = 0.0, {k: torch.zeros_like(v) for k, v in params.items()}
    for (o, d), target in zip(tiles, targets):
        tile_loss, g = RG.loss_and_grad(params, scene, o, d, target, cfg)
        share = o.shape[0] / n
        loss += share * float(tile_loss)
        for k in grads:
            grads[k] += share * g[k]
    return loss, grads


@torch.no_grad()
def tiled_loss(params, scene, tiles, targets, cfg) -> float:
    """The frame's loss at params, accumulated in f64 (finite differences)."""
    s = RG.inject_params(scene, params)
    total = sum(float(((integrator.color_at(s, o, d, cfg).double() - t) ** 2).sum())
                for (o, d), t in zip(tiles, targets))
    return total / (3 * sum(o.shape[0] for o, _ in tiles))


def rel_norm(a, b) -> float:
    """|a - b| / |b| over all elements (0 where both are zero)."""
    nb = float(b.double().norm())
    return float((a - b).double().norm()) / nb if nb else float((a != b).any())


def wall_s(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def profiled_step(params, scene, o, d, target, cfg) -> dict:
    """One Adam step of the frame, profiled: the device time of its
    forward (render_loss), backward and optimizer update, split at spin
    kernels (torch.cuda._sleep) queued between them, from the kernels
    torch.profiler records (None where it recorded no spin kernel); and the
    CUDA-event time of each part, each ended by a synchronize."""
    from torch.profiler import ProfilerActivity, profile

    names = ("forward", "backward", "update")
    leaves = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
    opt = torch.optim.Adam(leaves.values(), lr=ADAM_LR)
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        marks[0].record()
        loss = RG.render_loss(leaves, scene, o, d, target, cfg)
        marks[1].record()
        torch.cuda.synchronize()
        torch.cuda._sleep(1000)
        loss.backward()
        marks[2].record()
        torch.cuda.synchronize()
        torch.cuda._sleep(1000)
        opt.step()
        marks[3].record()
        torch.cuda.synchronize()
    ops = sorted(profiling.device_ops(prof.events()), key=lambda e: e.time_range.start)
    device, k = dict.fromkeys(names, 0.0), 0
    for e in ops:
        if "spin" in e.name:
            k += 1
        elif k < len(names):
            device[names[k]] += e.time_range.elapsed_us() / 1e3
    busy = sum(device.values()) if k == len(names) - 1 else 0.0
    return {"event_ms": {n: marks[i].elapsed_time(marks[i + 1]) for i, n in enumerate(names)},
            "device_busy_ms": device if busy else None,
            "backward_share_of_device": device["backward"] / busy if busy else None}


def function_case(name, s, eps):
    """(Function, kernel search, plain search, differentiable tables, lead
    arguments) of one autograd Function on scene s, as the integrator
    routes it; the plain search is the kernel's plain version."""
    leaf, I = s.static.cluster_size, integrator
    flat = (s.tri_p1, s.tri_e1, s.tri_e2)
    if name == "K7a":
        return (I.KernelClosest, lambda *x: mi.mesh_closest_hit_elementwise(
            *x, s.cluster_aabb, s.super_aabb, leaf, eps),
            lambda *x: mi._closest_plain(*x, eps), flat, ())
    if name == "K1 with_n":
        return (I.KernelClosestN, lambda *x: mi.mesh_closest_hit(
            *x, s.cluster_aabb, leaf, eps), lambda *x: mi.closest_hit_plain(*x, eps),
            (*flat, s.tri_n), ())
    if name == "K1 with_uv streamed":
        n_blocks = mi._blocked(s.tri_p1, leaf, VMEM_TRI_BUDGET)
        return (I.KernelClosestUv, lambda *x: mi.closest_hit_blocked(
            *x, s.cluster_aabb, n_blocks, leaf, eps, want_uv=True),
            lambda *x: mi.closest_hit_uv_plain(*x, eps), flat, ())
    if name == "K1 with_sn":
        return (I.KernelClosestSn, lambda *x: mi.mesh_closest_hit_sn(
            *x, s.cluster_aabb, leaf, eps), lambda *x: mi.closest_hit_sn_plain(*x, eps),
            (*flat, I.corner_normals(s)), ())
    if name == "K3":
        return (I.KernelClosestShadow, lambda *x: mi.mesh_closest_shadow(
            *x, s.cluster_aabb, s.light_pos, leaf, eps, occ=s.occ),
            lambda *x: mi.closest_shadow_plain(*x, s.light_pos, eps), (*flat, s.tri_n), ())
    if name == "K3 with_sn":
        return (I.KernelClosestShadowSn, lambda *x: mi.mesh_closest_shadow_sn(
            *x, s.cluster_aabb, s.light_pos, leaf, eps, occ=s.occ),
            lambda *x: mi.closest_shadow_sn_plain(*x, s.light_pos, eps),
            (*flat, I.corner_normals(s)), ())
    tl, st = s.tlas, s.static
    smooth = name == "K5 with_sn"
    kernel = mi.mesh_closest_hit_tlas_sn if smooth else mi.mesh_closest_hit_tlas
    plain = mi.closest_hit_tlas_sn_plain if smooth else mi.closest_hit_tlas_plain
    rest = (tl.inst_aabb, tl.inst_mesh, tl.inst_obj, leaf, st.tlas_cm, eps)
    return ((I.KernelClosestTlasSn if smooth else I.KernelClosestTlas),
            lambda o, d, p1, e1, e2, n, ab: kernel(o, d, p1, e1, e2, n, tl.caabb, ab, *rest),
            lambda o, d, p1, e1, e2, n, ab: plain(o, d, p1, e1, e2, n, ab, *rest),
            (tl.p1, tl.e1, tl.e2, tl.sn if smooth else tl.n, tl.inst_ab),
            (st.tlas_cm * leaf, tl.inst_mesh))


def function_loss(outs, w, keep):
    """sum(t on hits) + sum(n * w) (uv * w for K1 with_uv), over keep."""
    loss = torch.where(keep & (outs[1] >= 0), outs[0], 0.0).sum()
    for vec in (y for y in outs[2:] if y.is_floating_point()):
        loss = loss + torch.where(keep[:, None], vec * w[:, :vec.shape[1]], 0.0).sum()
    return loss


def function_rays(scene, cam, n: int, search, tabs):
    """n rays of the scene's 460,800-ray wavefront: 7/8 of them evenly over
    the rays the kernel finds a hit for, the rest over its misses."""
    o, d = main_path_rays(cam)
    with torch.no_grad():
        hit = search(o, d, *tabs)[1] >= 0
    pick = []
    for rays, k in ((torch.nonzero(hit)[:, 0], n - n // 8), (torch.nonzero(~hit)[:, 0], n // 8)):
        pick.append(rays[torch.linspace(0, rays.numel() - 1, k, device="cuda").long()])
    sel = torch.cat(pick)
    return o[sel].contiguous(), d[sel].contiguous()


def plain_reference(plain, inputs, w, keep, rows: int):
    """Autograd through the dense plain sweep, in f64 on the same f32
    values, over chunks of rays (the loss is a sum over rays) so the
    graph's (rays, rows) intermediates stay near 2^25 elements."""
    xs = [x.detach().double().requires_grad_() for x in inputs]
    o, d, tabs = xs[0], xs[1], xs[2:]
    grads = [torch.zeros_like(x) for x in xs]
    step = max(1, (1 << 25) // rows)
    for s in range(0, o.shape[0], step):
        part = slice(s, s + step)
        loss = function_loss(plain(o[part], d[part], *tabs), w[part].double(), keep[part])
        for g, gk in zip(grads, torch.autograd.grad(loss, xs, allow_unused=True)):
            if gk is not None:
                g += gk
    return grads


def function_gate(name, eps) -> dict:
    """One Function with its kernel as the forward against autograd through
    the dense plain sweep (plain_reference), on its scene's rays."""
    scene_name, n = FUNCTIONS[name]
    scene, cam = slice_scene(scene_name, WIDTH)
    fn, kernel, plain, tabs, lead = function_case(name, scene, eps)
    o, d = function_rays(scene, cam, n, kernel, tabs)
    with torch.no_grad():
        won = kernel(o, d, *tabs)[1]
        step = max(1, (1 << 25) // tabs[0].shape[0])
        ref_won = torch.cat([plain(o[s:s + step].double(), d[s:s + step].double(),
                                   *(x.double() for x in tabs))[1]
                             for s in range(0, n, step)])
    keep = won == ref_won
    check(float(keep.float().mean()) > 0.99,
          f"{name}: kernel and f64 plain winners differ on {int((~keep).sum())} of {n}")
    w = torch.randn((n, 3), generator=torch.Generator("cuda").manual_seed(0), device="cuda")
    xs = [x.detach().clone().requires_grad_() for x in (o, d, *tabs)]
    mi.reset_launch_counts()
    outs = fn.apply(kernel, eps, *lead, *xs)
    launched = {k: v for k, v in mi.LAUNCHES.items() if v}
    check(bool(launched), f"{name}: the Function launched no kernel")
    got = torch.autograd.grad(function_loss(outs, w, keep), xs)
    rows = tabs[0].shape[0]
    if lead:  # K5's plain version sweeps each real instance's mesh
        rows *= int((scene.tlas.inst_aabb[:, 0] <= scene.tlas.inst_aabb[:, 3]).sum())
    ref = plain_reference(plain, (o, d, *tabs), w, keep, rows)
    errs = []
    for k, (a, b) in enumerate(zip(got, ref)):
        b = b.float()
        bad = ~torch.isclose(a, b, **FN_TOL)
        check(not bool(bad.any()), f"{name}: input {k} gradients differ from plain on "
              f"{int(bad.sum())} elements, max |diff| {float((a - b).abs().max()):.3g}")
        errs.append(float((a - b).abs().max()))
    check(any(float(g.abs().sum()) > 0 for g in got[2:]), f"{name}: no table gradient")
    return dict(scene=scene_name, rays=n, hits=int((won >= 0).sum()),
                winners_compared=int((keep & (won >= 0)).sum()), launches=launched,
                max_abs_err=max(errs))


def vertex_update_gate(scene, cam, eps) -> dict:
    """inject_params moving the triangles of the 4 clusters the cow's
    wavefront hits most: on the new scene K3's closest hits and shadow
    flags equal the plain sweep's on the new rows (flags within the
    knife-edge budget of phase 3, and equal to K2's on K3's own shadow
    rays); the rows swapped in without the rebuild (stale boxes and
    occlusion tables) miss that."""
    leaf = scene.static.cluster_size
    o, d = main_path_rays(cam)
    o, d = o[::8].contiguous(), d[::8].contiguous()
    idx = mi.mesh_closest_hit(o, d, *tables(scene), scene.tri_n, scene.cluster_aabb,
                              leaf, eps)[1]
    seen = torch.bincount(idx[idx >= 0].long() // leaf).argsort(descending=True)[:4]
    rows = (seen[:, None] * leaf + torch.arange(leaf, device="cuda")).flatten()
    p1 = scene.tri_p1.clone()
    p1[rows] += torch.tensor([0.0, 0.3, -0.2], device="cuda")
    new = RG.inject_params(scene, {"tri_p1": p1})
    ref = mi.closest_shadow_plain(o, d, *tables(new), new.tri_n, new.light_pos, eps)
    hits = int((ref[1] >= 0).sum())

    def k3(s):
        return mi.mesh_closest_shadow(o, d, *tables(s), s.tri_n, s.cluster_aabb,
                                      s.light_pos, leaf, eps, occ=s.occ)

    got = k3(new)
    closest_gate("vertex update K3", got, ref)
    flips = int((got[3] != ref[3]).sum())
    check(flips <= max(2, hits // 1000),
          f"vertex update: K3's shadow flags differ from plain on {flips} of {hits} hits")
    so, sd, max_t = k3_shadow_rays(scene, o, d, eps, got)
    k3_flags_gate("vertex update K3", got[3],
                  mi.mesh_any_hit(so, sd, max_t, *tables(new), new.cluster_aabb, leaf,
                                  eps, occ=new.occ), max_t)
    stale = k3(dataclasses.replace(scene, tri_p1=p1))
    stale_gaps = int((stale[1] != ref[1]).sum() + (stale[3] != ref[3]).sum())
    check(stale_gaps > max(2, hits // 1000),
          f"vertex update: stale tables differ from plain on only {stale_gaps} rays")
    return dict(rays=o.shape[0], hits=hits, moved_rows=rows.numel(), flag_flips=flips,
                stale_table_gaps=stale_gaps)


# the object rows' sum on the main path's inputs: glass_teapot's whole
# frame, the fit cells' view (2 objects), and one cow tile of RAY_TILE rays
# (1 object), with the fit cells' parameters (rtbench/traffic/fit.json),
# which take the shading kernels under autograd: each call is a node's
# backward (integrator.KernelShadeNode), the per-ray partials of the
# object's colour row and of the light's intensity, 3 columns each
ROWS_FRAMES = {"glass_teapot": 1, "cow": GRAD_TILES}
ROWS_PARAMS = ("mat_color", "light_intensity")
ROWS_TOL = 4e-6  # of an entry's sum of |g| (tests/test_torch_cuda.py)


def object_rows_gate() -> dict:
    """The object rows' sum on the inputs the main path hands it: every
    call in one eager loss_and_grad of each ROWS_FRAMES frame (an eager
    call: a capture's copies would hold no values). Each call's kernel
    against the float64 sum within ROWS_TOL of its entry's sum of |g|, and
    two runs bit-equal; the largest call timed against its plain version
    (object_rows_sum_plain), index_add_ (the one PyTorch call that sums
    the same) and its bound: the ids (with two objects or more) and the
    gradients read once, the tables written. Returns its kernels line:
    glass_teapot's numbers, and cow's under cow_*."""
    real, taken = mi.object_rows_sum, []

    def keep(ids, grads, n_rows):
        taken.append((ids, [g.clone() for g in grads], n_rows))
        return real(ids, grads, n_rows)

    line = {"name": "object rows' sum (the shading backward's per-object sum)",
            "route": "cuda", "source": SOURCE,
            "replaces": "index_add_ (the same sum by object in one PyTorch call)",
            "frame": "glass_teapot fit", "flips": None, "pair_tests": None}
    for name, n_tiles in ROWS_FRAMES.items():
        scene, cam = slice_scene(name, WIDTH)
        o, d = frame_tiles(cam, n_tiles)[0]
        params = RG.extract_params(scene, ROWS_PARAMS)
        taken.clear()
        mi.reset_launch_counts()
        mi.object_rows_sum = keep
        try:
            RG._loss_and_grad(params, scene, o, d, torch.full_like(o, 0.5), RenderConfig())
        finally:
            mi.object_rows_sum = real
        launches = dict(mi.LAUNCHES)["object_rows"]
        check(launches == len(taken) > 0, f"object rows on {name}: {launches} launches "
              f"for {len(taken)} calls")
        errs = []
        for ids, grads, n_rows in taken:
            check(n_rows == scene.static.n_objects and ids.shape[0] <= o.shape[0],
                  f"object rows on {name}: {n_rows} rows, {ids.shape[0]} rays")
            got, again = real(ids, grads, n_rows), real(ids, grads, n_rows)
            exact = mi.object_rows_sum_plain(ids, [g.double() for g in grads], n_rows)
            scale = mi.object_rows_sum_plain(ids, [g.double().abs() for g in grads], n_rows)
            for a, b, x, m in zip(got, again, exact, scale):
                check(torch.equal(a, b), f"object rows on {name}: two runs differ")
                err = (a.double() - x).abs()
                check(bool((err <= ROWS_TOL * m).all()), f"object rows on {name}: "
                      f"max |kernel - f64| {float(err.max()):.3g} past {ROWS_TOL} of sum |g|")
                errs.append(float(err.max()))
        ids, grads, n_rows = max(taken, key=lambda c: c[0].shape[0])
        R = ids.shape[0]

        def index_add():
            return [g.new_zeros((n_rows, *g.shape[1:])).index_add_(0, ids, g)
                    for g in grads]

        ms, plain_ms, _, _ = time_pair(lambda: real(ids, grads, n_rows),
                                       lambda: mi.object_rows_sum_plain(ids, grads, n_rows),
                                       plain_warmup=2, plain_iters=10)
        library_ms = timed_ms(index_add, 2, 10)[0]
        columns = sum(g[0].numel() for g in grads)
        b = bound(Work((R * columns, 0, 0)),
                  (nbytes(ids) if n_rows > 1 else 0) + nbytes(*grads) + 4 * n_rows * columns)
        got = dict(launches=launches, calls_compared=len(taken), max_abs_err=max(errs),
                   ms=ms, device_ms=device_ms(lambda: real(ids, grads, n_rows)),
                   plain_ms=plain_ms, library_ms=library_ms, bound_ms=b[0], bound_by=b[1],
                   rays=R, plain_rays=R, rows=n_rows, columns=columns)
        line.update(got if name == "glass_teapot" else {f"cow_{k}": v for k, v in got.items()})
        say("13 gradients", f"object rows' sum on {name}: {len(taken)} calls of {R} rays x "
            f"{n_rows} rows x {columns} columns, max |kernel - f64| {max(errs):.3g}, two runs "
            f"bit-equal; kernel {shown(ms)} (device {shown(got['device_ms'])}), plain "
            f"{shown(plain_ms)}, index_add_ {shown(library_ms)}, bound {shown(b[0])}")
    return line


def phase_gradients(eps):
    """The gradient path on the card. (a) The cow frame at 1920x960, depth
    5, f32, mesh_impl="kernel", fused K3: loss_and_grad of the mean squared
    error against a target rendered with PERTURB, in GRAD_TILES tiles of
    460,800 rays (K3 launched on both bounce nodes of every tile under
    autograd), against the whole frame in one call, the split route (K1 +
    K2), and central finite differences; then ADAM_STEPS Adam steps of
    make_train_step, and one profiled step; its tri_p1 parameters and its
    default Adam (capturable=False) take the eager route by rule, which
    compiled.ROUTES must show. (b) Each autograd Function with its kernel
    against the dense plain sweep (function_gate). (c) The vertex update
    (vertex_update_gate). (d) The object rows' sum on the main path's
    inputs (object_rows_gate), whose line the kernels' record takes.
    Returns the "grads" record."""
    scene, cam = slice_scene("cow", WIDTH)
    compiled.ROUTES.clear()
    fused = RenderConfig(ray_tile=RAY_TILE, mesh_impl="kernel")
    split = RenderConfig(ray_tile=RAY_TILE, mesh_impl="kernel", fused_shadow=False)
    tiles = frame_tiles(cam, GRAD_TILES)
    check(len(tiles) == GRAD_TILES and all(o.shape[0] == RAY_TILE for o, _ in tiles),
          "gradient tiles")
    base = RG.extract_params(scene)
    moved = {k: base[k].detach() + v for k, v in PERTURB.items()}
    with torch.no_grad():
        target_scene = RG.inject_params(scene, moved)
        targets = [integrator.color_at(target_scene, o, d, fused) for o, d in tiles]
    params = RG.extract_params(scene, RG.DEFAULT_PARAMS + ("tri_p1",))
    render(scene, cam, fused)
    forward_s = sorted(wall_s(lambda: render(scene, cam, fused))[0] for _ in range(3))

    tiled_loss_and_grad(params, scene, tiles, targets, fused)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    mi.reset_launch_counts()
    lg_s, (loss, grads) = wall_s(lambda: tiled_loss_and_grad(params, scene, tiles,
                                                             targets, fused))
    launches = dict(mi.LAUNCHES)
    tiled_peak = torch.cuda.max_memory_allocated()
    lg2_s, _ = wall_s(lambda: tiled_loss_and_grad(params, scene, tiles, targets, fused))
    want = dict(dict.fromkeys(mi.LAUNCHES, 0), closest_shadow=2 * GRAD_TILES,
                object_rows=2 * GRAD_TILES)
    check(launches == want, f"gradient frame: launch counts {launches}, expected {want}")
    for k, g in grads.items():
        check(bool(torch.isfinite(g).all()), f"gradient of {k} is not finite")
    check(float(grads["tri_p1"].abs().sum()) > 0, "tri_p1's gradient is zero")

    fd = {}
    for name, index in (("mat_color", (0, 0)), ("light_intensity", (0,))):
        at = []
        for sign in (1, -1):
            p = {k: v.detach().clone() for k, v in params.items()}
            p[name][index] += sign * FD_EPS
            at.append(tiled_loss(p, scene, tiles, targets, fused))
        fd_val = (at[0] - at[1]) / (2 * FD_EPS)
        ad = float(grads[name][index])
        check(abs(ad - fd_val) <= FD_RTOL * abs(fd_val),
              f"{name}{list(index)}: autograd {ad} vs finite difference {fd_val}")
        fd[f"{name}{list(index)}"] = {"autograd": ad, "finite_difference": fd_val}

    mi.reset_launch_counts()
    loss_s, grads_s = tiled_loss_and_grad(params, scene, tiles, targets, split)
    want = dict(dict.fromkeys(mi.LAUNCHES, 0), closest_hit=2 * GRAD_TILES,
                any_hit=2 * GRAD_TILES, object_rows=2 * GRAD_TILES)
    check(dict(mi.LAUNCHES) == want, f"split gradient frame: launch counts {mi.LAUNCHES}")
    check(loss_s == loss, f"split loss {loss_s} != fused loss {loss}")
    for k in RG.DEFAULT_PARAMS:
        check(torch.allclose(grads_s[k], grads[k], rtol=1e-5, atol=1e-10),
              f"split vs fused gradient of {k}: rel {rel_norm(grads_s[k], grads[k]):.3g}")
    split_tri = rel_norm(grads_s["tri_p1"], grads["tri_p1"])
    check(split_tri <= 1e-5, f"split vs fused gradient of tri_p1: rel {split_tri:.3g}")

    o_all = torch.cat([o for o, _ in tiles])
    d_all = torch.cat([d for _, d in tiles])
    t_all = torch.cat(targets)
    torch.cuda.reset_peak_memory_stats()
    one_s, (loss_one, grads_one) = wall_s(lambda: RG.loss_and_grad(
        params, scene, o_all, d_all, t_all, fused))
    one_peak = torch.cuda.max_memory_allocated()
    one_rel = {k: rel_norm(grads_one[k], grads[k]) for k in grads}
    check(max(one_rel.values()) <= 1e-5 and abs(float(loss_one) - loss) <= 1e-6 * loss,
          f"one-call frame vs tiles: loss {float(loss_one)} vs {loss}, gradients {one_rel}")

    trained = RG.extract_params(scene, tuple(PERTURB))
    step = RG.make_train_step(torch.optim.Adam(trained.values(), lr=ADAM_LR), fused)
    torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    for _ in range(ADAM_STEPS):
        sec, val = wall_s(lambda: step(trained, scene, o_all, d_all, t_all))
        losses.append(float(val))
        step_s.append(sec)
    step_peak = torch.cuda.max_memory_allocated()
    with torch.no_grad():
        losses.append(float(RG.render_loss(trained, scene, o_all, d_all, t_all, fused)))
    check(all(b < a for a, b in zip(losses, losses[1:])),
          f"Adam steps: the loss did not fall at each step: {losses}")
    prof = profiled_step(RG.extract_params(scene, tuple(PERTURB)), scene, o_all, d_all,
                         t_all, fused)
    routes = dict(compiled.ROUTES)
    want = {"loss_and_grad: " + compiled.step_route(scene, fused, params),
            "train_step: " + compiled.step_route(
                scene, fused, trained, torch.optim.Adam(trained.values()))}
    check(set(routes) == want and all(": eager: " in k for k in want),
          f"the gradient path's routes {routes}, expected {want}")

    functions = {name: function_gate(name, eps) for name in FUNCTIONS}
    vertex = vertex_update_gate(scene, cam, eps)
    rows = object_rows_gate()
    gib = 2 ** 30
    record = {
        "frame": f"cow {WIDTH}x{HEIGHT} depth {DEPTH} f32 kernel fused, "
                 f"{GRAD_TILES} tiles of {RAY_TILE}",
        "forward_frame_ms": [x * 1e3 for x in forward_s],
        "loss_and_grad_frame_ms": [lg_s * 1e3, lg2_s * 1e3],
        "loss_and_grad_one_call_ms": one_s * 1e3,
        "train_step_ms": [x * 1e3 for x in step_s],
        "peak_gib": {"loss_and_grad_tiles": tiled_peak / gib,
                     "loss_and_grad_one_call": one_peak / gib,
                     "train_step_one_call": step_peak / gib},
        "launches": {k: v for k, v in launches.items() if v},
        "loss": loss, "finite_differences": fd,
        "split_vs_fused_tri_p1_rel": split_tri,
        "one_call_vs_tiles_rel_max": max(one_rel.values()),
        "adam_losses": losses, "profiled_step": prof, "routes": routes,
        "functions": functions, "vertex_update": vertex, "object_rows": rows}
    say("13 gradients",
        f"{record['frame']}: forward frame (render, no_grad) "
        f"{forward_s[1] * 1e3:.1f} ms; loss_and_grad {lg_s * 1e3:.1f} / "
        f"{lg2_s * 1e3:.1f} ms (one call {one_s * 1e3:.1f} ms); train step "
        f"{', '.join(f'{x * 1e3:.1f}' for x in step_s)} ms; peak "
        f"{tiled_peak / gib:.2f} GiB tiled, {one_peak / gib:.2f} one call, "
        f"{step_peak / gib:.2f} a step; K3 launches {launches['closest_shadow']}; "
        f"finite differences {fd}; split == fused (tri_p1 rel {split_tri:.2g}); "
        f"Adam losses {losses}; profiled step {prof}; routes {routes}")
    for name, r in functions.items():
        say("13 gradients", f"{name} on {r['scene']}: {r['rays']} rays, {r['hits']} hits, "
            f"{r['winners_compared']} compared; gradients vs f64 plain max|diff| "
            f"{r['max_abs_err']:.3g}; launches {r['launches']}")
    say("13 gradients", f"vertex update: {vertex}")
    return record


# ---------------------------------------------------------------------------
# phase 14: the entry point on the card (python -m rtc_tpu_torch), the PPM
# writer, progressive rendering and the prim-only scenes
# ---------------------------------------------------------------------------

CLI_DIR = os.path.join(ROOT, "build", "cli")
# each CLI subprocess: (scene, extra arguments): cow at the shading tile of
# the frames above, glass_teapot as a user calls it (the default tile)
CLI_RUNS = {"cow_tile_460800": ("cow", ["--ray-tile", str(RAY_TILE), "--report"]),
            "glass_teapot": ("glass_teapot", ["--report"])}
CLI_TIMEOUT = 300  # seconds a CLI subprocess may take
# the six scenes that hold no triangle; tests/test_golden.py's (width,
# depth) and F32_BUDGET for each; square scenes at width x width
PRIM_GOLDENS = {"hexagon": (32, 5, (0.95, 16)), "table": (32, 5, (0.99, 0)),
                "single_sphere": (24, 5, (1.0, 0)),
                "three_spheres": (32, 5, (0.99, 1)),
                "glass_spheres": (32, 5, (0.98, 2)),
                "default_world": (24, 5, (1.0, 0))}
PRIM_FRAMES = 7  # timed frames a prim-only scene, after one warm-up


def quantized(img) -> np.ndarray:
    """The PPM's 0..255 values of an image: clamped and rounded half away
    from zero in float64 (io/canvas.py)."""
    a = img.detach().cpu().numpy().astype(np.float64) if torch.is_tensor(img) else img
    return np.floor(np.clip(a, 0.0, 1.0) * 255.0 + 0.5).astype(np.int64)


def ppm_values(data: bytes, width: int, height: int) -> np.ndarray:
    header = f"P3\n{width} {height}\n255\n".encode()
    check(data.startswith(header), f"PPM header {data[:24]!r}, expected {header!r}")
    check(data.endswith(b"\n"), "PPM lacks its trailing newline")
    check(max(len(ln) for ln in data.split(b"\n")) <= 70, "PPM line over 70 characters")
    values = np.array(data[len(header):].split(), dtype=np.int64)
    check(values.size == width * height * 3, f"PPM holds {values.size} values")
    return values.reshape(height, width, 3)


def ppm_gate(what: str, got: np.ndarray, img) -> str:
    """PPM values against an image rendered here: equal on every pixel, or
    else image_gate's knife-edge budget on the values / 255, with the
    count of pixels that differ."""
    want = quantized(img)
    differ = int((got != want).any(axis=2).sum())
    if differ == 0:
        return "bit-equal after quantization"
    gate = image_gate(what, torch.from_numpy(got / 255.0), torch.from_numpy(want / 255.0),
                      knife_edges=True)
    return f"{differ} pixels differ after quantization; {gate}"


def cli_run(key: str, name: str, extra) -> tuple:
    """`python -m rtc_tpu_torch <file> 1920 --scene name *extra` in a
    subprocess; its exit code must be 0. Returns the PPM's values, the
    report (or None) and the process's wall seconds."""
    path = os.path.join(CLI_DIR, f"{key}.ppm")
    if os.path.exists(path):
        os.remove(path)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "rtc_tpu_torch", path, str(WIDTH),
                           "--scene", name, *extra], cwd=ROOT, capture_output=True,
                          text=True, timeout=CLI_TIMEOUT)
    seconds = time.perf_counter() - t0
    check(proc.returncode == 0, f"CLI {key}: exit {proc.returncode}: "
          f"{(proc.stdout + proc.stderr)[-2000:]}")
    report = (json.loads(proc.stderr.strip().splitlines()[-1])
              if "--report" in extra else None)
    with open(path, "rb") as f:
        values = ppm_values(f.read(), WIDTH, HEIGHT)
    return values, report, seconds


def golden_gate(name: str, width: int, depth: int, budget) -> str:
    """The f32 render on the card at tests/test_golden.py's width and depth
    against the f64 golden, under F32_BUDGET."""
    min_frac, flip_budget = budget
    golden = np.load(os.path.join(ROOT, "tests", "golden", f"{name}.npy"))
    tiny, cam_t = slice_scene(name, width)
    img32 = render(tiny, cam_t, RenderConfig(ray_tile=512, max_depth=depth)).cpu().numpy()
    check(img32.shape == golden.shape, f"{name}: golden shape {golden.shape}")
    q = lambda a: np.clip(np.asarray(a, np.float64) * 255 + 0.5, 0, 255).astype(np.uint8)
    match = float(np.all(q(golden) == q(img32), axis=2).mean())
    flips = int((np.abs(golden - img32).max(axis=2) > 0.15).sum())
    check(match >= min_frac and flips <= flip_budget,
          f"{name} f32 vs f64 golden: match {match:.4f}, flips {flips}")
    return (f"{cam_t.hsize}x{cam_t.vsize} vs tests/golden/{name}.npy (f64): 8-bit "
            f"match {match:.4f} (min {min_frac}), structural flips {flips} "
            f"(budget {flip_budget})")


def phase_cli() -> dict:
    """The port's entry point as a user runs it: `python -m rtc_tpu_torch`
    in a subprocess (CLI_RUNS), each PPM held to render() of the same scene
    and config in this process; the PPM writers timed on the cow frame;
    the CLI's main path (`python -m rtc_tpu_torch out.ppm 1920`: cow at the
    default tile) called in this process with the counts set to 0 just
    before it and read just after (two renders: time_render's first and
    its timed one); the cow's render_with_checkpoints frame, counted the
    same way, against render(); and the six prim-only scenes at their
    golden widths under F32_BUDGET and at width 1920 timed, with their
    peak memory, the prim kernel's launches (both modes once a shading
    node, nothing else) and the image bit-equal to the plain render
    (mesh_impl="bruteforce"). Returns the `cli` record."""
    from rtc_tpu_torch import cli
    from rtc_tpu_torch import native
    from rtc_tpu_torch.io.canvas import Canvas, write_ppm
    from rtc_tpu_torch.render.progressive import render_with_checkpoints

    os.makedirs(CLI_DIR, exist_ok=True)
    record = {"runs": {}}
    for key, (name, extra) in CLI_RUNS.items():
        values, report, seconds = cli_run(key, name, extra)
        scene, cam = slice_scene(name, WIDTH)
        tile = int(extra[extra.index("--ray-tile") + 1]) if "--ray-tile" in extra \
            else RenderConfig().ray_tile
        img = render(scene, cam, RenderConfig(ray_tile=tile))
        gate = ppm_gate(f"CLI {key}", values, img)
        record["runs"][key] = {"scene": name, "ray_tile": tile,
                               "process_s": seconds, "report": report, "ppm": gate}
        say("14 cli", f"python -m rtc_tpu_torch <file> {WIDTH} --scene {name} "
            f"{' '.join(extra)}: exit 0 in {seconds:.1f} s; report {report}; "
            f"PPM against render() here: {gate}")

    # the PPM writers on the cow frame: the C++ encoder (write_ppm) and the
    # Python writer, each from the tensor on the card
    scene, cam = slice_scene("cow", WIDTH)
    img = render(scene, cam, RenderConfig(ray_tile=RAY_TILE))
    torch.cuda.synchronize()
    paths = {k: os.path.join(CLI_DIR, f"writer_{k}.ppm") for k in ("native", "python")}
    t0 = time.perf_counter()
    write_ppm(img, paths["native"])
    native_s = time.perf_counter() - t0
    check(native.encode_ppm(np.zeros((1, 1, 3))) is not None,
          "native/librtc_native.so did not load: write_ppm took the Python writer")
    t0 = time.perf_counter()
    with open(paths["python"], "w") as f:
        Canvas.from_image(img).write_ppm(f)
    python_s = time.perf_counter() - t0
    files = {}
    for k, path in paths.items():
        with open(path, "rb") as f:
            files[k] = f.read()
    check(files["native"] == files["python"], "the two PPM writers' bytes differ")
    write_gate = ppm_gate("write_ppm", ppm_values(files["native"], WIDTH, HEIGHT), img)
    record["ppm_write_s"] = {"native": native_s, "python": python_s,
                             "bytes": len(files["native"])}
    say("14 cli", f"PPM write of the cow frame ({len(files['native'])} bytes): native "
        f"{native_s:.3f} s, Python {python_s:.3f} s, same bytes; {write_gate}")

    # the main path through the entry point, in this process
    path = os.path.join(CLI_DIR, "main_path.ppm")
    stderr = io.StringIO()
    mi.reset_launch_counts()
    with contextlib.redirect_stderr(stderr):
        rc = cli.main([path, str(WIDTH), "--report"])
    counts = dict(mi.LAUNCHES)
    check(rc == 0, f"cli.main returned {rc}")
    n_tiles = -(-WIDTH * HEIGHT // RenderConfig().ray_tile)
    expected = dict(dict.fromkeys(mi.LAUNCHES, 0), closest_shadow=2 * 2 * n_tiles,
                    **shading(2 * 2 * n_tiles, 2 * n_tiles, 0))
    check(counts == expected, f"CLI main path: launch counts {counts}, expected {expected}")
    report = json.loads(stderr.getvalue().strip().splitlines()[-1])
    with open(path, "rb") as f:
        gate = ppm_gate("CLI main path", ppm_values(f.read(), WIDTH, HEIGHT),
                        render(scene, cam, RenderConfig()))
    record["main_path"] = {"launches": {k: v for k, v in counts.items() if v},
                           "report": report, "ppm": gate}
    EXTRA.setdefault("closest_shadow", {})["cli_launches"] = counts["closest_shadow"]
    say("14 cli", f"cli.main([file, '{WIDTH}', '--report']) here: launches "
        f"{record['main_path']['launches']} (2 renders x 2 nodes x {n_tiles} tiles); "
        f"report {report}; PPM against render(): {gate}")

    # progressive: the cow frame in scanline tiles with a checkpoint
    ck = os.path.join(CLI_DIR, "cow_progressive.npz")
    if os.path.exists(ck):
        os.remove(ck)
    cfg = RenderConfig(ray_tile=RAY_TILE)
    mi.reset_launch_counts()
    t0 = time.perf_counter()
    flat = render_with_checkpoints(scene, cam, cfg, checkpoint_path=ck)
    progressive_s = time.perf_counter() - t0
    counts = dict(mi.LAUNCHES)
    n_tiles = -(-WIDTH * HEIGHT // RAY_TILE)
    expected = dict(dict.fromkeys(mi.LAUNCHES, 0), closest_shadow=2 * n_tiles,
                    **shading(2 * n_tiles, n_tiles, 0))
    check(counts == expected, f"progressive frame: launch counts {counts}, "
          f"expected {expected}")
    check(flat.shape == (HEIGHT, WIDTH, 3) and bool(np.isfinite(flat).all()),
          "progressive frame: shape or non-finite values")
    with np.load(ck) as saved:
        check(int(saved["next_tile"]) == n_tiles, "progressive checkpoint incomplete")
    gate = ppm_gate("progressive", quantized(flat), render(scene, cam, cfg))
    record["progressive"] = {"s": progressive_s, "launches": counts["closest_shadow"],
                             "ppm": gate}
    say("14 cli", f"render_with_checkpoints, cow {WIDTH}x{HEIGHT} tile {RAY_TILE}: "
        f"{progressive_s:.3f} s, K3 {counts['closest_shadow']} launches; against "
        f"render(): {gate}")

    # the prim-only scenes: the prim kernel sweeps them (Plan.prims), both
    # modes once a shading node, and nothing else launches but each node's
    # shading stages (the blend at a tile's root where the scene branches)
    record["prim_scenes"] = {}
    for name, (gw, depth, budget) in PRIM_GOLDENS.items():
        gate = golden_gate(name, gw, depth, budget)
        scene, cam = slice_scene(name, WIDTH)
        cfg = RenderConfig(ray_tile=RAY_TILE)
        render(scene, cam, cfg)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        n_tiles = -(-cam.hsize * cam.vsize // RAY_TILE)
        branching = n_tiles if scene.static.any_reflective or scene.static.any_refractive else 0
        walls = []
        for _ in range(PRIM_FRAMES):
            mi.reset_launch_counts()
            t0 = time.perf_counter()
            img = render(scene, cam, cfg)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            counts = dict(mi.LAUNCHES)
            nodes = counts["prim_closest"]
            check(nodes >= 1 and counts == dict(
                      dict.fromkeys(mi.LAUNCHES, 0), prim_closest=nodes, prim_any=nodes,
                      **shading(nodes, branching)),
                  f"{name}: a prim-only frame launched {counts}")
        peak = torch.cuda.max_memory_allocated()
        plain = render(scene, cam, dataclasses.replace(cfg, mesh_impl="bruteforce"))
        check(torch.equal(img, plain), f"{name}: the prim kernel's frame differs from "
              "the plain render's")
        check(img.shape == (cam.vsize, cam.hsize, 3), f"{name}: image shape")
        check(bool(torch.isfinite(img).all()), f"{name}: non-finite values")
        check(float(img.min()) >= 0.0 and float(img.amax()) > 0.1,
              f"{name}: image is black or negative")
        st = scene.static
        casts = cam.hsize * cam.vsize * rays_per_pixel(DEPTH, st.any_reflective,
                                                       st.any_refractive)
        median = sorted(walls)[len(walls) // 2]
        record["prim_scenes"][name] = {
            "width": cam.hsize, "height": cam.vsize, "n_prims": st.n_prims,
            "frame_ms": [w * 1e3 for w in walls], "median_ms": median * 1e3,
            "casts": casts, "rays_per_s": casts / median, "peak_bytes": peak,
            "compile_s": SCENES[name][1], "golden": gate,
            "launches": {k: v for k, v in counts.items() if v}}
        say("14 prim-only scenes",
            f"{name} {cam.hsize}x{cam.vsize} depth {DEPTH} f32, tile {RAY_TILE}, "
            f"{st.n_prims} prims: frame median {median * 1e3:.1f} ms of "
            f"[{', '.join(f'{w * 1e3:.1f}' for w in walls)}] = "
            f"{casts / median / 1e6:.1f}M rays/s ({casts} casts); peak "
            f"{peak / 2**30:.2f} GiB; launches { {k: v for k, v in counts.items() if v} }, "
            f"bit-equal to the plain render; {gate}")
    return record


# ---------------------------------------------------------------------------
# phase 15: sharded rendering over a rank grid (rtc_tpu_torch.parallel)
# ---------------------------------------------------------------------------

PARALLEL_DIR = os.path.join(ROOT, "build", "parallel")
PARALLEL_TIMEOUT = 300  # seconds a grid of ranks may take, start-up included
PARALLEL_FRAMES = 3     # timed frames a rank, after a warm-up and the counted one
SMALL_WIDTH = 480       # the NCCL render's and the train step's canvas
# the grids, each in its own process group: (ranks, backend). Several ranks
# share the one card over gloo (NCCL refuses two ranks on one device);
# NCCL gets the 1x1 grid
GRIDS = {"cow 2x2": (4, "gloo"), "glass_teapot 1x2": (2, "gloo"),
         "1x1 nccl": (1, "nccl")}
# the sharded train step against the single-rank loss_and_grad, in f32
# over 115,200 rays summed in another order: the loss within a relative
# 1e-5, each gradient within 1e-4 of its largest magnitude
# (tests/multihost_worker.py's gate)
TRAIN_LOSS_RTOL, TRAIN_GRAD_TOL = 1e-5, 1e-4


def sharded_frames(key, scene, cam, cfg, mesh, rank, shard_prims=True) -> dict:
    """render_sharded of scene on this rank: a warm-up, a frame run with
    the kernels' and the collectives' counts set to 0 just before it and
    read just after (its image saved for the parent), then PARALLEL_FRAMES
    timed frames, each started together by a barrier."""
    import torch.distributed as dist
    from rtc_tpu_torch.parallel import collectives as coll
    from rtc_tpu_torch.parallel.shard import render_sharded

    render_sharded(scene, cam, cfg, mesh, shard_prims)
    torch.cuda.synchronize()
    dist.barrier()
    mi.reset_launch_counts()
    coll.reset_collective_counts()
    img = render_sharded(scene, cam, cfg, mesh, shard_prims)
    torch.cuda.synchronize()
    out = dict(launches=dict(mi.LAUNCHES), collectives=dict(coll.COLLECTIVES),
               collective_bytes=dict(coll.COLLECTIVE_BYTES), explicit_host_copies=0)
    check(img.device.type == "cuda", f"{key}: the image is on {img.device}")
    np.save(os.path.join(PARALLEL_DIR, f"{key.replace(' ', '_')}_r{rank}.npy"),
            img.cpu().numpy())
    walls = []
    for _ in range(PARALLEL_FRAMES):
        dist.barrier()
        t0 = time.perf_counter()
        render_sharded(scene, cam, cfg, mesh, shard_prims)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return dict(out, frame_ms=walls, median_ms=sorted(walls)[len(walls) // 2])


def sharded_census(scene, cam, mesh, eps) -> dict:
    """On one tile of glass_teapot's primary rays (main_path_rays): the
    prim-sharded closest hit (t bit-equal to one rank's K1 on the whole
    table) and the census of the shard reduced over 'prims'
    (integrator.mesh_census: K4 on the shard's own tables, the counts
    summed and the latest crossings maxed) against one K4 launch on the
    whole table, exactly, with the main path's input and with the rays
    re-seated past their hit."""
    from rtc_tpu_torch.parallel import mesh as grid
    from rtc_tpu_torch.parallel.shard import prim_shard

    prims = grid.mesh_axis(mesh, "prims")
    shard = prim_shard(scene, prims.rank, prims.size)  # the frames' shard
    o, d = main_path_rays(cam)
    sharded = RenderConfig(prim_axis="prims")
    whole = integrator.closest_hit(scene, o, d, RenderConfig())
    with grid.active_grid(mesh):
        hit = integrator.closest_hit(shard, o, d, sharded)
    check(torch.equal(hit.t, whole.t), "sharded closest hit: t differs from one K1")
    ties = int((hit.tri != whole.tri).sum())
    live = hit.valid & (integrator.object_record(scene, hit.obj)["transparency"] > 0.0)
    gid = torch.where(hit.is_tri, hit.tri, -2).to(torch.int32)
    o2 = (o + d * (torch.where(hit.valid, hit.t, 0.0)[:, None] + 1e-3)).contiguous()
    out = dict(rays=o.shape[0], tri_ties=ties)
    K = len(scene.static.refr_mesh_obj_ids)
    for key, (oo, tt, gg) in (
            ("main path", (o, torch.where(live, hit.t, -BIG), gid)),
            ("re-seated", (o2, torch.full_like(hit.t, BIG), torch.full_like(gid, -2)))):
        tt, gg = tt.contiguous(), gg.contiguous()
        with grid.active_grid(mesh):
            cnt, last = integrator.mesh_census(shard, oo, d, tt, gg, sharded)
        ref = mi.mesh_crossing_count(oo, d, tt, gg, *tables(scene), scene.cluster_aabb,
                                     scene.tri_cid, K, scene.static.cluster_size, eps,
                                     occ=scene.occ)
        census_gate(f"sharded census, {key}", (cnt, last), ref)
        out[key] = int(cnt.sum())
    return out


def parallel_worker(argv) -> int:
    """One rank of a phase-15 grid: python3 chip_smoke.py --parallel-worker
    <grid> <rank> <port>. Prints its record as a PARALLEL_RESULT line."""
    import torch.distributed as dist
    from rtc_tpu_torch.parallel import mesh as grid
    from rtc_tpu_torch.parallel import multihost

    key, rank, port = argv[0], int(argv[1]), argv[2]
    world, backend = GRIDS[key]
    check(torch.cuda.is_available(), f"rank {rank} of {key} found no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    multihost.initialize(f"localhost:{port}", world, rank, backend=backend)
    try:
        out = dict(grid=key, rank=rank, backend=dist.get_backend())
        cfg = RenderConfig(ray_tile=RAY_TILE)
        if key == "cow 2x2":
            scene, cam = slice_scene("cow", WIDTH)
            mesh = grid.make_mesh(2, 2)
            out.update(place=[mesh.get_local_rank("rays"), mesh.get_local_rank("prims")],
                       **sharded_frames(key, scene, cam, cfg, mesh, rank))
        elif key == "glass_teapot 1x2":
            scene, cam = slice_scene("glass_teapot", WIDTH)
            mesh = grid.make_mesh(1, 2)
            out.update(place=[0, mesh.get_local_rank("prims")],
                       **sharded_frames(key, scene, cam, cfg, mesh, rank))
            out["census"] = sharded_census(scene, cam, mesh, RenderConfig().epsilon)
            scene, cam = slice_scene("cow", SMALL_WIDTH)
            t0 = time.perf_counter()
            loss, grads = multihost.train_step_multihost(scene, cam, RenderConfig())
            torch.cuda.synchronize()
            out["train_step"] = dict(s=time.perf_counter() - t0, loss=loss)
            np.savez(os.path.join(PARALLEL_DIR, f"train_step_r{rank}.npz"),
                     **{k: g.cpu().numpy() for k, g in grads.items()})
        else:
            scene, cam = slice_scene("cow", SMALL_WIDTH)
            mesh = grid.single_device_mesh()
            out.update(sharded_frames(key, scene, cam, RenderConfig(), mesh, rank,
                                      shard_prims=False))
            ref = render(scene, cam, RenderConfig())
            got = np.load(os.path.join(PARALLEL_DIR, f"1x1_nccl_r{rank}.npy"))
            out["bit_equal"] = bool(np.array_equal(got, ref.cpu().numpy()))
        print("PARALLEL_RESULT " + json.dumps(out), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_grid(key: str) -> list:
    """Start every rank of grid key on the card and wait for all of them;
    a rank that fails or passes PARALLEL_TIMEOUT fails the phase (all its
    ranks are stopped). Returns the ranks' records."""
    world, _ = GRIDS[key]
    port = str(free_port())
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--parallel-worker", key, str(rank), port],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, cwd=ROOT) for rank in range(world)]
    outs = []
    deadline = time.monotonic() + PARALLEL_TIMEOUT
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        raise SmokeFailure(f"{key}: a rank passed {PARALLEL_TIMEOUT} s:\n"
                           + "\n".join(o[-3000:] for o in outs))
    records = []
    for rank, (p, text) in enumerate(zip(procs, outs)):
        lines = [ln for ln in text.splitlines() if ln.startswith("PARALLEL_RESULT ")]
        check(p.returncode == 0 and len(lines) == 1,
              f"{key}: rank {rank} exited {p.returncode}:\n{text[-4000:]}")
        records.append(json.loads(lines[0][len("PARALLEL_RESULT "):]))
    return records


def single_frames(name: str, width: int, cfg):
    """render() of name at width on this one rank: a warm-up, the counted
    frame and PARALLEL_FRAMES timed ones. Returns (image, launches, ms)."""
    scene, cam = slice_scene(name, width)
    render(scene, cam, cfg)
    torch.cuda.synchronize()
    mi.reset_launch_counts()
    img = render(scene, cam, cfg)
    torch.cuda.synchronize()
    counts = dict(mi.LAUNCHES)
    walls = []
    for _ in range(PARALLEL_FRAMES):
        t0 = time.perf_counter()
        render(scene, cam, cfg)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return img, counts, walls


def phase_parallel() -> dict:
    """rtc_tpu_torch.parallel on the card: cow at 1920x960, depth 5, f32 on
    a 2x2 grid of ranks (rays dealt in Morton tiles over 'rays', the
    triangle table cut in two over 'prims', K1 and K2 on each shard's own
    tables) and glass_teapot on a 1x2 grid (K1 with_sn, K2 and K4 on the
    shards), every rank on the one card over gloo, each image against the
    single-rank kernel render under the knife-edge budget; glass_teapot's
    sharded closest hit and reduced K4 census against one rank's K1 and K4
    on one tile, exactly; train_step_multihost on 2 ranks (cow at 480x240)
    against the single-rank loss_and_grad of DEFAULT_PARAMS; and a 1x1
    grid on NCCL whose render_sharded of cow at 480x240 equals render()
    bit for bit. Each rank's launches come from its counted frame, the
    counts set to 0 just before it. Returns the "parallel" record."""
    os.makedirs(PARALLEL_DIR, exist_ok=True)
    cfg = RenderConfig(ray_tile=RAY_TILE)
    record = {"card": CARD, "frames": PARALLEL_FRAMES}
    single = {"cow 2x2": single_frames("cow", WIDTH, cfg),
              "glass_teapot 1x2": single_frames("glass_teapot", WIDTH, cfg)}
    torch.cuda.empty_cache()
    n_tiles = -(-WIDTH * HEIGHT // RAY_TILE)
    # cow over 2 rays ranks: Morton tiles of RAY_TILE dealt two ways, so a
    # rank shades half the tiles; two nodes (the root and its reflection),
    # each a K1 and a K2 on the shard, no K3 under the prim axis, and its
    # shading stages, the blend at the root
    local_tiles = -(-n_tiles // 2)
    expected = {"cow 2x2": dict(dict.fromkeys(mi.LAUNCHES, 0), closest_hit=2 * local_tiles,
                                any_hit=2 * local_tiles,
                                **shading(2 * local_tiles, local_tiles)),
                "glass_teapot 1x2": single["glass_teapot 1x2"][1]}
    for key in ("cow 2x2", "glass_teapot 1x2"):
        ranks = run_grid(key)
        ref, single_launches, single_ms = single[key]
        gates, images = [], []
        for r in ranks:
            img = torch.from_numpy(np.load(os.path.join(
                PARALLEL_DIR, f"{key.replace(' ', '_')}_r{r['rank']}.npy"))).to(ref.device)
            images.append(img)
            gates.append(image_gate(f"{key} rank {r['rank']}", img, ref, knife_edges=True))
            check(r["backend"] == "gloo", f"{key}: backend {r['backend']}")
            check(r["launches"] == expected[key],
                  f"{key} rank {r['rank']}: launches {r['launches']}, expected "
                  f"{expected[key]}")
        check(all(torch.equal(images[0], im) for im in images[1:]),
              f"{key}: the ranks' images differ")
        single_median = sorted(single_ms)[len(single_ms) // 2]
        record[key] = dict(ranks=ranks, image_gates=gates, single_rank_frame_ms=single_ms,
                           single_rank_median_ms=single_median,
                           single_rank_launches={k: v for k, v in single_launches.items() if v})
        for r, gate in zip(ranks, gates):
            say("15 parallel",
                f"{key} rank {r['rank']} (rays {r['place'][0]}, prims {r['place'][1]}, "
                f"gloo on cuda:0): launches "
                f"{ {k: v for k, v in r['launches'].items() if v} }; frame median "
                f"{r['median_ms']:.1f} ms of [{', '.join(f'{w:.1f}' for w in r['frame_ms'])}]; "
                f"collectives {r['collectives']} ({r['collective_bytes']} bytes), "
                f"explicit host copies 0 (gloo takes the CUDA tensors); image vs "
                f"the single-rank render: {gate}")
        say("15 parallel", f"{key}: the single-rank render() of the same frame: median "
            f"{single_median:.1f} ms of [{', '.join(f'{w:.1f}' for w in single_ms)}], "
            f"launches { {k: v for k, v in single_launches.items() if v} }")
        if key == "glass_teapot 1x2":
            for r in ranks:
                c = r["census"]
                check(c["re-seated"] > 0, "sharded census: no crossing counted")
                say("15 parallel",
                    f"glass_teapot rank {r['rank']}: sharded closest hit on {c['rays']} "
                    f"rays, t bit-equal to one K1 ({c['tri_ties']} winners differ at "
                    f"ties); reduced K4 counts exact against one K4 on the whole table: "
                    f"main path {c['main path']} crossings, re-seated {c['re-seated']}")

    # the train step on 2 ranks (run by the glass_teapot grid's ranks)
    scene, cam = slice_scene("cow", SMALL_WIDTH)
    o, d = camera_rays(cam.transform_inverse, cam.hsize, cam.vsize, cam.half_width,
                       cam.half_height, cam.pixel_size, device="cuda")
    t0 = time.perf_counter()
    loss, grads = RG.loss_and_grad(RG.extract_params(scene), scene, o, d,
                                   torch.full_like(o, 0.5), RenderConfig())
    torch.cuda.synchronize()
    single_s = time.perf_counter() - t0
    errs = {}
    for r in record["glass_teapot 1x2"]["ranks"]:
        got = r["train_step"]["loss"]
        check(abs(got - float(loss)) <= TRAIN_LOSS_RTOL * abs(float(loss)),
              f"train step rank {r['rank']}: loss {got} against {float(loss)}")
        with np.load(os.path.join(PARALLEL_DIR, f"train_step_r{r['rank']}.npz")) as f:
            check(set(f.files) == set(grads), f"train step: gradients of {f.files}")
            for k, g in grads.items():
                ref = g.cpu().numpy()
                err = float(np.abs(f[k] - ref).max()) / max(float(np.abs(ref).max()), 1e-30)
                check(err <= TRAIN_GRAD_TOL, f"train step rank {r['rank']}: {k} off by "
                      f"{err:.3g} of its largest magnitude")
                errs[k] = max(errs.get(k, 0.0), err)
    record["train_step"] = dict(loss=float(loss), single_rank_s=single_s,
                                rank_s=[r["train_step"]["s"] for r in
                                        record["glass_teapot 1x2"]["ranks"]],
                                grad_rel_err=errs)
    say("15 parallel", f"train_step_multihost, 2 ranks on 'rays', cow {SMALL_WIDTH}x"
        f"{SMALL_WIDTH // 2}: loss {float(loss):.6g} as the single-rank loss_and_grad "
        f"(rtol {TRAIN_LOSS_RTOL}), gradients within "
        f"{max(errs.values()):.3g} of their largest magnitudes (limit {TRAIN_GRAD_TOL}); "
        f"{record['train_step']['rank_s']} s a rank, {single_s:.3f} s single-rank")

    nccl = run_grid("1x1 nccl")[0]
    check(nccl["backend"] == "nccl", f"1x1 grid: backend {nccl['backend']}")
    check(nccl["bit_equal"], "1x1 NCCL grid: render_sharded differs from render()")
    record["1x1 nccl"] = nccl
    say("15 parallel", f"1x1 grid on NCCL: render_sharded of cow {SMALL_WIDTH}x"
        f"{SMALL_WIDTH // 2} equals render() bit for bit; launches "
        f"{ {k: v for k, v in nccl['launches'].items() if v} }, collectives "
        f"{nccl['collectives']}, frame median {nccl['median_ms']:.1f} ms")
    for key, kernels in (("cow 2x2", ("closest_hit", "any_hit")),
                         ("glass_teapot 1x2", ("closest_hit_sn", "any_hit",
                                               "crossing_count"))):
        for k in kernels:
            EXTRA.setdefault(k, {}).setdefault("sharded_launches", {})[key] = [
                r["launches"][k] for r in record[key]["ranks"]]
    return record


# ---------------------------------------------------------------------------
# phase 16: the book API on the card (intersect_all, hit_index, testing.py)
# ---------------------------------------------------------------------------

BOOK_TILE = 8192   # rays a tile of intersect_all on cow's triangle table
BOOK_K = 8         # the lists' length there
BOOK_WIDTH = 1920  # default_world's square frame
BOOK_SAMPLES = 64  # pixels of color_at_single and points of is_shadowed
WHITE = (1.0, 1.0, 1.0)
S2 = math.sqrt(2.0)


def _inside_light_world():
    w = default_world()
    w.light = PointLight((0.0, 0.25, 0.0), WHITE)
    return w


def _shadowed_pair_world():
    return World(objects=[sphere(), sphere(transform=X.translation(0, 0, 10))],
                 light=PointLight((0, 0, -10), WHITE))


def _floor_world(reflective=0.5, transparency=0.0):
    """default_world with tests/test_world.py's floor plane, and with a
    transparent floor its red ball below."""
    w = default_world()
    w.objects.append(plane(transform=X.translation(0, -1, 0), material=Material(
        reflective=reflective, transparency=transparency,
        refractive_index=1.5 if transparency else 1.0)))
    if transparency:
        w.objects.append(sphere(transform=X.translation(0, -3.5, -0.5),
                                material=Material(color=(1.0, 0.0, 0.0), ambient=0.5)))
    return w


def _refracted_ray_world():
    w = default_world()
    w.objects[0].material.ambient = 1.0
    w.objects[0].material.pattern = test_pattern()
    w.objects[1].material.transparency = 1.0
    w.objects[1].material.refractive_index = 1.5
    return w


# tests/test_world.py's shade_hit cases: world, origin, direction, t, prim, color
BOOK_SHADE_HIT = {
    "an intersection": (default_world, [0, 0, -5], [0, 0, 1], 4.0, 0,
                        [0.38066, 0.47583, 0.2855]),
    "from the inside": (_inside_light_world, [0, 0, 0], [0, 0, 1], 0.5, 1,
                        [0.90498, 0.90498, 0.90498]),
    "in shadow": (_shadowed_pair_world, [0, 0, 5], [0, 0, 1], 4.0, 1, [0.1, 0.1, 0.1]),
    "reflective": (lambda: _floor_world(0.5), [0, 0, -3], [0, -S2 / 2, S2 / 2], S2, 2,
                   [0.87675, 0.92434, 0.82918]),
    "transparent": (lambda: _floor_world(0.0, 0.5), [0, 0, -3], [0, -S2 / 2, S2 / 2], S2,
                    2, [0.93642, 0.68642, 0.68642]),
    "reflective transparent": (lambda: _floor_world(0.5, 0.5), [0, 0, -3],
                               [0, -S2 / 2, S2 / 2], S2, 2, [0.93391, 0.69643, 0.69243]),
}
# tests/test_intersections.py:132-150: origin, direction, t, reflectance, tolerance
BOOK_SCHLICK = {"total internal reflection": ([0, 0, S2 / 2], [0, 1, 0], S2 / 2, 1.0, 0.0),
                "perpendicular": ([0, 0, 0], [0, 1, 0], 1.0, 0.04, 1e-5),
                "small angle, n2 > n1": ([0, 0.99, -2], [0, 0, 1], 1.8589, 0.48873, 1e-5)}


def book_gate(what: str, got, want, eps: float) -> float:
    err = float(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max())
    check(err < eps, f"{what}: {np.asarray(got).tolist()} against the book's {want} "
          f"(|err| {err:.3g}, tolerance {eps})")
    return err


def book_sweep(scene, o, d, eps) -> dict:
    """hit_index(intersect_all(...)) on cow's main-path wavefront in tiles
    of BOOK_TILE rays, against one K1 with_n launch on every ray."""
    cfg = RenderConfig()
    R = o.shape[0]
    ts, objs = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s in range(0, R, BOOK_TILE):
        xs = integrator.intersect_all(scene, o[s:s + BOOK_TILE], d[s:s + BOOK_TILE], cfg,
                                      k=BOOK_K)
        i = integrator.hit_index(xs)
        pick = i.clamp_min(0).long()[:, None]
        ts.append(torch.where(i >= 0, xs.t.gather(1, pick)[:, 0], BIG))
        objs.append(torch.where(i >= 0, xs.obj.gather(1, pick)[:, 0], -1))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    t, obj = torch.cat(ts), torch.cat(objs)
    kt, kidx, _ = mi.mesh_closest_hit(o, d, *tables(scene), scene.tri_n, scene.cluster_aabb,
                                      scene.static.cluster_size, eps)
    hit = obj >= 0
    check(torch.equal(hit, kidx >= 0),
          f"intersect_all vs K1: hit masks differ on {int((hit != (kidx >= 0)).sum())} rays")
    check(bool((t[~hit] == kt[~hit]).all()), "intersect_all vs K1: miss t is not BIG")
    max_dt = float((t - kt).abs()[hit].max()) if bool(hit.any()) else 0.0
    check(max_dt <= 1e-3, f"intersect_all vs K1: t diverges, max |dt| {max_dt}")
    check(torch.equal(obj[hit], scene.tri_obj[kidx[hit].long()]),
          "intersect_all vs K1: the hit's object is not the kernel winner's")
    return dict(rays=R, tiles=-(-R // BOOK_TILE), tile=BOOK_TILE, k=BOOK_K, wall_s=wall,
                peak_gib=peak, hits=int(hit.sum()), max_dt=max_dt,
                bit_equal=int((t == kt).sum()), bit_equal_hits=int((t == kt)[hit].sum()))


def book_prims(dtype) -> dict:
    """intersect_all and hit_index on default_world's whole primary frame
    against closest_hit: t and obj exactly equal (both the least t >= 0
    over the same candidates, ties to the first slot)."""
    cam = Camera(BOOK_WIDTH, BOOK_WIDTH, math.pi / 2)
    cam.set_transform(X.view_transform([0, 0, -5], [0, 0, 0], [0, 1, 0]))
    inv = torch.tensor(cam.transform_inverse, dtype=dtype, device="cuda")
    o, d = camera_rays(inv, cam.hsize, cam.vsize, cam.half_width, cam.half_height,
                       cam.pixel_size, dtype)
    check(o.is_cuda and d.is_cuda, "camera_rays: a card matrix gave rays off the card")
    scene = compile_scene(default_world(), dtype=dtype, device="cuda")
    cfg = RenderConfig(dtype=str(dtype).split(".")[-1])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    xs = integrator.intersect_all(scene, o, d, cfg)
    i = integrator.hit_index(xs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ref = integrator.closest_hit(scene, o, d, cfg)
    hit = i >= 0
    pick = i.clamp_min(0).long()[:, None]
    t, obj = xs.t.gather(1, pick)[:, 0], xs.obj.gather(1, pick)[:, 0]
    name = f"default_world {BOOK_WIDTH}x{BOOK_WIDTH} {dtype}"
    check(torch.equal(hit, ref.valid), f"{name}: hit masks differ on "
          f"{int((hit != ref.valid).sum())} rays")
    check(torch.equal(t[hit], ref.t[hit]), f"{name}: hit t differs from closest_hit")
    check(torch.equal(obj[hit], ref.obj[hit]), f"{name}: hit object differs from closest_hit")
    return dict(rays=o.shape[0], slots=xs.t.shape[1], hits=int(hit.sum()), wall_s=wall)


def phase_book(eps) -> dict:
    """The book API (rtc_tpu_torch.testing, intersect_all, hit_index) on
    the card. hit_index(intersect_all(...)) on the cow's 460,800-ray
    main-path wavefront (1920x960, f32) in tiles of BOOK_TILE rays, held
    to one K1 with_n launch on every ray (closest_gate's rules: equal hit
    masks, |dt| <= 1e-3, the winner's object), with the bit-equal rays
    counted; on default_world's 1920x1920 primary frame in f32 and f64,
    held to closest_hit exactly; the book's world numbers through the
    testing helpers in f64 (color_at, six shade_hit cases, the refracted
    ray, the three Schlick cases) at each test's tolerance; and the
    kernels through the helpers in f32 on cow: color_at_single on
    BOOK_SAMPLES pixels against render()'s pixels (K3), is_shadowed on
    BOOK_SAMPLES surface points against one K2 launch on them (K2), with
    the launches of both counted from counts set to 0 just before.
    Returns the "book" record."""
    record = {"card": CARD}
    scene, cam = cow_scene(WIDTH)
    o, d = main_path_rays(cam)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sweep = record["cow"] = book_sweep(scene, o, d, eps)
    say("16 book", f"cow: hit_index(intersect_all(k={BOOK_K})) on the {sweep['rays']}-ray "
        f"main-path wavefront in {sweep['tiles']} tiles of {BOOK_TILE}: "
        f"{sweep['wall_s']:.3f} s wall, peak {sweep['peak_gib']:.2f} GiB; against one K1 "
        f"with_n launch: {sweep['hits']} hits, max |dt| {sweep['max_dt']:.3g}, "
        f"{sweep['bit_equal']} of {sweep['rays']} rays bit-equal "
        f"({sweep['bit_equal_hits']} of the hits)")
    torch.cuda.empty_cache()
    for dtype in (torch.float32, torch.float64):
        p = record[f"default_world {str(dtype).split('.')[-1]}"] = book_prims(dtype)
        say("16 book", f"default_world {BOOK_WIDTH}x{BOOK_WIDTH} {dtype}: intersect_all "
            f"+ hit_index on {p['rays']} rays x {p['slots']} slots in {p['wall_s']:.3f} s; "
            f"t and obj equal to closest_hit's on all {p['hits']} hits")
        torch.cuda.empty_cache()

    errs = {"color_at": book_gate("color_at_single", testing.color_at_single(
        compile_scene(default_world(), dtype=torch.float64), [0, 0, -5], [0, 0, 1]),
        [0.38066, 0.47583, 0.2855], 1e-5)}
    for case, (world, origin, direction, t, prim, want) in BOOK_SHADE_HIT.items():
        errs[f"shade_hit {case}"] = book_gate(f"shade_hit {case}", testing.shade_hit(
            compile_scene(world(), dtype=torch.float64), origin, direction, t, prim), want,
            1e-5)
    errs["refracted_color"] = book_gate("refracted_color with a refracted ray",
                                        testing.refracted_color(
        compile_scene(_refracted_ray_world(), dtype=torch.float64), [0, 0, 0.1], [0, 1, 0],
        0.4899, 1, 5), [0.0, 0.99888, 0.04721], 1e-4)
    glass = compile_scene(World(objects=[glass_sphere()]), dtype=torch.float64)
    for case, (origin, direction, t, want, tol) in BOOK_SCHLICK.items():
        c = testing.comps_at(glass, origin, direction, t)
        cos, n1, n2 = (torch.tensor([v], dtype=torch.float64, device="cuda")
                       for v in (float(np.dot(c.eyev, c.normalv)), c.n1, c.n2))
        r = float(integrator.schlick(cos, n1, n2)[0])
        if tol:
            errs[f"schlick {case}"] = book_gate(f"schlick {case}", r, want, tol)
        else:
            check(r == want, f"schlick {case}: {r}, the book's {want} exactly")
            errs[f"schlick {case}"] = 0.0
    record["book_max_err"] = errs
    say("16 book", f"the book's numbers through testing.py in f64 on the card: color_at, "
        f"{len(BOOK_SHADE_HIT)} shade_hit cases, the refracted ray (1e-4) and "
        f"{len(BOOK_SCHLICK)} Schlick cases; largest error {max(errs.values()):.3g}")

    # the kernels through the helpers, f32 on cow
    img = render(scene, cam, RenderConfig(ray_tile=RAY_TILE))
    rng = np.random.default_rng(16)
    lit = torch.nonzero(img.sum(2).flatten() > 0)[:, 0].cpu().numpy()
    pix = torch.as_tensor(rng.choice(lit, BOOK_SAMPLES, replace=False), device="cuda")
    px, py = pix % cam.hsize, pix // cam.hsize
    po, pd = camera_rays_for_pixels(cam.transform_inverse, px, py, cam.half_width,
                                    cam.half_height, cam.pixel_size)
    _, over, live = surface_points(scene, o, d, RenderConfig())
    direction, distance = integrator.shadow_query(scene, over, live)
    flags = mi.mesh_any_hit(over.contiguous(), direction.contiguous(), distance.contiguous(),
                            *tables(scene), scene.cluster_aabb, scene.static.cluster_size,
                            eps, occ=scene.occ)
    live_ids = torch.nonzero(live)[:, 0].cpu().numpy()
    shadowed = flags[torch.as_tensor(live_ids, device="cuda")].cpu().numpy()
    half = BOOK_SAMPLES // 2
    pick = np.concatenate([rng.choice(live_ids[shadowed], half, replace=False),
                           rng.choice(live_ids[~shadowed], BOOK_SAMPLES - half, replace=False)])
    pts = over[torch.as_tensor(pick, device="cuda")]

    mi.reset_launch_counts()
    colors = np.stack([testing.color_at_single(scene, po[j].tolist(), pd[j].tolist(),
                                               dtype=torch.float32)
                       for j in range(BOOK_SAMPLES)])
    k3 = mi.LAUNCHES["closest_shadow"]
    helper_flags = np.array([testing.is_shadowed(scene, pts[j].tolist(), dtype=torch.float32)
                             for j in range(BOOK_SAMPLES)])
    launches = dict(mi.LAUNCHES)
    k2 = launches["any_hit"]
    check(k3 >= 1, f"color_at_single on cow launched K3 {k3} times")
    check(k2 >= 1, f"is_shadowed on cow launched K2 {k2} times")
    # a sample's two nodes (K3 each, its flag: no surface launch), the
    # blend at its root
    check(launches == dict(dict.fromkeys(mi.LAUNCHES, 0), closest_shadow=k3, any_hit=k2,
                           **shading(k3, BOOK_SAMPLES, 0)),
          f"the helpers launched {launches}")
    want = img[py, px].cpu().numpy()
    bad = int((colors != want).any(1).sum())
    check(bad == 0, f"color_at_single differs from render() on {bad} of {BOOK_SAMPLES} "
          f"pixels, max {float(np.abs(colors - want).max()):.3g}")
    pdir, pdist = integrator.shadow_query(scene, pts)
    k2_flags = mi.mesh_any_hit(pts.contiguous(), pdir.contiguous(), pdist.contiguous(),
                               *tables(scene), scene.cluster_aabb, scene.static.cluster_size,
                               eps, occ=scene.occ).cpu().numpy()
    flips = int((helper_flags != k2_flags).sum())
    check(flips == 0, f"is_shadowed differs from K2 on {flips} of {BOOK_SAMPLES} points")
    check(int(k2_flags.sum()) == half, f"K2 shadows {int(k2_flags.sum())} of the {half} "
          "points it shadowed on the whole wavefront")
    record["helpers"] = dict(pixels=BOOK_SAMPLES, points=BOOK_SAMPLES,
                             shadowed=int(k2_flags.sum()), launches={"K3": k3, "K2": k2})
    EXTRA.setdefault("closest_shadow", {})["book_launches"] = k3
    EXTRA.setdefault("any_hit", {})["book_launches"] = k2
    say("16 book", f"f32 on cow: color_at_single on {BOOK_SAMPLES} pixels equals render()'s "
        f"bit for bit ({k3} K3 launches); is_shadowed on {BOOK_SAMPLES} surface points "
        f"({half} shadowed) equals one K2 launch's flags ({k2} K2 launches)")
    return record


# ---------------------------------------------------------------------------
# phase 17: the tools (rtc_tpu_torch/tools), as a user runs them
# ---------------------------------------------------------------------------

TOOLS_TIMEOUT = 600     # seconds the bench subprocess may take
SWEEP_LEAFS = (64, 256)  # the cow frames held to the leaf-128 image
DRYRUN_RANKS = 4


def tool_process(module: str, *args) -> tuple:
    """python -m rtc_tpu_torch.tools.<module> args in a subprocess:
    (stdout lines, stderr lines, seconds); a nonzero exit raises."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", f"rtc_tpu_torch.tools.{module}", *args],
                          cwd=ROOT, capture_output=True, text=True, timeout=TOOLS_TIMEOUT)
    seconds = time.perf_counter() - t0
    check(proc.returncode == 0, f"tools.{module} {' '.join(args)} exited "
          f"{proc.returncode}:\n{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    return proc.stdout.splitlines(), proc.stderr.splitlines(), seconds


def in_process(fn, *args) -> tuple:
    """fn(*args) with its standard output captured, then printed: (result,
    the JSON lines it printed, seconds)."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    print(buf.getvalue(), end="", flush=True)
    lines = [json.loads(ln) for ln in buf.getvalue().splitlines() if ln.startswith("{")]
    return out, lines, seconds


# the routes of the kernels the cow frames do not run, each at leaf 64 and
# 256 against leaf 128: (world, width, mesh_impl, the kernels it launches,
# the herds' knife-edge budget)
LEAF_ROUTES = {
    "glass_teapot": ("glass_teapot", 480, "auto",
                     ("closest_hit_sn", "any_hit", "crossing_count"), False),
    "cow_herd_smooth": ("cow_herd_smooth", 240, "auto",
                        ("closest_hit_tlas_sn", "any_hit_tlas"), True),
    "cow elementwise": ("cow", 480, "elementwise",
                        ("closest_hit_elementwise", "any_hit_elementwise"), False),
    "cow_herd_mesh streamed": ("cow_herd_mesh", 240, "auto",
                               ("closest_hit_t0", "any_hit"), True),
}


def leaf_routes() -> dict:
    """Each LEAF_ROUTES frame compiled at leaf 64 and 256, its kernels
    counted, held to the same frame at leaf 128 under the image budget."""
    out = {}
    for key, (name, width, impl, kernels, knife) in LEAF_ROUTES.items():
        world, cam = (REGISTRY.get(name) or TEST_WORLDS[name])(width)
        cfg = RenderConfig(ray_tile=RAY_TILE, mesh_impl=impl)
        ref = None
        for leaf in (128,) + SWEEP_LEAFS:
            scene = compile_scene(world, dtype=torch.float32, device="cuda",
                                  cluster_size=leaf)
            mi.reset_launch_counts()
            img = render(scene, cam, cfg)
            torch.cuda.synchronize()
            check(all(mi.LAUNCHES[k] > 0 for k in kernels),
                  f"{key} at leaf {leaf}: launches {dict(mi.LAUNCHES)}")
            if ref is None:
                ref = img
                continue
            out[f"{key} leaf {leaf}"] = dict(
                gate=image_gate(f"{key} at leaf {leaf} vs 128", img, ref, knife),
                launches={k: v for k, v in mi.LAUNCHES.items() if v})
    return out


def phase_tools() -> dict:
    """Each tool on the card: tools.bench (cow at 1920 with the parity
    gate, and the suite) and tools.graft_entry's dryrun_multichip(4) as
    processes; tools.perf_probe (the stages and the K1 walk's visits) and
    tools.kernel_sweep (leaf x block size, K1 held to plain for each pair)
    and graft_entry.entry() in this process; and the cow frame at leaf 64
    and 256 (K3 fused, then K1 + K2 split, each counted) and the other
    kernels' routes at those leaves (leaf_routes) held to the leaf-128
    frame under the f32 image budget. Returns the tools record."""
    rec = {"card": CARD}
    out, err, seconds = tool_process("bench", str(WIDTH))
    check(len(out) == 1, f"tools.bench printed {len(out)} stdout lines")
    row = json.loads(out[0])
    check(set(row) == {"metric", "value", "unit", "vs_baseline"}
          and torch.cuda.get_device_name(0) in row["metric"] and row["value"] > 0,
          f"tools.bench's line: {row}")
    check(any(ln.startswith("kernel parity ok") for ln in err),
          "tools.bench: no 'kernel parity ok' line")
    err_json = [json.loads(ln) for ln in err if ln.startswith("{")]
    rec["bench"] = dict(line=row, suite=[r for r in err_json if "metric" in r],
                        frames=[r for r in err_json if "frame_ms" in r], s=seconds)
    say("17 tools", f"tools.bench {WIDTH} in {seconds:.1f} s: {out[0]}; "
        + next(ln for ln in err if ln.startswith("kernel parity")))

    res, lines, seconds = in_process(perf_probe.main, WIDTH, "cow", "cuda")
    _, visits, v_seconds = in_process(perf_probe.visit_sim, WIDTH, "cow", "cuda")
    rec["perf_probe"] = dict(res, visits=visits, s=seconds, visits_s=v_seconds)
    say("17 tools", f"tools.perf_probe {WIDTH} in {seconds:.1f} s: "
        + json.dumps(lines[0]) + "; " + json.dumps(lines[1]))

    rows, _, seconds = in_process(kernel_sweep.sweep, WIDTH)
    check(len(rows) == 9, f"tools.kernel_sweep: {len(rows)} pairs")
    rec["kernel_sweep"] = dict(rows=rows, s=seconds)
    say("17 tools", f"tools.kernel_sweep {WIDTH} in {seconds:.1f} s, K1 t bit-equal to "
        "plain at each pair: " + "; ".join(
            f"leaf {r['leaf']} rt {r['rt']}: prim {r['prim_ms']:.3f} ms, "
            f"refl {r['refl_ms']:.3f} ms" for r in rows))

    base, cam = slice_scene("cow", WIDTH)
    world, _ = REGISTRY["cow"](WIDTH)
    frames = {}
    for split in (False, True):
        cfg = RenderConfig(ray_tile=RAY_TILE, fused_shadow=not split)
        ref = render(base, cam, cfg)
        for leaf in SWEEP_LEAFS:
            scene = compile_scene(world, dtype=torch.float32, device="cuda",
                                  cluster_size=leaf)
            render(scene, cam, cfg)
            torch.cuda.synchronize()
            mi.reset_launch_counts()
            t0 = time.perf_counter()
            img = render(scene, cam, cfg)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            launched = ("closest_hit", "any_hit") if split else ("closest_shadow",)
            check(all(mi.LAUNCHES[k] > 0 for k in launched),
                  f"leaf {leaf} cow frame: {dict(mi.LAUNCHES)}")
            key = f"leaf {leaf} {'split' if split else 'fused'}"
            frames[key] = dict(gate=image_gate(f"cow {key} vs leaf 128", img, ref),
                               launches={k: v for k, v in mi.LAUNCHES.items() if v},
                               frame_ms=ms, n_clusters=scene.static.n_clusters)
    rec["leaf_frames"] = frames
    say("17 tools", "cow at leaf 64 and 256 against leaf 128: " + "; ".join(
        f"{k}: {v['gate']}, {v['launches']}, {v['frame_ms']:.1f} ms"
        for k, v in frames.items()))
    rec["leaf_routes"] = leaf_routes()
    say("17 tools", "the other kernels' routes at leaf 64 and 256 against leaf 128: "
        + "; ".join(f"{k}: {v['gate']}, {v['launches']}"
                    for k, v in rec["leaf_routes"].items()))

    t0 = time.perf_counter()
    fn, args = graft_entry.entry()
    img = fn(*args)
    torch.cuda.synchronize()
    check(tuple(img.shape) == (2048, 3) and bool(torch.isfinite(img).all()),
          "graft_entry.entry(): bad image")
    entry_s = time.perf_counter() - t0
    m, lines, seconds = in_process(graft_entry.dryrun_multichip, DRYRUN_RANKS)
    rec["graft_entry"] = dict(entry_shape=list(img.shape), entry_s=entry_s,
                              dryrun=m, dryrun_s=seconds)
    say("17 tools", f"graft_entry.entry() {tuple(img.shape)} in {entry_s:.1f} s; "
        f"dryrun_multichip({DRYRUN_RANKS}) over gloo in {seconds:.1f} s, every gate "
        f"passed: {json.dumps(m)}")
    return rec


# ---------------------------------------------------------------------------
# phase 18: the compiled frame (render/compiled.py)
# ---------------------------------------------------------------------------

# frame -> (registry scene, mesh_impl), each at 1920x960, depth 5, f32, at
# the default tile (the whole frame)
COMPILED_FRAMES = {"cow": ("cow", "auto"), "teapot": ("teapot", "auto"),
                   "teapot_smooth": ("teapot_smooth", "auto"),
                   "pumpkin": ("pumpkin", "auto"), "glass_teapot": ("glass_teapot", "auto"),
                   "cow_herd": ("cow_herd", "auto"),
                   "cow_herd_smooth": ("cow_herd_smooth", "auto"),
                   "table": ("table", "auto"), "cow elementwise": ("cow", "elementwise")}
COMPILED_TURNS = 7      # eager and graphed frames timed in turns
PROFILED_FRAMES = 3     # frames a profile of the cow's device share
PROGRESSIVE_TILE = 8192


def call_ms(call, graphs: bool) -> float:
    """Host ms of call() and a synchronize, eager (compiled.eager()) or on
    its own route."""
    torch.cuda.synchronize()
    with contextlib.nullcontext() if graphs else compiled.eager():
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def frame_ms(scene, cam, cfg, graphs: bool) -> float:
    """Host ms of one render() and a synchronize, eager or graphed."""
    return call_ms(lambda: render(scene, cam, cfg), graphs)


# each launch count's CUDA kernel in csrc/mesh_intersect.cu: one count is
# one launch of that kernel
KERNEL_OF_COUNT = {"closest_hit": "closest_hit_kernel", "closest_hit_sn": "closest_hit_kernel",
                   "closest_hit_t0": "closest_hit_kernel",
                   "closest_hit_uv": "closest_hit_kernel", "any_hit": "any_hit_kernel",
                   "closest_shadow": "closest_shadow_kernel",
                   "closest_shadow_sn": "closest_shadow_kernel",
                   "crossing_count": "crossing_count_kernel",
                   "closest_hit_tlas": "closest_hit_tlas_kernel",
                   "closest_hit_tlas_sn": "closest_hit_tlas_kernel",
                   "any_hit_tlas": "any_hit_tlas_kernel",
                   "closest_hit_elementwise": "elementwise_kernel",
                   "any_hit_elementwise": "elementwise_kernel",
                   # a call launches both passes; pass 1 stands for it
                   "object_rows": "object_rows_partial_kernel",
                   "prim_closest": "prim_sweep_kernel", "prim_any": "prim_sweep_kernel",
                   "shade_surface": "shade_kernel", "shade_node": "shade_kernel",
                   "shade_blend": "shade_kernel", "shade_grad": "shade_grad_kernel"}


def port_kernel(name: str):
    """The kernel of csrc/mesh_intersect.cu (its anonymous namespace) that
    a profiler event names, demangled or not; None for any other."""
    m = re.match(r"(?:void )?\(anonymous namespace\)::(\w+)", name)
    if m is not None:
        kernel = m.group(1)
    else:
        m = re.match(r"_ZN12_GLOBAL__N_1(\d+)", name)
        kernel = m and name[m.end():m.end() + int(m.group(1))]
    return kernel if kernel in KERNEL_OF_COUNT.values() else None


def counted_kernels(launches: dict, times: int = 1) -> dict:
    """Launch counts (mi.LAUNCHES' keys) as launches of each CUDA kernel."""
    out = collections.Counter()
    for k, n in launches.items():
        if n:
            out[KERNEL_OF_COUNT[k]] += n * times
    return dict(out)


def traced(call, n: int):
    """call() n times under torch.profiler, mi.LAUNCHES from 0: (the device
    events, the host's wall ms, the launches of each port kernel that the
    device ran, by the kernel's name in the trace, and what mi.LAUNCHES
    counted, by the same names)."""
    from torch.profiler import ProfilerActivity, profile

    mi.reset_launch_counts()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            call()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ops = profiling.device_ops(prof.events())
    ran = dict(collections.Counter(k for k in map(port_kernel, (e.name for e in ops)) if k))
    return ops, wall, ran, counted_kernels(mi.LAUNCHES)


def busy_share(call, graphs: bool, n: int = PROFILED_FRAMES) -> dict:
    """n calls back to back under torch.profiler: the device's busy ms
    over the host's wall ms (None where it recorded no device operation),
    and the port's kernels the trace holds by name beside what
    mi.LAUNCHES counted."""
    with contextlib.nullcontext() if graphs else compiled.eager():
        ops, wall, ran, counted = traced(call, n)
    busy = sum(e.time_range.elapsed_us() for e in ops) / 1e3 if ops else None
    return dict(wall_ms=wall / n, device_ops=len(ops) / n,
                busy_ms=None if busy is None else busy / n,
                busy_share=None if busy is None else busy / wall,
                ran=ran, counted=counted)


def device_share(scene, cam, cfg, graphs: bool) -> dict:
    """busy_share of PROFILED_FRAMES frames. Fails unless the port's
    kernels in the trace, counted by name, are what mi.LAUNCHES counted
    (on the graphed route: the graph's launches once a replay)."""
    frame_ms(scene, cam, cfg, graphs)
    graph = compiled.graph_for(scene, ("frame", (cam.vsize, cam.hsize), cfg))
    share = busy_share(lambda: render(scene, cam, cfg), graphs)
    ran, counted = share.pop("ran"), share.pop("counted")
    kind = "graphed" if graphs else "eager"
    check(ran == counted and ran, f"cow {kind} under the profiler: the device ran {ran}, "
          f"the wrappers counted {counted}")
    if graphs:
        check(counted == counted_kernels(graph.launches, PROFILED_FRAMES),
              f"cow graphed: counted {counted}, the graph's launches {graph.launches} "
              f"x {PROFILED_FRAMES}")
    return dict(share, kernels_traced={k: v / PROFILED_FRAMES for k, v in ran.items()})


def orbited(cam, angle: float = 0.05):
    """cam's canvas, its eye turned by angle about the world's y axis."""
    other = Camera(cam.hsize, cam.vsize, cam.field_of_view)
    return other.set_transform(cam.transform @ X.rotation_y(angle))


def compiled_frame(frame: str) -> dict:
    """One COMPILED_FRAMES entry: its route; the eager frame and its
    launches; the first graphed call (its eager run and capture) and a
    replay, both bit-equal to the eager frame, the replay launching what
    the eager frame launched; a second camera on the canvas replayed with
    no capture, bit-equal to its own eager frame; the frames timed eager
    and graphed in turns; peak memory."""
    name, impl = COMPILED_FRAMES[frame]
    scene, cam = slice_scene(name, WIDTH)
    cfg = RenderConfig(mesh_impl=impl)
    key = ("frame", (cam.vsize, cam.hsize), cfg)
    route = compiled.route(scene, cfg)
    check(route == compiled.GRAPHED, f"{frame}: route {route!r}")
    compiled.clear()
    torch.cuda.empty_cache()
    with compiled.eager():
        render(scene, cam, cfg)
        mi.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        want = render(scene, cam, cfg)
        torch.cuda.synchronize()
        eager_launches = dict(mi.LAUNCHES)
        eager_peak = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    captures = compiled.COUNTS["captures"]
    mi.reset_launch_counts()
    t0 = time.perf_counter()
    first, spans = recorded(lambda: render(scene, cam, cfg))
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    warm_s, capture_s = (spans[k].seconds for k in ("rtc.graph.warm", "rtc.graph.capture"))
    check(dict(mi.LAUNCHES) == eager_launches,
          f"{frame}: the first graphed call launched {dict(mi.LAUNCHES)}, "
          f"the eager frame {eager_launches}")
    graph = compiled.graph_for(scene, key)
    check(graph is not None and compiled.COUNTS["captures"] == captures + 1,
          f"{frame}: the first call captured no graph")
    torch.cuda.empty_cache()  # the pool and the first call's image stay
    pool = (torch.cuda.memory_reserved() - reserved - first.nbytes) / 2**30
    mi.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    got = render(scene, cam, cfg)
    torch.cuda.synchronize()
    replay_launches = dict(mi.LAUNCHES)
    graphed_peak = torch.cuda.max_memory_allocated() / 2**30
    check(torch.equal(first, want) and torch.equal(got, want),
          f"{frame}: the graphed frame differs from the eager frame on "
          f"{int((got != want).any(dim=2).sum())} pixels")
    check(replay_launches == eager_launches and graph.launches
          == {k: v for k, v in eager_launches.items() if v},
          f"{frame}: a replay launched {replay_launches}, the eager frame "
          f"{eager_launches}")
    check(bool(torch.isfinite(got).all()) and float(got.amax()) > 0.1,
          f"{frame}: the image is not finite or black")

    cam2 = orbited(cam)
    got2 = render(scene, cam2, cfg)
    torch.cuda.synchronize()
    check(compiled.COUNTS["captures"] == captures + 1 and graph.replays == 2,
          f"{frame}: the second camera captured again")
    with compiled.eager():
        want2 = render(scene, cam2, cfg)
    check(torch.equal(got2, want2) and not torch.equal(want2, want),
          f"{frame}: the second camera's graphed frame differs from its eager frame "
          f"on {int((got2 != want2).any(dim=2).sum())} pixels")

    # the kernels in a traced replay, by name, against the graph's launches
    replays = graph.replays
    _, _, ran, counted = traced(lambda: render(scene, cam, cfg), 1)
    check(graph.replays == replays + 1 and ran == counted == counted_kernels(graph.launches),
          f"{frame}: a traced replay ran {ran}, the graph's launches {graph.launches}")

    eager_ms, graphed_ms = [], []
    for _ in range(COMPILED_TURNS):
        eager_ms.append(frame_ms(scene, cam, cfg, graphs=False))
        graphed_ms.append(frame_ms(scene, cam, cfg, graphs=True))
    med = lambda xs: sorted(xs)[len(xs) // 2]
    rec = dict(route=route, launches={k: v for k, v in eager_launches.items() if v},
               warm_s=warm_s, capture_s=capture_s, first_call_s=first_s,
               eager_ms=eager_ms, graphed_ms=graphed_ms, eager_median_ms=med(eager_ms),
               graphed_median_ms=med(graphed_ms), eager_peak_gib=eager_peak,
               graphed_peak_gib=graphed_peak, pool_gib=pool, kernels_traced=ran)
    say("18 compiled", f"{frame} {cam.hsize}x{cam.vsize}: route {route}; graphed == eager "
        f"bit for bit, and a second camera replays with no capture, == its eager frame; "
        f"launches a replay {rec['launches']} (== eager; traced by name {ran}); eager run {warm_s:.3f} s, "
        f"capture {capture_s:.3f} s; median ms eager {rec['eager_median_ms']:.2f}, "
        f"graphed {rec['graphed_median_ms']:.2f} (in turns, {COMPILED_TURNS} each: "
        f"{', '.join(f'{a:.2f}/{b:.2f}' for a, b in zip(eager_ms, graphed_ms))}); peak "
        f"GiB eager {eager_peak:.2f}, graphed {graphed_peak:.2f}, pool {pool:.2f}")
    return rec


def held_at_once(frames: dict) -> dict:
    """The cache full of its largest graphs: the MAX_GRAPHS frames of
    COMPILED_FRAMES with the largest pools captured one after another with
    no clear() between them, and the memory the card then holds reserved
    for them (graphs, their inputs and what they keep) beside the sum of
    the pools each measured alone."""
    big = sorted(frames, key=lambda f: -frames[f]["pool_gib"])[:compiled.MAX_GRAPHS]
    calls = []
    for frame in big:
        name, impl = COMPILED_FRAMES[frame]
        scene, cam = slice_scene(name, WIDTH)
        calls.append((scene, cam, RenderConfig(mesh_impl=impl)))
    compiled.clear()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    for scene, cam, cfg in calls:
        render(scene, cam, cfg)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    held = (torch.cuda.memory_reserved() - reserved) / 2**30
    check(len(compiled._CACHE) == len(big), f"held: {len(compiled._CACHE)} graphs")
    out = dict(frames=big, held_gib=held,
               pools_alone_gib=sum(frames[f]["pool_gib"] for f in big))
    say("18 compiled", f"the cache full ({compiled.MAX_GRAPHS} graphs, the largest pools: "
        f"{', '.join(big)}): {held:.2f} GiB reserved for them, against "
        f"{out['pools_alone_gib']:.2f} GiB of pools measured one at a time")
    compiled.clear()
    return out


def phase_compiled() -> dict:
    """render() replayed from a CUDA graph against the eager frame, for
    each of COMPILED_FRAMES (compiled_frame); the cow frame's device busy
    share, eager and graphed; and the progressive cow frame at tile
    PROGRESSIVE_TILE, eager and graphed, every tile bit-equal. Returns the
    phase's record."""
    from rtc_tpu_torch.render.progressive import render_tiles

    rec = {"card": CARD, "frames": {}}
    for frame in COMPILED_FRAMES:
        rec["frames"][frame] = compiled_frame(frame)
    rec["held"] = held_at_once(rec["frames"])

    scene, cam = slice_scene("cow", WIDTH)
    cfg = RenderConfig()
    shares = {kind: device_share(scene, cam, cfg, graphs)
              for kind, graphs in (("eager", False), ("graphed", True))}
    rec["cow_device_share"] = shares
    say("18 compiled", "cow frame under torch.profiler, " + "; ".join(
        f"{k}: wall {v['wall_ms']:.2f} ms, device busy "
        + ("not measured (no device operation recorded)" if v["busy_ms"] is None else
           f"{v['busy_ms']:.2f} ms = {v['busy_share']:.3f} of the wall")
        + f", {v['device_ops']:.0f} device operations a frame" for k, v in shares.items()))

    cfg = RenderConfig(ray_tile=PROGRESSIVE_TILE)
    runs = {}
    for kind in ("eager", "first", "graphed"):
        if kind == "first":
            compiled.clear()
        mi.reset_launch_counts()
        torch.cuda.synchronize()
        with compiled.eager() if kind == "eager" else contextlib.nullcontext():
            t0 = time.perf_counter()
            tiles, spans = recorded(lambda: [c for _, _, c in render_tiles(scene, cam, cfg)])
            runs[kind] = (time.perf_counter() - t0, tiles, dict(mi.LAUNCHES), spans)
    n_tiles = len(runs["eager"][1])
    for kind in ("first", "graphed"):
        check(all(np.array_equal(a, b) for a, b in zip(runs[kind][1], runs["eager"][1])),
              f"progressive {kind}: tiles differ from the eager tiles")
        check(runs[kind][2] == runs["eager"][2],
              f"progressive {kind}: launches {runs[kind][2]}, eager {runs['eager'][2]}")
    graph = compiled.graph_for(scene, ("tile", PROGRESSIVE_TILE, cfg))
    check(graph is not None and graph.replays == 2 * n_tiles - 1,
          "progressive: the tiles did not replay one graph")
    capture_s = runs["first"][3]["rtc.graph.capture"].seconds
    rec["progressive"] = dict(tile=PROGRESSIVE_TILE, tiles=n_tiles,
                              eager_s=runs["eager"][0], first_s=runs["first"][0],
                              graphed_s=runs["graphed"][0], capture_s=capture_s,
                              launches={k: v for k, v in runs["eager"][2].items() if v})
    say("18 compiled", f"progressive cow {WIDTH}x{HEIGHT} at tile {PROGRESSIVE_TILE}: "
        f"{n_tiles} tiles bit-equal eager and graphed; eager {runs['eager'][0]:.3f} s, "
        f"graphed {runs['graphed'][0]:.3f} s (first, with the capture "
        f"{capture_s:.3f} s: {runs['first'][0]:.3f} s); launches "
        f"{rec['progressive']['launches']} on either route")
    compiled.clear()
    return rec



# ---------------------------------------------------------------------------
# phase 19: the compiled gradient step (loss_and_grad and the train step
# replayed from CUDA graphs, render/compiled.py step_route)
# ---------------------------------------------------------------------------

GRAD_TURNS = 7           # eager and graphed calls timed in turns
GRAD_ADAM_STEPS = 5      # (b)'s Adam steps (capturable=True) on each route
GRAD_EAGER_RUNS = 5      # eager runs whose spread a graphed result may differ by
SPREAD_FACTOR = 2        # ... at most this many times, where eager runs differ
GRAD_SMALL = 480         # (e)'s canvas
# (e): frame -> (registry scene, mesh_impl, the Functions its loss_and_grad applies)
GRAD_FRAMES = {"teapot_smooth": ("teapot_smooth", "auto", ("KernelClosestShadowSn",)),
               "glass_teapot": ("glass_teapot", "auto", ("KernelClosestSn",)),
               "cow_herd": ("cow_herd", "auto", ("KernelClosestTlas",)),
               "cow_herd_smooth": ("cow_herd_smooth", "auto", ("KernelClosestTlasSn",)),
               "cow elementwise": ("cow", "elementwise", ("KernelClosest",))}
# every Function but the streamed KernelClosestUv, which stays eager by route
GRAPHED_FUNCTIONS = ("KernelClosest", "KernelClosestN", "KernelClosestSn",
                     "KernelClosestShadow", "KernelClosestShadowSn",
                     "KernelClosestTlas", "KernelClosestTlasSn")
CAPTURED = collections.Counter()  # Function -> applies inside a capture


def nonzero_pull(ctx, lead, grads, refined):
    """integrator._pull as it was before its shapes were the wavefront's
    (the hit rays gathered by torch.nonzero), timed beside it."""
    *inputs, win = ctx.saved_tensors
    needs = ctx.needs_input_grad[lead:]
    if not any(needs):
        return (None,) * (lead + len(inputs))
    rays = torch.nonzero(win >= 0)[:, 0]
    with torch.enable_grad():
        xs = [x.detach().requires_grad_(n) for x, n in zip(inputs, needs)]
        ys = refined(*(x.double().index_select(0, rays) for x in xs[:2]),
                     *(x.double() for x in xs[2:]), win.index_select(0, rays).long())
        pairs = [(y, g.double().index_select(0, rays))
                 for y, g in zip(ys, grads) if y.requires_grad]
        got = iter(torch.autograd.grad(
            [y for y, _ in pairs], [x for x, n in zip(xs, needs) if n],
            [g for _, g in pairs], allow_unused=True))
    return (None,) * lead + tuple(next(got) if n else None for n in needs)


@contextlib.contextmanager
def counting_captured_functions():
    """Count in CAPTURED each autograd Function applied while a graph
    captures (its ctx's class is <Function>Backward)."""
    forward = integrator._forward

    def counted(ctx, *a, **k):
        if torch.cuda.is_current_stream_capturing():
            CAPTURED[type(ctx).__name__.removesuffix("Backward")] += 1
        return forward(ctx, *a, **k)

    integrator._forward = counted
    try:
        yield
    finally:
        integrator._forward = forward


def spread_gate(what: str, got, runs) -> dict:
    """got (any nesting of tensors) against the eager runs: bit-equal to the
    first where every eager run is, else within SPREAD_FACTOR times the
    largest difference between two eager runs."""
    flat = [compiled.tensors(r) for r in runs]
    diff = lambda xs, ys: max(float((a.double() - b.double()).abs().max())
                              for a, b in zip(xs, ys))
    spread = max(diff(flat[i], flat[j]) for i in range(len(flat)) for j in range(i))
    err = diff(compiled.tensors(got), flat[0])
    check(err <= SPREAD_FACTOR * spread,
          f"{what}: graphed differs from eager by {err:.3g}, eager runs by {spread:.3g}")
    return dict(max_abs_err=err, eager_spread=spread, bit_equal=err == 0.0)


def eager_runs(call, n: int = GRAD_EAGER_RUNS) -> list:
    with compiled.eager():
        return [call() for _ in range(n)]


def recorded(call):
    """call() with the program's spans recorded: (its result, the spans'
    totals by name, profiling.totals)."""
    was = profiling.set_recording(True)
    try:
        out = call()
    finally:
        profiling.set_recording(was)
    return out, profiling.totals(profiling.take_spans().spans)


def first_graphed_call(call, what: str) -> dict:
    """The first graphed call from an empty cache: its result, wall s, the
    host s of its eager run and of its capture (the spans rtc.graph.warm
    and rtc.graph.capture), the graph it made (one capture) and that
    graph's pool in GiB (the memory the card holds reserved after it, less
    the result)."""
    compiled.clear()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved()
    captures = compiled.COUNTS["captures"]
    t0 = time.perf_counter()
    out, spans = recorded(call)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    check(compiled.COUNTS["captures"] == captures + 1 and len(compiled._CACHE) == 1,
          f"{what}: the first call made {compiled.COUNTS['captures'] - captures} captures")
    torch.cuda.empty_cache()
    pool = (torch.cuda.memory_reserved() - reserved
            - sum(t.nbytes for t in compiled.tensors(out))) / 2**30
    graph = next(iter(compiled._CACHE.values()))
    return dict(out=out, first_s=first_s, warm_s=spans["rtc.graph.warm"].seconds,
                capture_s=spans["rtc.graph.capture"].seconds, graph=graph, pool_gib=pool)


def grad_tiles_run(params, scene, tiles, targets, cfg) -> list:
    """loss_and_grad of each tile: [(loss, grads)], and each tile's launches."""
    out = []
    for (o, d), t in zip(tiles, targets):
        mi.reset_launch_counts()
        out.append((RG.loss_and_grad(params, scene, o, d, t, cfg), dict(mi.LAUNCHES)))
    return out


def graphed_gradients(name, scene, tiles, targets, cfg, params) -> dict:
    """(a) for one route of the cow frame: loss_and_grad in tiles (one
    capture, then replays with the other tiles' values) and of the whole
    frame in one call, each graphed against the eager runs; the tiles'
    launches against eager's; central finite differences on the graphed
    tiles' frame gradients."""
    with compiled.eager():
        eager_tiles = [grad_tiles_run(params, scene, tiles, targets, cfg)
                       for _ in range(GRAD_EAGER_RUNS)]
    first = first_graphed_call(lambda: grad_tiles_run(params, scene, tiles, targets, cfg),
                               f"{name} tiles")
    graph = first["graph"]
    again = grad_tiles_run(params, scene, tiles, targets, cfg)
    check(graph.replays == 2 * len(tiles) - 1 and len(compiled._CACHE) == 1,
          f"{name}: the tiles replayed {graph.replays} times")
    gates = {}
    for kind, run in (("first", first["out"]), ("replays", again)):
        gates[kind] = spread_gate(f"{name} tiles, {kind}", [r for r, _ in run],
                                  [[r for r, _ in e] for e in eager_tiles])
        check([n for _, n in run] == [n for _, n in eager_tiles[0]],
              f"{name} tiles, {kind}: launches {[n for _, n in run]}, eager "
              f"{[n for _, n in eager_tiles[0]]}")
    launches = {k: v for k, v in eager_tiles[0][0][1].items() if v}
    check(bool(launches) and {k: v for k, v in graph.launches.items() if v} == launches,
          f"{name}: a replay launches {graph.launches}, an eager tile {launches}")

    n = sum(o.shape[0] for o, _ in tiles)
    grads = {k: sum(o.shape[0] / n * g[k] for ((_, g), _), (o, _) in zip(again, tiles))
             for k in params}
    fd = {}
    for pname, index in (("mat_color", (0, 0)), ("light_intensity", (0,))):
        at = []
        for sign in (1, -1):
            p = {k: v.detach().clone() for k, v in params.items()}
            p[pname][index] += sign * FD_EPS
            at.append(tiled_loss(p, scene, tiles, targets, cfg))
        fd_val = (at[0] - at[1]) / (2 * FD_EPS)
        ad = float(grads[pname][index])
        check(abs(ad - fd_val) <= FD_RTOL * abs(fd_val),
              f"{name} graphed {pname}{list(index)}: autograd {ad} vs finite difference "
              f"{fd_val}")
        fd[f"{pname}{list(index)}"] = {"autograd": ad, "finite_difference": fd_val}

    o_all = torch.cat([o for o, _ in tiles])
    d_all = torch.cat([d for _, d in tiles])
    t_all = torch.cat(targets)
    whole = lambda: RG.loss_and_grad(params, scene, o_all, d_all, t_all, cfg)
    eager_whole = eager_runs(whole)
    first_whole = first_graphed_call(whole, f"{name} whole frame")
    replay_whole = whole()
    for kind, got in (("first", first_whole["out"]), ("replay", replay_whole)):
        gates[f"whole frame {kind}"] = spread_gate(f"{name} whole frame, {kind}", got,
                                                   eager_whole)
    check(first_whole["graph"].replays == 1, f"{name} whole frame: no replay")
    return dict(launches_a_tile=launches, gates=gates, finite_differences=fd,
                tiles_first_call_s=first["first_s"], tiles_warm_s=first["warm_s"],
                tiles_capture_s=first["capture_s"], tiles_pool_gib=first["pool_gib"],
                whole_first_call_s=first_whole["first_s"],
                whole_warm_s=first_whole["warm_s"],
                whole_capture_s=first_whole["capture_s"],
                whole_pool_gib=first_whole["pool_gib"])


def adam_trajectory(scene, o, d, target, cfg, steps: int = GRAD_ADAM_STEPS) -> list:
    """steps Adam steps (capturable=True) on PERTURB's parameters from the
    scene's values: [(loss before the step, {name: value after it})]."""
    params = RG.extract_params(scene, tuple(PERTURB))
    step = RG.make_train_step(torch.optim.Adam(params.values(), lr=ADAM_LR,
                                               capturable=True), cfg)
    out = []
    for _ in range(steps):
        loss = step(params, scene, o, d, target)
        out.append((loss, {k: v.detach().clone() for k, v in params.items()}))
    return out


def backward_times(scene, cam, eps) -> dict:
    """K3's Function on the cow's 460,800-ray wavefront, every input
    requiring grad: the backward's ms (CUDA events, median of GRAD_TURNS
    in turns) with the misses on spread stand-in rows, all on row 0, and
    the nonzero backward it replaced; their gradients against each other."""
    o, d = main_path_rays(cam)
    fn, kernel, _, tabs, lead = function_case("K3", scene, eps)
    xs = [x.detach().clone().requires_grad_() for x in (o, d, *tabs)]
    w = torch.randn((o.shape[0], 4), generator=torch.Generator("cuda").manual_seed(0),
                    device="cuda")
    outs = fn.apply(kernel, eps, *lead, *xs)
    loss = (torch.where(outs[1] >= 0, outs[0], 0.0) * w[:, 3]).sum() + (outs[2] * w[:, :3]).sum()
    pull, stand_in = integrator._pull, integrator._stand_in
    modes = {"spread": (stand_in, pull), "zero": (lambda win, rows: 0, pull),
             "nonzero": (stand_in, nonzero_pull)}
    times, grads = {m: [] for m in modes}, {}
    try:
        for _ in range(GRAD_TURNS + 1):
            for m, (fn_stand_in, fn_pull) in modes.items():
                integrator._stand_in, integrator._pull = fn_stand_in, fn_pull
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                torch.cuda.synchronize()
                ev[0].record()
                grads[m] = torch.autograd.grad(loss, xs, retain_graph=True)
                ev[1].record()
                torch.cuda.synchronize()
                times[m].append(ev[0].elapsed_time(ev[1]))
    finally:
        integrator._stand_in, integrator._pull = stand_in, pull
    med = lambda xs: sorted(xs[1:])[len(xs[1:]) // 2]
    rel = {m: max(rel_norm(a, b) for a, b in zip(grads[m], grads["nonzero"]))
           for m in ("spread", "zero")}
    for m, r in rel.items():
        check(r <= 1e-6, f"backward with misses {m}: gradients differ from the nonzero "
              f"backward's by {r:.3g}")
    return dict(rays=o.shape[0], hits=int((outs[1] >= 0).sum()),
                median_ms={m: med(v) for m, v in times.items()},
                ms={m: v[1:] for m, v in times.items()}, rel_to_nonzero=rel)


def small_frame_gate(frame: str) -> dict:
    """(e): loss_and_grad of one frame at GRAD_SMALL, graphed (the first
    call and a replay) against eager, the Functions its capture applied."""
    name, impl, functions = GRAD_FRAMES[frame]
    scene, cam = slice_scene(name, GRAD_SMALL)
    cfg = RenderConfig(mesh_impl=impl)
    check(compiled.step_route(scene, cfg, RG.DEFAULT_PARAMS) == compiled.GRAPHED,
          f"{frame}: gradient route {compiled.step_route(scene, cfg, RG.DEFAULT_PARAMS)}")
    (o, d), = frame_tiles(cam, 1)
    base = RG.extract_params(scene)
    with torch.no_grad():
        target = integrator.color_at(RG.inject_params(
            scene, {k: base[k].detach() + v for k, v in PERTURB.items()}), o, d, cfg)
    params = RG.extract_params(scene)
    call = lambda: RG.loss_and_grad(params, scene, o, d, target, cfg)
    runs = eager_runs(call)
    before = collections.Counter(CAPTURED)
    compiled.clear()
    first = call()
    got = call()
    graph = next(iter(compiled._CACHE.values()))
    applied = {k: CAPTURED[k] - before[k] for k in CAPTURED if CAPTURED[k] != before[k]}
    check(graph.replays == 1 and all(applied.get(f) for f in functions),
          f"{frame}: replays {graph.replays}, Functions captured {applied}")
    gates = {kind: spread_gate(f"{frame} {kind}", out, runs)
             for kind, out in (("first", first), ("replay", got))}
    check(all(bool(torch.isfinite(g).all()) for g in got[1].values()),
          f"{frame}: a gradient is not finite")
    return dict(rays=o.shape[0], functions_captured=applied,
                launches={k: v for k, v in graph.launches.items() if v}, gates=gates)


def eager_route_gates(scene, tiles, targets, cfg) -> dict:
    """(f): triangle rows among the parameters, an Adam with
    capturable=False and eager() each take the eager route they name, and
    capture nothing."""
    (o, d), t = tiles[0], targets[0]
    compiled.clear()
    compiled.ROUTES.clear()
    captures = compiled.COUNTS["captures"]
    rows = RG.extract_params(scene, RG.DEFAULT_PARAMS + ("tri_p1",))
    RG.loss_and_grad(rows, scene, o, d, t, cfg)
    mat = RG.extract_params(scene, tuple(PERTURB))
    RG.make_train_step(torch.optim.Adam(mat.values(), lr=ADAM_LR), cfg)(mat, scene, o, d, t)
    with compiled.eager():
        RG.loss_and_grad(RG.extract_params(scene), scene, o, d, t, cfg)
    routes = dict(compiled.ROUTES)
    want = {"loss_and_grad: " + compiled.step_route(scene, cfg, rows): 1,
            "train_step: " + compiled.step_route(
                scene, cfg, mat, torch.optim.Adam(mat.values())): 1,
            "loss_and_grad: " + compiled.EAGER_CONTEXT: 1}
    check(routes == want and all(k.split(": ", 1)[1].startswith("eager: ") for k in want)
          and compiled.COUNTS["captures"] == captures and not compiled._CACHE,
          f"eager routes: {routes}, expected {want}")
    return routes


def phase_compiled_grads(eps) -> dict:
    """The gradient step replayed from CUDA graphs against the eager step
    (compiled.eager()), on the cow frame at 1920x960, depth 5, f32, with
    DEFAULT_PARAMS: (a) loss_and_grad in GRAD_TILES tiles and of the whole
    frame, fused K3 and split K1 + K2, with finite differences; (b)
    GRAD_ADAM_STEPS Adam steps (capturable=True) on both routes; (c) the
    calls timed in turns, capture and first-call s, pools, the step's
    busy share; (d) a traced replay's kernels by name against the eager
    step's; (e) the 480x240 frames of GRAD_FRAMES, and every Function but
    KernelClosestUv applied inside a capture; (f) the eager routes; and
    the fixed-shape backward's time, the misses spread and on row 0,
    against the nonzero backward. Returns the phase's record."""
    scene, cam = slice_scene("cow", WIDTH)
    fused = RenderConfig(ray_tile=RAY_TILE, mesh_impl="kernel")
    split = RenderConfig(ray_tile=RAY_TILE, mesh_impl="kernel", fused_shadow=False)
    tiles = frame_tiles(cam, GRAD_TILES)
    base = RG.extract_params(scene)
    with torch.no_grad():
        target_scene = RG.inject_params(
            scene, {k: base[k].detach() + v for k, v in PERTURB.items()})
        targets = [integrator.color_at(target_scene, o, d, fused) for o, d in tiles]
    params = RG.extract_params(scene)
    o_all = torch.cat([o for o, _ in tiles])
    d_all = torch.cat([d for _, d in tiles])
    t_all = torch.cat(targets)
    rec = {"card": CARD, "frame": f"cow {WIDTH}x{HEIGHT} depth {DEPTH} f32, DEFAULT_PARAMS, "
           f"{GRAD_TILES} tiles of {RAY_TILE}"}
    for cfg in (fused, split):
        check(compiled.step_route(scene, cfg, params) == compiled.GRAPHED,
              f"cow gradient route {compiled.step_route(scene, cfg, params)}")

    with counting_captured_functions():
        rec["fused"] = graphed_gradients("fused", scene, tiles, targets, fused, params)
        rec["split"] = graphed_gradients("split", scene, tiles, targets, split, params)
        check(rec["fused"]["launches_a_tile"] == {"closest_shadow": 2, "object_rows": 2}
              and rec["split"]["launches_a_tile"] == {"closest_hit": 2, "any_hit": 2,
                                                      "object_rows": 2},
              "gradient tiles' launches")
        for kind in ("fused", "split"):
            say("19 compiled grads", f"cow {kind}: {GRAD_TILES} tiles, one capture and "
                f"{2 * GRAD_TILES - 1} replays, and the whole frame: " + "; ".join(
                    f"{k} max|diff| {v['max_abs_err']:.3g} (eager spread "
                    f"{v['eager_spread']:.3g})" for k, v in rec[kind]["gates"].items())
                + f"; launches a tile {rec[kind]['launches_a_tile']}; finite differences "
                f"{rec[kind]['finite_differences']}; tiles capture "
                f"{rec[kind]['tiles_capture_s']:.3f} s, first call "
                f"{rec[kind]['tiles_first_call_s']:.3f} s, pool "
                f"{rec[kind]['tiles_pool_gib']:.2f} GiB; whole frame capture "
                f"{rec[kind]['whole_capture_s']:.3f} s, first call "
                f"{rec[kind]['whole_first_call_s']:.3f} s, pool "
                f"{rec[kind]['whole_pool_gib']:.2f} GiB")

        # (b) Adam, capturable on both routes
        trajectory = lambda: adam_trajectory(scene, o_all, d_all, t_all, fused)
        eager_traj = eager_runs(trajectory, 2)
        first = first_graphed_call(lambda: adam_trajectory(scene, o_all, d_all, t_all, fused,
                                                           1), "the train step")
        compiled.clear()
        graphed_traj = trajectory()
        step_graph = next(iter(compiled._CACHE.values()))
        check(step_graph.replays == GRAD_ADAM_STEPS - 1,
              f"Adam: {step_graph.replays} replays of {GRAD_ADAM_STEPS} steps")
        adam = spread_gate("Adam trajectory", graphed_traj, eager_traj)
        losses = [float(x) for x, _ in graphed_traj]
        with torch.no_grad():
            losses.append(float(RG.render_loss(graphed_traj[-1][1], scene, o_all, d_all,
                                               t_all, fused)))
        check(all(b < a for a, b in zip(losses, losses[1:])),
              f"graphed Adam: the loss did not fall at each step: {losses}")
        rec["adam"] = dict(gate=adam, losses=losses,
                           eager_losses=[float(x) for x, _ in eager_traj[0]],
                           first_call_s=first["first_s"], warm_s=first["warm_s"],
                           capture_s=first["capture_s"], pool_gib=first["pool_gib"])
        say("19 compiled grads", f"Adam (capturable) {GRAD_ADAM_STEPS} steps of the whole "
            f"frame graphed against eager: max|diff| {adam['max_abs_err']:.3g} (eager "
            f"spread {adam['eager_spread']:.3g}); losses {losses}; first call "
            f"{first['first_s']:.3f} s, capture {first['capture_s']:.3f} s, pool "
            f"{first['pool_gib']:.2f} GiB")

        # (e) the other scenes' Functions
        rec["frames"] = {f: small_frame_gate(f) for f in GRAD_FRAMES}
        for f, r in rec["frames"].items():
            say("19 compiled grads", f"{f} {GRAD_SMALL}: " + "; ".join(
                f"{k} max|diff| {v['max_abs_err']:.3g} (eager spread {v['eager_spread']:.3g})"
                for k, v in r["gates"].items())
                + f"; Functions captured {r['functions_captured']}; launches a replay "
                f"{r['launches']}")
    missing = [f for f in GRAPHED_FUNCTIONS if not CAPTURED[f]]
    check(not missing and not CAPTURED["KernelClosestUv"],
          f"Functions never applied inside a capture: {missing}; all: {dict(CAPTURED)}")
    rec["functions_captured"] = dict(CAPTURED)

    # (c) and (d): in turns, on the fused route
    (o, d), t = tiles[0], targets[0]
    tile_call = lambda: RG.loss_and_grad(params, scene, o, d, t, fused)
    whole_call = lambda: RG.loss_and_grad(params, scene, o_all, d_all, t_all, fused)
    timed = {}
    for kind, graphs in (("eager", False), ("graphed", True)):
        trained = RG.extract_params(scene, tuple(PERTURB))
        step = RG.make_train_step(torch.optim.Adam(trained.values(), lr=ADAM_LR,
                                                   capturable=True), fused)
        timed[kind] = (graphs, lambda step=step, trained=trained: step(
            trained, scene, o_all, d_all, t_all))
    compiled.clear()
    timed["graphed"][1]()  # the first calls: each captures its graph
    tile_call()
    whole_call()
    turns = collections.defaultdict(list)
    for _ in range(GRAD_TURNS):
        for kind, (graphs, step_call) in timed.items():
            turns[f"tile_{kind}"].append(call_ms(tile_call, graphs))
            turns[f"whole_{kind}"].append(call_ms(whole_call, graphs))
            turns[f"step_{kind}"].append(call_ms(step_call, graphs))
    med = lambda xs: sorted(xs)[len(xs) // 2]
    rec["turns_ms"] = dict(turns)
    rec["median_ms"] = {k: med(v) for k, v in turns.items()}
    # the kernels by name are gated on one traced call each, below: over
    # PROFILED_FRAMES steps the profiler has dropped a kernel (5 of 6)
    shares = {kind: busy_share(step_call, graphs) for kind, (graphs, step_call) in timed.items()}
    # each route's trace must hold every kernel the graph launches, by
    # name, and no launch the counts do not: after phase 13's profiled step
    # torch.profiler has dropped one of a step's two K3 launches from its
    # trace on either route (and never in phase 19 run alone), so the
    # counts, equal on both routes and to the graph's, hold the number
    step_graph = next(g for k, g in compiled._CACHE.items() if k[1] == "step")
    want = counted_kernels(step_graph.launches)
    replays = step_graph.replays
    _, _, ran, counted = traced(timed["graphed"][1], 1)
    with compiled.eager():
        _, _, eager_ran, eager_counted = traced(timed["eager"][1], 1)
    check(step_graph.replays == replays + 1 and counted == eager_counted == want
          and set(ran) == set(eager_ran) == set(want)
          and all(r.get(k, 0) <= n for r in (ran, eager_ran) for k, n in want.items()),
          f"a traced step replay ran {ran}, counted {counted}, the eager step "
          f"{eager_ran} (counted {eager_counted}), the graph's launches {want}")
    rec["step_busy_share"] = shares
    rec["traced_step_kernels"] = dict(graphed=ran, eager=eager_ran, counted=want)
    say("19 compiled grads", "median ms eager/graphed in turns ({} each): loss_and_grad "
        "tile {:.2f}/{:.2f}, whole frame {:.2f}/{:.2f}, Adam step {:.2f}/{:.2f}".format(
            GRAD_TURNS, *(rec["median_ms"][f"{c}_{k}"] for c in ("tile", "whole", "step")
                          for k in ("eager", "graphed"))))
    say("19 compiled grads", "the Adam step under torch.profiler, " + "; ".join(
        f"{k}: wall {v['wall_ms']:.2f} ms, device busy "
        + ("not measured (no device operation recorded)" if v["busy_ms"] is None else
           f"{v['busy_ms']:.2f} ms = {v['busy_share']:.3f} of the wall")
        + f", {v['device_ops']:.0f} device operations" for k, v in shares.items())
        + f"; one traced step ran {ran} graphed, {eager_ran} eager, counted {want} on "
        "either route")

    rec["routes"] = eager_route_gates(scene, tiles, targets, fused)
    say("19 compiled grads", f"eager routes: {rec['routes']}")
    rec["backward"] = backward_times(scene, cam, eps)
    b = rec["backward"]
    say("19 compiled grads", f"K3's backward on {b['rays']} rays ({b['hits']} hits), every "
        f"input requiring grad, median ms: misses spread {b['median_ms']['spread']:.3f}, "
        f"on row 0 {b['median_ms']['zero']:.3f}, the nonzero backward "
        f"{b['median_ms']['nonzero']:.3f}; rel to it {b['rel_to_nonzero']}")
    compiled.clear()
    return rec


def main() -> int:
    if sys.argv[1:2] == ["--parallel-worker"]:
        return parallel_worker(sys.argv[2:])
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
    prim_lines = (prim_sweep_lines() + shade_lines() + shade_lines("table")
                  + shade_grad_lines())
    t, p, sizes = phase_tlas(eps)
    times.update(t)
    parity.update(p)
    for phase in (phase_elementwise, phase_streaming):
        t, p, z = phase(eps)
        times.update(t)
        parity.update(p)
        sizes.update(z)
    launches.update(phase_new_frames())
    grads = phase_gradients(eps)
    cli_record = phase_cli()
    parallel = phase_parallel()
    book = phase_book(eps)
    tools = phase_tools()
    compiled_record = phase_compiled()
    compiled_grads = phase_compiled_grads(eps)

    # each kernel's launches come from the frame that runs it: K3 from the
    # cow's default fused frame, K1 and K2 from its fused_shadow=False
    # frame, K3 with_sn from teapot_smooth's, K1 with_sn and K4 from
    # glass_teapot's, K5 and K6 from cow_herd's, K5 with_sn from
    # cow_herd_smooth's, K7a and K7b from the cow's elementwise frame, K1
    # t0 from the one-mesh herd's and K1 uv from the smooth one-mesh herd's.
    # "ms" is at "rays" and "plain_ms" at "plain_rays" (the same count,
    # except for K5, K6 and K7); K1 t0's and K1 uv's "ms" is one streamed
    # call of "launches_per_call" launches. "bound_ms" is the least time for
    # the work at "rays" (see bound()); no single PyTorch call computes any
    # of these functions, so "library_ms" is null. "device_ms" is the same
    # call with the host's dispatch hidden (device_ms; null for a streamed
    # call, which waits on the device). K2's, K3's, K4's and K6's
    # "bound_ms" is the lesser of two: the tests their walk needs
    # (occlusion_walk_work, census_walk_work, tlas_walk_work) and those of
    # the table-order loop it replaced (any_work, census_work, tlas_work),
    # which their lines add as "table_order_bound_ms"; K2's line adds
    # "glass_teapot_*" (glass_teapot's surface shadow rays) and "herd_*"
    # (the one-mesh herd's, streamed), K7a's and K7b's "herd_*" (cow_herd's
    # world-table wavefronts), K3's "phases_2_3_ms" (K3 - K1 on one
    # wavefront), K4's "reseated_*" (the re-seated census input), K6's
    # "surface_*" (its wavefront of the frame's surface shadow rays).
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
                              "cow_herd"),
             "closest_hit_elementwise": ("K7a elementwise closest hit", 58,
                                         "cow elementwise"),
             "any_hit_elementwise": ("K7b elementwise any-hit occlusion", 145,
                                     "cow elementwise"),
             "closest_hit_t0": ("K1 closest hit, with_t0 (streamed)", 413,
                                "cow_herd_mesh"),
             "closest_hit_uv": ("K1 closest hit, with_uv (streamed)", 413,
                                "cow_herd_mesh_smooth")}
    record = {"kernels": [
        {"name": label, "route": "cuda", "source": SOURCE,
         "replaces": f"{TPU_KERNELS}:{line}", "frame": frame,
         "launches": launches[frame][key], "max_abs_err": parity[key][0],
         "flips": parity[key][1], "ms": times[key][0], "device_ms": DEVICE_MS[key],
         "plain_ms": times[key][1], "bound_ms": BOUNDS[key][0],
         "bound_by": BOUNDS[key][1], "pair_tests": BOUNDS[key][2],
         "library_ms": None,
         **({"table_order_bound_ms": TABLE_ORDER_BOUNDS[key][0],
             "table_order_bound_by": TABLE_ORDER_BOUNDS[key][1],
             "table_order_pair_tests": TABLE_ORDER_BOUNDS[key][2]}
            if key in TABLE_ORDER_BOUNDS else {}),
         **EXTRA.get(key, {}),
         **sizes.get(key, dict(rays=MAIN_RAYS, plain_rays=MAIN_RAYS))}
        for key, (label, line, frame) in lines.items()] + [grads["object_rows"]]
        + prim_lines}
    print(json.dumps({"grads": grads}))
    print(json.dumps({"cli": cli_record}))
    print(json.dumps({"parallel": parallel}))
    print(json.dumps({"book": book}))
    print(json.dumps({"tools": tools}))
    print(json.dumps({"compiled": compiled_record}))
    print(json.dumps({"compiled_grads": compiled_grads}))
    print(json.dumps(record))
    print(f"card: {CARD}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


CARD = "no card"

if __name__ == "__main__":
    sys.exit(main())
