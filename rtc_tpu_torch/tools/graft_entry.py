"""Driver entry points (counterpart of __graft_entry__.py).

entry(device) -> (fn, example_args): a forward step on the flagship scene
  (the cow OBJ mesh, 5,804 world-baked triangles, through the wavefront
  Whitted integrator with reflection), on the card unless device="cpu".

dryrun_multichip(n, device) runs ONE full differentiable training step
  (color_at -> squared-error loss -> gradients -> SGD update of the
  material and light parameters) on a ('rays', 'prims') grid of n ranks:
  rays data-parallel, the triangle table split over 'prims' (each rank's
  K1 and K2 on its own shard, the hits combined by least t), the
  parameter gradients summed over 'rays'. The ranks are processes of this
  module over torch.distributed's gloo backend, all on the one card (NCCL
  refuses two ranks on one device), or on the CPU.

Certification, as __graft_entry__.py: the sharded render and gradients
against one rank's, in float64 with a tight 1e-5 gate (float64 takes the
plain sweep on every backend, so this measures the sharding's semantics),
then the float32 step (the kernels on the card) with looser gates; the
split kernels under prim sharding against one rank's kernel render (cow at
32, fused_shadow=False); and the prim-sharded cow_herd at 16. Every metric
prints on one line before any gate fires.

    python -m rtc_tpu_torch.tools.graft_entry [--ranks=4] [--device=cuda]

runs entry() and then dryrun_multichip(ranks).
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

from ..diff import render_grad as RG
from ..models.scenes import REGISTRY
from ..parallel import collectives as coll
from ..parallel import mesh as grid
from ..parallel import multihost
from ..parallel.shard import pad_tris, prim_shard, render_sharded
from ..render import integrator
from ..render.camera import camera_rays
from ..render.renderer import render
from ..scene.compile import compile_scene
from ..utils.config import RenderConfig
from .common import synchronize, timeit

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
RANK_TIMEOUT = 900  # seconds the ranks of a dry run may take, start-up included
RESULT = "DRYRUN_RESULT "


def _flagship(width: int = 64, dtype: str = "float32", device="cuda"):
    world, cam = REGISTRY["cow"](width)
    dt = RenderConfig(dtype=dtype).torch_dtype()
    scene = compile_scene(world, dtype=dt, device=device)
    o, d = camera_rays(cam.transform_inverse, cam.hsize, cam.vsize, cam.half_width,
                       cam.half_height, cam.pixel_size, dt, device=device)
    return scene, o, d


def entry(device="cuda"):
    """(fn, (scene, o, d)): fn(scene, o, d) is color_at of the cow's 64x32
    primary rays, float32, ray_tile 2048."""
    cfg = RenderConfig(dtype="float32", ray_tile=2048)
    scene, o, d = _flagship(64, device=device)

    def fn(scene, o, d):
        return integrator.color_at(scene, o, d, cfg)

    return fn, (scene, o, d)


def grid_shape(n_devices: int) -> tuple:
    """(n_rays, n_prims): a 4-way prims axis from 8 ranks on, else 2-way
    where the count is even, else none (__graft_entry__.py :80-88)."""
    if n_devices % 4 == 0 and n_devices >= 8:
        n_prims = 4
    elif n_devices % 2 == 0 and n_devices >= 2:
        n_prims = 2
    else:
        n_prims = 1
    return n_devices // n_prims, n_prims


class _Rank:
    """This rank's part of the dry run on the grid mesh."""

    def __init__(self, mesh, n_rays: int, n_prims: int, device):
        self.mesh, self.device = mesh, device
        self.n_rays, self.n_prims = n_rays, n_prims
        self.rays = grid.mesh_axis(mesh, "rays")
        self.prims = grid.mesh_axis(mesh, "prims")
        self.lead = torch.distributed.get_rank() == 0

    def build(self, dtype: str):
        """The padded scene and rays, this rank's shard and rays, and the
        sharded and single-rank configs of one dtype."""
        scene, o, d = _flagship(64, dtype, self.device)
        scene = pad_tris(scene, self.n_prims * 4)
        pad = (-o.shape[0]) % self.n_rays
        o = torch.cat([o, o.new_zeros((pad, 3))])
        d = torch.cat([d, d.new_ones((pad, 3))])
        n_local = o.shape[0] // self.n_rays
        mine = slice(self.rays.rank * n_local, (self.rays.rank + 1) * n_local)
        shard = (prim_shard(scene, self.prims.rank, self.n_prims) if self.n_prims > 1
                 else scene)
        cfg = RenderConfig(dtype=dtype, ray_tile=max(1, n_local),
                           prim_axis="prims" if self.n_prims > 1 else None)
        cfg_single = RenderConfig(dtype=dtype, ray_tile=o.shape[0])
        target = torch.full_like(o, 0.5)
        return dict(scene=scene, shard=shard, o=o, d=d, mine=mine, target=target,
                    cfg=cfg, cfg_single=cfg_single)

    def step(self, b, params, lr: float = 1e-2):
        """One SGD step: each rank differentiates the loss of its own rays
        (and, under 'prims', its shard), then the gradients and the loss sum
        over 'rays' and divide by n_total. Returns (new params, loss,
        grads, the whole image gathered over 'rays')."""
        mine = b["mine"]
        n_total = b["o"].shape[0] * 3
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        with grid.active_grid(self.mesh):
            img = integrator.color_at(RG.inject_params(b["shard"], leaves), b["o"][mine],
                                      b["d"][mine], b["cfg"])
            lval = torch.sum((img - b["target"][mine]) ** 2)
            grads = torch.autograd.grad(lval, list(leaves.values()), allow_unused=True)
        grads = {k: coll.all_reduce(torch.zeros_like(v) if g is None else g,
                                    self.rays) / n_total
                 for (k, v), g in zip(leaves.items(), grads)}
        loss = coll.all_reduce(lval.detach(), self.rays) / n_total
        new = {k: (p - lr * grads[k]).detach() for k, p in params.items()}
        return new, float(loss), grads, coll.all_gather(img.detach(), self.rays).reshape(-1, 3)

    def forward(self, b):
        with torch.no_grad(), grid.active_grid(self.mesh):
            return integrator.color_at(b["shard"], b["o"][b["mine"]], b["d"][b["mine"]],
                                       b["cfg"])

    def certify(self, dtype: str):
        """(img_err, grad_err, state): the sharded step's image and
        gradients against one rank's (on rank 0; None elsewhere)."""
        b = self.build(dtype)
        params = RG.extract_params(b["scene"])
        new, loss, grads, img = self.step(b, params)
        img_err = gerr = None
        if self.lead:
            scene, o, d, cfg1 = b["scene"], b["o"], b["d"], b["cfg_single"]
            with torch.no_grad():
                img_err = float((img - integrator.color_at(scene, o, d, cfg1)).abs().max())
            n_total = o.shape[0] * 3
            leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
            im = integrator.color_at(RG.inject_params(scene, leaves), o, d, cfg1)
            ref = torch.autograd.grad(torch.sum((im - b["target"]) ** 2) / n_total,
                                      list(leaves.values()), allow_unused=True)
            gerr = 0.0
            for (k, v), g in zip(leaves.items(), ref):
                g = torch.zeros_like(v) if g is None else g
                denom = float(g.abs().max()) or 1.0
                gerr = max(gerr, float((grads[k] - g).abs().max()) / denom)
        return img_err, gerr, dict(b=b, params=params, new=new, loss=loss)

    def sharded_against_single(self, name: str, width: int, cfg, pad: int):
        """max |render_sharded - render| of name at width, the triangle
        table over 'prims' (rank 0's; None elsewhere)."""
        world, cam = REGISTRY[name](width)
        scene = compile_scene(world, dtype=torch.float32, device=self.device)
        if pad:
            scene = pad_tris(scene, pad)
        img_n = render_sharded(scene, cam, cfg, mesh=self.mesh, shard_prims=True)
        if not self.lead:
            return None
        return float((render(scene, cam, cfg) - img_n).abs().max())

    def run(self) -> dict | None:
        """The dry run's metrics on rank 0, None on the others."""
        img_err64, gerr64, _ = self.certify("float64")
        img_err32, gerr32, s = self.certify("float32")
        b, params = s["b"], s["params"]
        delta = float((s["new"]["mat_color"] - params["mat_color"]).abs().sum())

        kerr = herr = float("nan")
        if self.n_prims > 1:
            # the split kernels under prim sharding: K1 and K2 on each
            # shard's own tables against one rank's kernel render (the
            # plain sweep on the CPU, where the integrator takes no kernel)
            cuda = torch.device(self.device).type == "cuda"
            kcfg = RenderConfig(ray_tile=512, fused_shadow=False,
                                mesh_impl="kernel" if cuda else "bruteforce")
            kerr = self.sharded_against_single("cow", 32, kcfg, 0)
            # "scenes too big to replicate": the 523k-triangle herd, a
            # shard of the world table a rank, the plain sweep
            herr = self.sharded_against_single(
                "cow_herd", 16, RenderConfig(ray_tile=128, mesh_impl="bruteforce"),
                self.n_prims)

        # timing: the step, the sharded forward, and the forward of one
        # rank's share of the rays on one rank (weak scaling)
        train_s = timeit(lambda: self.step(b, params), self.device)
        fwd_s = timeit(lambda: self.forward(b), self.device)
        n_local = b["o"].shape[0] // self.n_rays
        fwd1_s = None
        if self.lead:
            cfg1 = RenderConfig(dtype="float32", ray_tile=n_local)
            o1, d1 = b["o"][:n_local], b["d"][:n_local]
            with torch.no_grad():
                fwd1_s = timeit(lambda: integrator.color_at(b["scene"], o1, d1, cfg1),
                                 self.device)
        torch.distributed.barrier()
        if not self.lead:
            return None
        # the collectives' payload a rank contributes, per sweep: the prim
        # combine gathers (t, n) and (obj, row), 16 + 8 bytes a ray, the
        # shadow OR reduces 4 bytes a ray; the gradients sum once a step
        Dp = self.n_prims
        return dict(
            mesh={"rays": self.n_rays, "prims": self.n_prims}, loss=s["loss"],
            param_delta=delta, img_err_f64=img_err64, grad_err_f64=gerr64,
            img_err_f32=img_err32, grad_err_f32=gerr32, kernel_shard_err=kerr,
            herd_523k_shard_err=herr, train_step_ms=train_s * 1e3, fwd_ms=fwd_s * 1e3,
            step_fwd_ratio=train_s / fwd_s if fwd_s > 0 else float("nan"),
            weak_scaling_eff=fwd1_s / fwd_s if fwd_s > 0 else float("nan"),
            minbyt_allgather_B_per_sweep=Dp * n_local * (16 + 8),
            shadow_psum_B_per_sweep=Dp * n_local * 4,
            grad_psum_floats=sum(v.numel() for v in params.values()))


def _rank_main(rank: int, world: int, port: str, device) -> int:
    """One rank of dryrun_multichip: joins the gloo group of world ranks
    at localhost:port, runs its part, and rank 0 prints the metrics."""
    if torch.device(device).type == "cpu":
        torch.set_num_threads(2)
    else:
        torch.backends.cuda.matmul.allow_tf32 = False
    multihost.initialize(f"localhost:{port}", world, rank, backend="gloo")
    try:
        n_rays, n_prims = grid_shape(world)
        mesh = grid.make_mesh(n_rays, n_prims, device_type=torch.device(device).type)
        out = _Rank(mesh, n_rays, n_prims, device).run()
        if out is not None:
            print(RESULT + json.dumps(out), flush=True)
    finally:
        torch.distributed.destroy_process_group()
    return 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(n_devices: int, device="cuda") -> dict:
    """Start the n ranks (processes of this module) and wait for all of
    them; a rank that fails or passes RANK_TIMEOUT stops them all and
    raises. Returns rank 0's metrics."""
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (_ROOT, os.environ.get("PYTHONPATH")) if p))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "rtc_tpu_torch.tools.graft_entry", "--rank", str(r),
         "--world", str(n_devices), "--port", port, "--device", str(device)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=_ROOT, env=env)
        for r in range(n_devices)]
    outs = []
    deadline = time.monotonic() + RANK_TIMEOUT
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, text) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"dryrun rank {r} exited {p.returncode}:\n{text[-4000:]}")
    lines = [ln for ln in outs[0].splitlines() if ln.startswith(RESULT)]
    if len(lines) != 1:
        raise RuntimeError(f"dryrun rank 0 printed no result:\n{outs[0][-4000:]}")
    return json.loads(lines[0][len(RESULT):])


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """The sharded train step on an n-rank grid (grid_shape) and its
    certification; prints every metric on one line, then raises on the
    first gate that fails (__graft_entry__.py :282-294). Returns the
    metrics."""
    m = run_ranks(n_devices, device)
    print(f"dryrun_multichip({n_devices}): mesh={m['mesh']} "
          f"loss={m['loss']:.6f} param_delta={m['param_delta']:.2e} "
          f"img_err_f64={m['img_err_f64']:.2e} grad_err_f64={m['grad_err_f64']:.2e} "
          f"img_err_f32={m['img_err_f32']:.2e} grad_err_f32={m['grad_err_f32']:.2e} "
          f"kernel_shard_err={m['kernel_shard_err']:.2e} "
          f"herd_523k_shard_err={m['herd_523k_shard_err']:.2e} "
          f"train_step_ms={m['train_step_ms']:.1f} fwd_ms={m['fwd_ms']:.1f} "
          f"step_fwd_ratio={m['step_fwd_ratio']:.2f} "
          f"weak_scaling_eff={m['weak_scaling_eff']:.2f} "
          f"minbyt_allgather_B_per_sweep={m['minbyt_allgather_B_per_sweep']} "
          f"shadow_psum_B_per_sweep={m['shadow_psum_B_per_sweep']} "
          f"grad_psum_floats={m['grad_psum_floats']}", flush=True)
    gates = [
        (np.isfinite(m["loss"]), f"non-finite loss {m['loss']}"),
        (np.isfinite(m["param_delta"]) and m["param_delta"] > 0.0,
         "material gradient did not flow"),
        (m["img_err_f64"] < 1e-5, f"sharded f64 render diverges: {m['img_err_f64']:.2e}"),
        (m["grad_err_f64"] < 1e-5, f"sharded f64 grads diverge: {m['grad_err_f64']:.2e}"),
        (m["img_err_f32"] < 1e-3, f"sharded f32 render diverges: {m['img_err_f32']:.2e}"),
        (m["grad_err_f32"] < 1e-2, f"sharded f32 grads diverge: {m['grad_err_f32']:.2e}"),
    ]
    if m["mesh"]["prims"] > 1:
        gates += [(m["kernel_shard_err"] < 1e-3,
                   f"prim-sharded kernel diverges: {m['kernel_shard_err']:.2e}"),
                  (m["herd_523k_shard_err"] < 1e-3,
                   f"prim-sharded herd diverges: {m['herd_523k_shard_err']:.2e}")]
    for ok, msg in gates:
        if not ok:
            raise AssertionError(msg)
    return m


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="rtc_tpu_torch.tools.graft_entry",
                                     description=__doc__.split("\n\n")[0])
    parser.add_argument("--ranks", type=int, default=4)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--world", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--port", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.rank is not None:
        return _rank_main(args.rank, args.world, args.port, args.device)
    fn, fn_args = entry(args.device)
    out = fn(*fn_args)
    synchronize(args.device)
    print("entry ok:", tuple(out.shape))
    dryrun_multichip(args.ranks, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
