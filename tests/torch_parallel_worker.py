"""A rank of tests/test_torch_parallel.py's process grids.

Usage: python torch_parallel_worker.py <rank> <world> <port> <outdir>

Joins a gloo process group of <world> CPU ranks at localhost:<port>
through rtc_tpu_torch.parallel.multihost.initialize, runs the cases of
that world size (Worker.world_2, Worker.world_4) and writes each result into <outdir> as
<case>_r<rank>.npy (a dict of arrays as .npz). The test compares them
with rtc_tpu, run in the pytest process. Prints WORKER_OK at the end.
"""

import os
import sys

import numpy as np
import torch

from rtc_tpu_torch.diff import render_grad as RG
from rtc_tpu_torch.models.scenes import REGISTRY
from rtc_tpu_torch.parallel import mesh as grid
from rtc_tpu_torch.parallel import multihost
from rtc_tpu_torch.parallel.shard import pad_tris, render_sharded, shard_scene
from rtc_tpu_torch.render import integrator
from rtc_tpu_torch.render.camera import camera_rays
from rtc_tpu_torch.scene.compile import compile_scene
from rtc_tpu_torch.utils.config import RenderConfig
from rtc_tpu_torch.utils.constants import BIG

TILE = 512
F64 = RenderConfig(dtype="float64", ray_tile=TILE)
# the prim-sharded renders: case -> (scene, width, n_rays, n_prims,
# max_depth of the float64 render), each rendered in float64 and in
# float32 (at the default depth, 5). glass_teapot's float64 render is at
# depth 8: at 5 only the primary node reads n1/n2, from outside the glass,
# where every count is 0; at 8 the refracted node's rays start inside it.
# (In float32 at depth 8 the port's single-rank render, sharded or not,
# differs from rtc_tpu's on knife-edge pixels beyond assert_images_match's
# budget; tests/test_torch_refraction.py holds that render to the golden
# under F32_BUDGET instead.)
PRIM_CASES = {"prims_1x2_teapot": ("teapot", 32, 1, 2, 5),
              "prims_2x2_glass_spheres": ("glass_spheres", 48, 2, 2, 5),
              "prims_2x2_glass_teapot": ("glass_teapot", 24, 2, 2, 8)}
# the prim-sharded gradient's parameters: DEFAULT_PARAMS and the
# triangle rows' first corner, whose gradient crosses the combine
GRAD_PARAMS = RG.DEFAULT_PARAMS + ("tri_p1",)


def scene_of(name: str, width: int, cfg: RenderConfig):
    world, cam = REGISTRY[name](width)
    return compile_scene(world, dtype=cfg.torch_dtype(), device="cpu"), cam


def primary_rays(cam):
    return camera_rays(cam.transform_inverse, cam.hsize, cam.vsize, cam.half_width,
                       cam.half_height, cam.pixel_size, torch.float64)


class Worker:
    def __init__(self, rank: int, out: str):
        self.rank, self.out = rank, out

    def save(self, name: str, value) -> None:
        path = os.path.join(self.out, f"{name}_r{self.rank}")
        if isinstance(value, dict):
            np.savez(path + ".npz", **{k: np.asarray(v) for k, v in value.items()})
        else:
            np.save(path + ".npy", np.asarray(value))

    def render(self, case: str, name: str, width: int, n_rays: int, n_prims: int,
               cfg: RenderConfig) -> None:
        scene, cam = scene_of(name, width, cfg)
        mesh = grid.make_mesh(n_rays, n_prims, device_type="cpu")
        img = render_sharded(scene, cam, cfg, mesh, shard_prims=n_prims > 1)
        self.save(case, img.numpy())

    def prim_renders(self, world: int) -> None:
        for case, (name, width, n_rays, n_prims, depth) in PRIM_CASES.items():
            if n_rays * n_prims == world:
                for cfg in (RenderConfig(dtype="float64", ray_tile=TILE, max_depth=depth),
                            RenderConfig(dtype="float32", ray_tile=TILE)):
                    self.render(f"{case}_{cfg.dtype}", name, width, n_rays, n_prims, cfg)

    def prim_sharded_grads(self) -> None:
        """loss_and_grad on teapot at 16 in f64, the triangle table over a
        1x2 grid: each rank's gradients of its shard's rows and of the
        replicated parameters."""
        scene, cam = scene_of("teapot", 16, F64)
        mesh = grid.make_mesh(1, 2, device_type="cpu")
        prims = grid.mesh_axis(mesh, "prims")
        shard = shard_scene(pad_tris(scene, prims.size), prims.rank, prims.size)
        o, d = primary_rays(cam)
        params = RG.extract_params(shard, GRAD_PARAMS)
        cfg = RenderConfig(dtype="float64", prim_axis="prims")
        with grid.active_grid(mesh):
            loss, grads = RG.loss_and_grad(params, shard, o, d,
                                           torch.full_like(o, 0.25), cfg)
        self.save("grad_prims", dict(grads, loss=loss, tri_offset=shard.tri_offset))

    def census(self) -> None:
        """integrator.mesh_census of glass_teapot at 24 in f64 over the 2x2
        grid's prims groups, on the primary rays re-seated 1e-3 past their
        hit (t_hit BIG, no hit row: crossings from inside the glass, and
        at negative t), and the same census on the whole table."""
        scene, cam = scene_of("glass_teapot", 24, F64)
        mesh = grid.make_mesh(2, 2, device_type="cpu")
        prims = grid.mesh_axis(mesh, "prims")
        shard = shard_scene(pad_tris(scene, prims.size), prims.rank, prims.size)
        o, d = primary_rays(cam)
        hit = integrator.closest_hit(scene, o, d, F64)
        o = o + d * (torch.where(hit.valid, hit.t, 0.0)[:, None] + 1e-3)
        t_in = torch.full_like(hit.t, BIG)
        g_in = torch.full_like(hit.tri, -2)
        whole = integrator.mesh_census(scene, o, d, t_in, g_in, F64)
        with grid.active_grid(mesh):
            sharded = integrator.mesh_census(
                shard, o, d, t_in, g_in, RenderConfig(dtype="float64",
                                                      prim_axis="prims"))
        self.save("census", dict(cnt=sharded[0], last=sharded[1],
                                 whole_cnt=whole[0], whole_last=whole[1]))

    def world_2(self) -> None:
        self.render("rays_2x1_float64", "three_spheres", 64, 2, 1, F64)
        self.prim_renders(2)
        scene, cam = scene_of("three_spheres", 16, F64)
        img = multihost.render_multihost(scene, cam, F64)
        self.save("multihost", np.zeros(0) if img is None else img.numpy())
        loss, grads = multihost.train_step_multihost(scene, cam, F64)
        self.save("train_step", dict(grads, loss=loss))
        self.prim_sharded_grads()
        try:  # what the grid refuses: a rank count that is not the grid's
            grid.make_mesh(3, 1, device_type="cpu")
        except ValueError as e:
            self.save("make_mesh_error", np.array(str(e)))

    def world_4(self) -> None:
        self.prim_renders(4)
        self.census()


def main() -> int:
    rank, world, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    torch.set_num_threads(1)
    multihost.initialize(f"localhost:{port}", world, rank, backend="gloo")
    try:
        getattr(Worker(rank, out), f"world_{world}")()
    finally:
        torch.distributed.destroy_process_group()
    print("WORKER_OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
