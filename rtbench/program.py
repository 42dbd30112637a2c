"""The system under test, rtc_tpu_torch, through its public entries: the
scene API builds the World a configuration file describes,
scene.compile.compile_scene compiles it, render.renderer.render draws a
frame, and diff.render_grad.make_train_step steps a fit. Every call goes
through the module attribute at call time."""

from __future__ import annotations

import os

import numpy as np
import torch

PACKAGE = "rtc_tpu_torch"


class Program:
    def __init__(self, config: dict, root: str, device: str):
        from rtc_tpu_torch.utils.config import RenderConfig

        self.config, self.root, self.device = config, root, device
        r = config["render"]
        self.dtype = {"float32": torch.float32, "float64": torch.float64}[r["dtype"]]
        self.cfg = RenderConfig(max_depth=r["max_depth"], dtype=r["dtype"],
                                fused_shadow=r["fused_shadow"])

    @staticmethod
    def _matrix(ops):
        from rtc_tpu_torch.ops import transforms as X

        m = np.eye(4)
        for name, *args in ops or ():
            m = m @ np.asarray(getattr(X, name)(*args), np.float64)
        return m

    def _material(self, spec: dict):
        from rtc_tpu_torch.scene import materials as M

        spec = dict(spec)
        pat = spec.pop("pattern", None)
        if pat is not None:
            pat = getattr(M, f"{pat['kind']}_pattern")(pat["a"], pat["b"]).set_transform(
                self._matrix(pat.get("transform")))
        if "color" in spec:
            spec["color"] = tuple(spec["color"])
        return M.Material(pattern=pat, **spec)

    def world(self):
        from rtc_tpu_torch.io.obj import Parser
        from rtc_tpu_torch.scene import shapes
        from rtc_tpu_torch.scene.world import PointLight, World

        objects = []
        for spec in self.config["objects"]:
            if spec["kind"] == "mesh":
                shape = Parser.from_obj_file(os.path.join(self.root, spec["file"])).obj_to_group(
                    smooth=spec.get("smooth", False))
                shape.set_transform(self._matrix(spec.get("transform")))
                shape.set_material(self._material(spec["material"]))
            else:
                shape = getattr(shapes, spec["kind"])(
                    transform=self._matrix(spec.get("transform")),
                    material=self._material(spec["material"]))
            objects.append(shape)
        light = self.config["light"]
        return World(objects=objects, light=PointLight(tuple(light["position"]),
                                                       tuple(light["intensity"])))

    def compile(self, world):
        from rtc_tpu_torch.scene import compile as C

        return C.compile_scene(world, dtype=self.dtype, device=self.device,
                               containers=self.config["render"]["containers"])

    def camera(self, frm):
        from rtc_tpu_torch.ops import transforms as X
        from rtc_tpu_torch.render.camera import Camera

        c, cam = self.config["canvas"], self.config["camera"]
        return Camera(c["width"], c["height"], c["field_of_view"]).set_transform(
            X.view_transform(frm, cam["to"], cam["up"]))

    def render(self, scene, camera):
        from rtc_tpu_torch.render import renderer

        return renderer.render(scene, camera, self.cfg)

    def colors(self, scene, o, d):
        """The colours of a wavefront under the configuration (no grad)."""
        from rtc_tpu_torch.render import integrator

        with torch.no_grad():
            return integrator.color_at(scene, o, d, self.cfg)

    def params(self, scene, names):
        from rtc_tpu_torch.diff import render_grad

        return render_grad.extract_params(scene, names)

    def with_params(self, scene, params):
        from rtc_tpu_torch.diff import render_grad

        return render_grad.inject_params(scene, params)

    def train_step(self, optimizer):
        from rtc_tpu_torch.diff import render_grad

        return render_grad.make_train_step(optimizer, self.cfg)

    def release(self) -> None:
        """Drop the program's cached CUDA graphs and their pools."""
        from rtc_tpu_torch.render import compiled

        compiled.clear()
