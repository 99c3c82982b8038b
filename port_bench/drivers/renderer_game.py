"""Frames of the port's wavefront `Renderer.render` over a moving scene, one
at a time: the game scene's drones fly and turn every frame.

The scene is set up once (`Scene.data`).  Frame i moves the drones to their
transforms at orbit position i mod ``orbit_positions`` with
`SceneData.with_transforms`, which uploads their rotations and positions
alone, then renders from the same orbit position with i mod 120 as the
frame number, both inside the timed frame.  Checked and traced frames are
chosen as in `renderer_render` (the seed draws the checked frames; the
traced ones are the same for every seed), and the reference renders each
checked frame at the same transforms (`reference/rigid.py`).
"""

from __future__ import annotations

import importlib
import time

import numpy as np
import torch

from port_bench import loop
from port_bench.drivers import renderer_render
from port_bench.reference import render as ref
from port_bench.reference import rigid
from port_bench.reference.geometry import camera_corners


class Cell(renderer_render.Cell):
    """`renderer_render.Cell` (window, units, check) over the moving scene."""

    def __init__(self, config, mix, seed, device):
        from voxel_tracer_tpu_torch.models.camera import Camera
        from voxel_tracer_tpu_torch.models.scene import Scene
        from voxel_tracer_tpu_torch.models.skydome import SkyDome
        from voxel_tracer_tpu_torch.models.volume import VoxelVolume
        from voxel_tracer_tpu_torch.renderer import RenderConfig, Renderer

        t0 = time.perf_counter()
        self.device = device
        self.cfg = {**config["render"], **mix.get("render", {})}
        self.scene_mod = importlib.import_module(f"port_bench.scenes.{config['scene']}")
        raw = self.raw = self.scene_mod.build(config, seed)
        vols = raw["volumes"]
        scene = Scene(volumes=[VoxelVolume(v["grid"], v["palette"], pos=v["pos"], rot=v["rot"],
                                           vpu=v["vpu"]) for v in vols],
                      skydome=SkyDome(raw["sky"]),
                      sun_dir=np.asarray(raw["sun_dir"], np.float32),
                      sun_light=np.asarray(raw["sun_light"], np.float32))
        for light in raw["lights"]:
            scene.add_light(*light)
        # the global object index of each moving volume (the box, first, stays)
        self.movers = rigid.order(self._tuples())[1:]
        t1 = time.perf_counter()
        self.scene = scene.data(device)
        self.renderer = Renderer(RenderConfig(**self.cfg), device=device)
        self.camera = Camera.create
        self.aspect = self.cfg["width"] / self.cfg["height"]
        self.positions = p = mix["orbit_positions"]
        self.radius, self.height = mix["orbit_radius"], mix["orbit_height"]
        self.keeps = renderer_render.checked_frames(seed, p, mix["check_frames"], mix["check_laps"])
        self.kept = {}
        k = mix["trace_positions"]
        self.trace_units = [j * p // k for j in range(k)]
        t2 = time.perf_counter()
        for i in range(mix["warmup_frames"]):
            self.frame(i * p // max(1, mix["warmup_frames"]))
        loop.sync(device)
        self.setup_phases = {"inputs": t1 - t0, "program": t2 - t1,
                             "warmup": time.perf_counter() - t2}

    def _tuples(self, moves=None):
        """The volumes as (grid, palette, pos, rot, vpu), the drones at
        ``moves`` (their (rot, pos) list) where given."""
        vols = self.raw["volumes"]
        out = [(v["grid"], v["palette"], v["pos"], v["rot"], v["vpu"]) for v in vols]
        for k, (rot, pos) in enumerate(moves or []):
            v = vols[1 + k]
            out[1 + k] = (v["grid"], v["palette"], pos, rot, v["vpu"])
        return out

    def view(self, i):
        j, f = i % self.positions, i % 120
        pos, target = self.scene_mod.pose(self.raw, j, self.positions, self.radius, self.height)
        return pos, target, f, self.scene_mod.transforms(self.raw, j, self.positions)

    def frame(self, i):
        pos, target, f, moves = self.view(i)
        scene = self.scene.with_transforms(dict(zip(self.movers, moves)))
        return self.renderer.render(scene, self.camera(pos, target, self.aspect), frame=f)

    def reference(self, i, q=ref.identity):
        """The reference's frame i (its outputs) and its traversal calls."""
        raw = self.raw
        pos, target, f, moves = self.view(i)
        scene = rigid.build(self._tuples(moves), raw["lights"], raw["sky"], raw["sun_dir"],
                            raw["sun_light"], self.device, q=q)
        with torch.no_grad():
            out = ref.render_frame(scene, camera_corners(pos, target, self.aspect), self.cfg, f)
        return out, scene.calls
