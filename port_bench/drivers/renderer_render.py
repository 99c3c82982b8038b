"""Frames of the port's wavefront `Renderer.render`, one at a time.

The window renders the mix's orbit: frame i looks from orbit position
i mod ``orbit_positions`` and passes i mod 120 as the frame number that
seeds the stochastic shadows and the noise, so every seed renders the
same views in the same order.  The seed draws the scene's palette and the
``check_frames`` window frames that are kept and, after the window, held
against the reference's frames of the same views: one from each equal
stretch of the orbit, in one of its first ``check_laps`` laps.  The traced
readings render a fixed set of frames, the same for every seed:
``trace_positions`` frames evenly spaced over the first lap.
"""

from __future__ import annotations

import importlib
import time

import numpy as np
import torch

from port_bench import compare, loop
from port_bench.reference import render as ref
from port_bench.reference.geometry import camera_corners

KEPT = ("image", "albedo", "color", "irradiance", "depth", "material")


def checked_frames(seed, positions, frames, laps):
    """The window frames a seed checks: one in each of ``frames`` equal
    stretches of the orbit, each in a lap below ``laps``."""
    rng = np.random.default_rng(seed)
    span = positions // frames
    return sorted(int(rng.integers(0, laps)) * positions + s * span + int(rng.integers(0, span))
                  for s in range(frames))


class Cell:
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
        scene = Scene(volumes=[VoxelVolume(raw["grid"], raw["palette"], pos=raw["pos"],
                                           vpu=raw["vpu"])],
                      skydome=SkyDome(raw["sky"]),
                      sun_dir=np.asarray(raw["sun_dir"], np.float32),
                      sun_light=np.asarray(raw["sun_light"], np.float32))
        for light in raw["lights"]:
            scene.add_light(*light)
        t1 = time.perf_counter()
        self.scene = scene.data(device)
        self.renderer = Renderer(RenderConfig(**self.cfg), device=device)
        self.camera = Camera.create
        self.aspect = self.cfg["width"] / self.cfg["height"]
        self.positions = p = mix["orbit_positions"]
        self.radius, self.height = mix["orbit_radius"], mix["orbit_height"]
        self.keeps = checked_frames(seed, p, mix["check_frames"], mix["check_laps"])
        self.kept = {}
        k = mix["trace_positions"]
        self.trace_units = [j * p // k for j in range(k)]
        t2 = time.perf_counter()
        for i in range(mix["warmup_frames"]):
            self.frame(i * p // max(1, mix["warmup_frames"]))
        loop.sync(device)
        self.setup_phases = {"inputs": t1 - t0, "program": t2 - t1,
                             "warmup": time.perf_counter() - t2}

    def view(self, i):
        j, f = i % self.positions, i % 120
        pos, target = self.scene_mod.pose(self.raw, j, self.positions, self.radius, self.height)
        return pos, target, f

    def frame(self, i):
        pos, target, f = self.view(i)
        return self.renderer.render(self.scene, self.camera(pos, target, self.aspect), frame=f)

    def store(self, i, out):
        if i in self.keeps:
            self.kept[i] = {k: out[k] for k in KEPT}

    def window(self, seconds):
        n, s, lat = loop.closed_loop(self.frame, seconds, max(self.keeps), self.store,
                                     self.device)
        return n, loop.frame_metrics(n, s, lat)

    def run(self, units):
        """The frames ``units``, each ended by a synchronize, as in the window."""
        for i in units:
            self.frame(i)
            loop.sync(self.device)

    def release(self):
        del self.scene, self.renderer
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, i, q=ref.identity):
        """The reference's frame i (its outputs) and its traversal calls."""
        raw = self.raw
        scene = ref.RefScene.build([(raw["grid"], raw["palette"], raw["pos"], raw["vpu"])],
                                   raw["lights"], raw["sky"], raw["sun_dir"],
                                   raw["sun_light"], self.device, q=q)
        pos, target, f = self.view(i)
        with torch.no_grad():
            out = ref.render_frame(scene, camera_corners(pos, target, self.aspect), self.cfg, f)
        return out, scene.calls

    def check(self, trace):
        """The worst of each number over the checked frames; with ``trace``
        also the reference's traversal calls of the traced frames."""
        numbers = compare.worst([compare.frame_numbers(self.kept[i], self.reference(i)[0])
                                 for i in self.keeps])
        work = {}
        if trace:
            calls = [c for i in self.trace_units for c in self.reference(i)[1]]
            work = {"d1_calls": calls, "units": len(self.trace_units)}
        return numbers, work
