"""Scene: voxel volumes, sphere lights, analytic primitives and sky.

Counterpart of `voxel_tracer_tpu/models/scene.py` (the reference Scene,
src/graphics/scene.{h,cpp}).  The host-side `Scene` holds numpy volumes;
`Scene.data(device)` uploads it as a `SceneData` of tensors, with the
volumes grouped by grid shape and each group stacked along a leading
object axis (`ops/composite.py` composes the nearest hit across them).

Default sun direction/color match scene.h:22-23.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from voxel_tracer_tpu_torch.models.skydome import SkyDome, SkyDomeData
from voxel_tracer_tpu_torch.models.volume import VolumeData, VoxelVolume

SUN_DIR = np.array([-0.619501, 0.465931, -0.631765], np.float32)  # scene.h:22
SUN_LIGHT = np.array([0.95, 0.93, 0.875], np.float32)             # scene.h:23


class SphereLightData(NamedTuple):
    """Stacked spherical area lights (sphere-light.{h,cpp} analog)."""

    origin: torch.Tensor   # (L, 3)
    radius: torch.Tensor   # (L,)
    color: torch.Tensor    # (L, 3)
    power: torch.Tensor    # (L,)
    aoe_sqr: torch.Tensor  # (L,) area-of-effect dist^2 = power / (4 pi)


class SceneData(NamedTuple):
    """Device-side scene.  Volumes grouped by identical grid shape: each
    group is a VolumeData whose tensors carry a leading object axis."""

    groups: Tuple[VolumeData, ...]
    sun_dir: torch.Tensor
    sun_light: torch.Tensor
    lights: SphereLightData
    sky: SkyDomeData
    prims: "PrimsData"        # analytic spheres/capsules (ops/prims.py)


@dataclass
class SphereLight:
    origin: np.ndarray
    radius: float
    color: np.ndarray
    power: float


@dataclass
class Scene:
    """Host-side scene container."""

    volumes: List[VoxelVolume] = field(default_factory=list)
    lights: List[SphereLight] = field(default_factory=list)
    sun_dir: np.ndarray = field(default_factory=lambda: SUN_DIR.copy())
    sun_light: np.ndarray = field(default_factory=lambda: SUN_LIGHT.copy())
    skydome: Optional[SkyDome] = None
    spheres: List[tuple] = field(default_factory=list)
    capsules: List[tuple] = field(default_factory=list)

    def add(self, volume: VoxelVolume) -> "Scene":
        self.volumes.append(volume)
        return self

    def add_light(self, origin, radius, color, power) -> "Scene":
        self.lights.append(SphereLight(
            np.asarray(origin, np.float32), float(radius),
            np.asarray(color, np.float32), float(power)))
        return self

    def add_sphere(self, origin, radius, mat=17, albedo=None) -> "Scene":
        """Analytic sphere (sphere.cpp; albedo=None = normal-as-color)."""
        self.spheres.append((origin, radius, mat, albedo))
        return self

    def add_capsule(self, a, b, radius, mat=None, albedo=None) -> "Scene":
        """Analytic capsule; defaults are the laser beam (capsule.cpp:56-70:
        material 0xFF, emissive red)."""
        from voxel_tracer_tpu_torch.ops.prims import LASER_ALBEDO, LASER_MAT
        self.capsules.append((a, b, radius,
                              LASER_MAT if mat is None else mat,
                              LASER_ALBEDO if albedo is None else albedo))
        return self

    def set_laser(self, path, radius=0.01) -> "Scene":
        """Replace the laser capsule chain from a polyline (game.cpp:76-83)."""
        self.capsules = [c for c in self.capsules if c[3] != 0xFF]
        for a, b in zip(path[:-1], path[1:]):
            self.add_capsule(a, b, radius)
        return self

    def data(self, device="cuda") -> SceneData:
        """Upload to ``device``: group volumes by grid shape and stack each
        group."""
        from voxel_tracer_tpu_torch.ops.prims import build_prims

        by_shape = {}
        for v in self.volumes:
            by_shape.setdefault(v.grid.shape, []).append(v)
        groups = []
        for _shape, vols in sorted(by_shape.items()):
            datas = [v.data(device) for v in vols]
            groups.append(VolumeData(*(torch.stack(f) for f in zip(*datas))))

        def f32(xs, shape):
            return torch.tensor(np.array(xs, np.float32).reshape(shape),
                                device=device)
        nl = len(self.lights)
        power = f32([l.power for l in self.lights], (nl,))
        lights = SphereLightData(
            origin=f32([l.origin for l in self.lights], (nl, 3)),
            radius=f32([l.radius for l in self.lights], (nl,)),
            color=f32([l.color for l in self.lights], (nl, 3)),
            power=power,
            aoe_sqr=power / (4.0 * np.pi),  # sphere-light.h aprox_aoe_sqr
        )
        return SceneData(
            groups=tuple(groups),
            prims=build_prims(self.spheres, self.capsules, device),
            sun_dir=f32(self.sun_dir, (3,)),
            sun_light=f32(self.sun_light, (3,)),
            lights=lights,
            sky=(self.skydome or SkyDome.black()).data(device),
        )
