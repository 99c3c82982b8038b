"""Kernel renderer: lit frames with primary and shadow rays through B5.

Counterpart of `voxel_tracer_tpu/ops/pallas/renderer_fast.py`.  Primary
rays and the sun's shadow rays (parallel, so coherent) both go through the
coherent kernel (`ops/cuda/coherent.py`), one launch per volume and pass,
min-combined over volumes.  Grid-aligned static volumes should be merged
first with `bake_aligned_scene`: the 512-crate profiling scene
(src/dev/profile.h) becomes one 256^3 grid.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from voxel_tracer_tpu_torch.models.camera import Camera, rays_for_image
from voxel_tracer_tpu_torch.models.scene import SUN_DIR, SUN_LIGHT
from voxel_tracer_tpu_torch.models.skydome import SkyDome, SkyDomeData, sample_sky
from voxel_tracer_tpu_torch.models.volume import VoxelVolume
from voxel_tracer_tpu_torch.ops.cuda import coherent
from voxel_tracer_tpu_torch.ops.cuda.integrate import (FastVolume, _trace_fast,
                                                       image_of_tiles,
                                                       tiles_of_image)
from voxel_tracer_tpu_torch.ops.math3d import BIG_F32, dot
from voxel_tracer_tpu_torch.ops.tonemap import aces_approx


def bake_aligned_scene(volumes: Sequence[VoxelVolume]) -> VoxelVolume:
    """Merge identity-rotation, grid-aligned volumes into one volume.

    All volumes must share vpu and sit on the voxel lattice; the merged
    volume takes volume 0's palette.  Later volumes' solid voxels
    overwrite earlier ones where they overlap."""
    if not volumes:
        raise ValueError("no volumes to bake")
    vpu = volumes[0].vpu
    mins, maxs = [], []
    for v in volumes:
        if not np.allclose(v.rot, np.eye(3)):
            raise ValueError("bake requires axis-aligned volumes")
        if v.vpu != vpu:
            raise ValueError("bake requires one vpu for all volumes")
        lo = v.pos - v.pivot
        mins.append(lo)
        maxs.append(lo + v.size)
    lo = np.floor(np.min(mins, axis=0) * vpu).astype(np.int64)
    hi = np.ceil(np.max(maxs, axis=0) * vpu).astype(np.int64)
    nx, ny, nz = (hi - lo).astype(int)
    grid = np.zeros((nz, ny, nx), np.uint8)
    for v in volumes:
        off = np.round((v.pos - v.pivot) * vpu).astype(np.int64) - lo
        gz, gy, gx = v.grid.shape
        region = grid[off[2]:off[2] + gz, off[1]:off[1] + gy,
                      off[0]:off[0] + gx]
        np.copyto(region, np.where(v.grid != 0, v.grid, region))
    merged = VoxelVolume(grid, palette=volumes[0].palette, vpu=vpu)
    merged.pos = (lo / vpu + merged.pivot).astype(np.float32)
    return merged


class FastScene(NamedTuple):
    """Volumes, sun and sky of the kernel renderer, on one device."""

    volumes: tuple              # FastVolume each
    sun_dir: torch.Tensor       # (3,)
    sun_light: torch.Tensor     # (3,)
    sky: torch.Tensor           # (H, W, 3) sky pixels

    @staticmethod
    def build(volumes, sky=None, sun_dir=None, sun_light=None,
              device="cuda"):
        """Pack ``volumes`` (VoxelVolume or FastVolume each) for the
        kernel; the sky defaults to `SkyDome.procedural(256, 128)`."""
        fvs = tuple(v if isinstance(v, FastVolume) else FastVolume(v, device)
                    for v in volumes)

        def vec(v, default):
            return torch.tensor(np.asarray(default if v is None else v,
                                           np.float32), device=device)
        sky = sky if sky is not None else SkyDome.procedural(256, 128)
        return FastScene(volumes=fvs, sun_dir=vec(sun_dir, SUN_DIR),
                         sun_light=vec(sun_light, SUN_LIGHT),
                         sky=torch.tensor(sky.pixels, device=device))


def _trace_scene(volumes, origins, dirs, use_fallback, trace_fn):
    """Nearest hit over all volumes (one kernel launch per volume)."""
    best = None
    for fv in volumes:
        hit = _trace_fast(fv, origins, dirs, use_fallback, trace_fn)
        best = hit if best is None else best.nearer(hit)
    return best


def _lambert(scene, camera, width, height, ambient, use_fallback, trace_fn):
    dev = scene.sky.device
    origins, dirs = rays_for_image(camera, width, height, device=dev)
    tiled = width % 32 == 0 and height % 32 == 0
    if tiled:   # square pixel tiles: neighbouring rays cross the same bricks
        origins = tiles_of_image(origins, height, width)
        dirs = tiles_of_image(dirs, height, width)
    hit = _trace_scene(scene.volumes, origins, dirs, use_fallback, trace_fn)
    missed = hit.t >= BIG_F32

    # shadow rays toward the (fixed) sun: a missed pixel's starts near
    # 1e30, outside every volume, and misses at the slab test
    p = origins + dirs * hit.t[:, None] + hit.normal * 1e-4
    incidence = dot(hit.normal, scene.sun_dir)
    sdirs = torch.broadcast_to(scene.sun_dir, p.shape).contiguous()
    shadow = _trace_scene(scene.volumes, p, sdirs, use_fallback, trace_fn)
    lit = (incidence > 0.0) & (shadow.t >= BIG_F32)
    irr = torch.where(lit[:, None], scene.sun_light * incidence[:, None],
                      0.0) + ambient

    sky = sample_sky(SkyDomeData(pixels=scene.sky), dirs)
    img = aces_approx(torch.where(missed[:, None], sky, hit.albedo * irr))
    outs = dict(image=img, albedo=torch.where(missed[:, None], sky, hit.albedo),
                irradiance=irr, depth=hit.t, normal=hit.normal,
                steps=hit.steps + shadow.steps, material=hit.mat)
    if tiled:
        outs = {k: image_of_tiles(v, height, width) for k, v in outs.items()}
    return {k: v.reshape(height, width, *v.shape[1:]) for k, v in outs.items()}


def render_lambert_fast(scene: FastScene, camera: Camera, width: int,
                        height: int, ambient: float = 0.2,
                        use_fallback: bool = False):
    """Sun + shadow-ray + flat-ambient frame, both passes on the B5 kernel.
    Returns image, albedo, irradiance, normal (H, W, 3) and depth, steps,
    material (H, W)."""
    return _lambert(scene, camera, width, height, ambient, use_fallback,
                    coherent.trace_coherent)


def render_lambert_fast_plain(scene: FastScene, camera: Camera, width: int,
                              height: int, ambient: float = 0.2):
    """`render_lambert_fast` with B5's plain PyTorch version, on any
    device."""
    return _lambert(scene, camera, width, height, ambient, False,
                    coherent.trace_coherent_plain)
