"""Profiling scene and trace helpers (src/dev/profile.h analog).

Counterpart of `voxel_tracer_tpu/utils/profiling.py`.  The reference's
PROFILING build renders a deterministic 8x8x8 grid of 512 crate volumes
with a canned camera (profile.h:10-37, camera_profiling.bin).  Here the
same scene is built from the reference's crate assets when the
environment variable VOXEL_TRACER_ASSET_DIR names a directory that holds
them (`ASSET_DIR`) and from procedural crates otherwise, then baked
into one 256^3 grid for the coherent kernel (`profiling_scene_merged`).

`trace()` records a `torch.profiler` trace of a code block (host and
device timelines, exported as a Chrome trace) and `annotate()` names a
span inside it.
"""

from __future__ import annotations

import contextlib
import os
import tempfile

import numpy as np

from voxel_tracer_tpu_torch.models.camera import Camera
from voxel_tracer_tpu_torch.models.volume import VoxelVolume
from voxel_tracer_tpu_torch.models.vox import load_vox

VOXEL = 1.0 / 20.0  # reference VOXEL scale (common.h:18, vpu 20)
# the reference's .vox assets: read only from the directory the caller
# names, so that a checkout renders the same scene wherever it lies
ASSET_DIR = os.environ.get("VOXEL_TRACER_ASSET_DIR")


@contextlib.contextmanager
def trace(logdir: str = None):
    """Record a `torch.profiler` trace (CPU and, where present, CUDA
    activity) around a code block; the Chrome trace is written to
    ``logdir``/trace.json.  Usage:

        with profiling.trace(d):
            out = render(...); torch.cuda.synchronize()
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    logdir = logdir or os.path.join(tempfile.gettempdir(), "voxel_tracer_trace")
    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """Named sub-span inside a `trace()` capture."""
    from torch.profiler import record_function

    return record_function(name)


def _procedural_crate(n: int = 32, mat: int = 30) -> np.ndarray:
    """Crate-ish hollow box with edge beams (stand-in for crate-16.vox)."""
    g = np.zeros((n, n, n), np.uint8)
    g[:2], g[-2:] = mat, mat
    g[:, :2], g[:, -2:] = mat, mat
    g[:, :, :2], g[:, :, -2:] = mat, mat
    g[2:-2, 2:-2, 2:-2] = 0
    # face planks
    g[2, 2:-2, 2:-2] = mat + 1
    g[-3, 2:-2, 2:-2] = mat + 1
    return g


def profiling_volumes(count_per_axis: int = 8):
    """The 512-crate scene (profile.h:23-36): crate models alternating by
    z layer, spaced VOXEL * 32 apart."""
    models = []
    for name in ("crate-16.vox", "crate-10.vox"):
        path = os.path.join(ASSET_DIR, name) if ASSET_DIR else None
        if path and os.path.exists(path):
            m = load_vox(path)
            models.append((m.grid, m.palette_f32))
        else:
            models.append((_procedural_crate(), None))

    vols = []
    spacing = VOXEL * 32.0
    n = count_per_axis
    for z in range(n):
        grid, pal = models[z % 2]
        for y in range(n):
            for x in range(n):
                vols.append(VoxelVolume(
                    grid, pal, pos=(spacing * x, spacing * y, spacing * z),
                    vpu=20.0))
    return vols


def profiling_camera(aspect: float) -> Camera:
    """Fixed profiling pose (camera_profiling.bin analog): outside the
    crate field, looking into its center."""
    n = 8
    span = VOXEL * 32.0 * n
    center = np.array([span, span, span]) * 0.5
    pos = center + np.array([-span * 0.7, span * 0.45, -span * 0.8])
    return Camera.create(pos, center, aspect)


def profiling_scene_merged():
    """The 512-crate scene baked into one grid for the coherent kernel."""
    from voxel_tracer_tpu_torch.ops.cuda.renderer_fast import bake_aligned_scene

    return bake_aligned_scene(profiling_volumes())
