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


def budget_scene(length: int = 4096, n_rays: int = 65536, seed: int = 0):
    """A long sparse volume whose rays run out of the DDA's 256-step budget.

    Grid (Z, Y, X) = (16, 16, length) at vpu 8: a random fill of about one
    voxel in 10,000, and every third brick along x holding one voxel in an
    outer corner, so that rays near the centre line (y = z = 8 voxels) walk
    it without hitting.  ``n_rays`` local rays start before x = 0 and head
    along +x: half within a voxel of the centre line with y/z slopes under
    0.004 (they cross from brick to brick near corners, and most spend the
    budget), a quarter anywhere with the same slopes, a quarter anywhere
    with slopes under 0.03 (most leave through a side).  Returns (grid,
    origins (N, 3) float32, directions (N, 3) float32, vpu), made with
    numpy from ``seed``.
    """
    vpu = 8.0
    rng = np.random.RandomState(seed)
    g = np.zeros((16, 16, length), np.uint8)
    fill = rng.rand(*g.shape) < 1e-4
    g[fill] = rng.randint(1, 256, int(fill.sum()))
    bx = np.arange(0, length // 8, 3)
    zs, ys = (np.where(rng.rand(bx.size) < 0.5, 0, 15) for _ in range(2))
    xs = bx * 8 + np.where(rng.rand(bx.size) < 0.5, 0, 7)
    g[zs, ys, xs] = rng.randint(1, 256, bx.size)

    n = n_rays
    yz = rng.uniform(0.25, 15.75, (n, 2))
    yz[: n // 2] = 8.0 + rng.uniform(-1.0, 1.0, (n // 2, 2))
    slope = rng.uniform(-0.004, 0.004, (n, 2))
    slope[3 * n // 4:] *= 7.5
    o = np.stack([np.full(n, -0.5), yz[:, 0], yz[:, 1]], axis=1) / vpu
    d = np.stack([np.ones(n), slope[:, 0], slope[:, 1]], axis=1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return g, o.astype(np.float32), d.astype(np.float32), vpu
