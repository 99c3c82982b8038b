"""The reference's default scene, made from the seed as raw arrays, and the
orbit the render mixes look at it from.

A frozen copy of the suite's geometry (the port's
`utils/profiling.glass_box_scene`, which follows `bench_suite.py:381-457`):
the program and the reference are handed the same arrays, and each
derives its own tables from them.
"""

from __future__ import annotations

import math

import numpy as np

from port_bench.reference.geometry import procedural_sky

SUN_DIR = (-0.619501, 0.465931, -0.631765)     # scene.h:22
SUN_LIGHT = (0.95, 0.93, 0.875)                # scene.h:23


def _bake(parts, vpu):
    """Merge grid-aligned (grid, pos) volumes (pivot at the centre) into
    one grid; later solid voxels overwrite earlier ones.  Returns (grid,
    pos) of the merged volume."""
    los, his = [], []
    for grid, pos in parts:
        size = np.array(grid.shape[::-1], np.float32) / vpu
        lo = np.asarray(pos, np.float32) - size * 0.5
        los.append(lo)
        his.append(lo + size)
    lo = np.floor(np.min(los, axis=0) * vpu).astype(np.int64)
    hi = np.ceil(np.max(his, axis=0) * vpu).astype(np.int64)
    nx, ny, nz = (hi - lo).astype(int)
    out = np.zeros((nz, ny, nx), np.uint8)
    for grid, pos in parts:
        size = np.array(grid.shape[::-1], np.float32) / vpu
        off = np.round((np.asarray(pos, np.float32) - size * 0.5) * vpu).astype(np.int64) - lo
        gz, gy, gx = grid.shape
        region = out[off[2]:off[2] + gz, off[1]:off[1] + gy, off[0]:off[0] + gx]
        np.copyto(region, np.where(grid != 0, grid, region))
    size = np.array([nx, ny, nz], np.float32) / vpu
    return out, (lo / vpu + size * 0.5).astype(np.float32)


def build(config, seed):
    """The procedural stand-in for the reference's default scene
    (glass-box.vox and four enemy drones, src/scene.cpp:5-31), every length
    scaled by n / 128 (n the configuration's ``grid``): a floor (id 30), a
    hollow glass box with 2-voxel walls (id 4) around a pillar (id 40), a
    mirror plate (id 12) and four drone-sized ellipsoids baked into one
    n^3-ish grid; the palette drawn from ``seed``.  Returns a dict of raw
    arrays: grid, palette, pos, vpu, lights [(origin, radius, color,
    power)], sky, sun_dir, sun_light."""
    n = config["grid"]

    def s(v):
        return v * n // 128

    vpu = 20.0 * n / 128
    g = np.zeros((n, n, n), np.uint8)
    g[:, s(48):s(56), :] = 30
    g[s(30):s(70), s(56):s(96), s(30):s(70)] = 4
    g[s(32):s(68), s(56):s(94), s(32):s(68)] = 0
    g[s(44):s(56), s(56):s(84), s(44):s(56)] = 40
    g[s(20):s(70), s(56):s(110), s(90):s(94)] = 12
    m = s(16)
    c = (m - 1) / 2
    z, y, x = np.meshgrid(*[np.arange(m)] * 3, indexing="ij")
    body = ((x - c) ** 2 / (m / 2) ** 2 + (y - c) ** 2 / (m / 4) ** 2
            + (z - c) ** 2 / (m / 2) ** 2) <= 1.0
    parts = [(g, (0.8, 0.0, -1.7))]
    parts += [(np.where(body, 17 + 8 * i, 0).astype(np.uint8), (float(i), 2.0, 0.0))
              for i in range(4)]
    grid, pos = _bake(parts, vpu)
    pal = (np.random.default_rng(seed).random((256, 3)) * 0.8 + 0.1).astype(np.float32)
    return {"grid": grid, "palette": pal, "pos": pos, "vpu": vpu,
            "lights": [((2.0, 3.5, -1.5), 0.15, (1.0, 0.9, 0.8), 40.0)],
            "sky": procedural_sky(64, 32), "sun_dir": SUN_DIR, "sun_light": SUN_LIGHT}


def pose(scene, j, positions, radius, height):
    """The camera at orbit position j of ``positions``: ``radius`` from the
    scene's centre and ``height`` above it, looking at the centre; (pos,
    target).  The suite's orbit (bench_suite.py:452-457) takes the volume's
    position plus half its size for the centre, but a volume's position is
    its centre pivot, so that orbit circles the grid's far corner and half
    its views face away from the scene; this one circles the centre."""
    c0 = np.asarray(scene["pos"], np.float64)
    a = 2.0 * math.pi * j / positions
    return ((float(c0[0]) + radius * math.cos(a), float(c0[1]) + height,
             float(c0[2]) + radius * math.sin(a)), tuple(float(v) for v in c0))
