"""The reference's game scene (src/scene.cpp:5-31) as it ships: the glass
test box and four enemy drones as five separate volumes, made from the
seed as raw arrays; the drones' transforms at each frame of the orbit and
the orbit the game mix looks at them from.

The volumes are the procedural stand-ins of `glass_box.py` kept apart
instead of baked into one grid: the box (floor, hollow glass box, pillar
and mirror plate) at its own position, and four drone ellipsoids that
fly.  Each volume has its own palette, as each .vox carries its own.
The program and the reference are handed the same arrays and the same
transforms, and each derives its own tables from them.
"""

from __future__ import annotations

import math

import numpy as np

from port_bench.reference.geometry import procedural_sky
from port_bench.scenes.glass_box import SUN_DIR, SUN_LIGHT

BOX_POS = (0.8, 0.0, -1.7)     # the stand-in box's place in the port's game scene
DRONES = 4
FLIGHT_HEIGHT = 2.0            # the height the drones circle at
FLIGHT_RADIUS = 3.2            # their circle around the box's vertical axis


def _box(n):
    """The stand-in glass box of `glass_box.build`, n^3 (lengths scaled by
    n / 128): floor (id 30), hollow glass box (id 4), pillar (id 40) and
    mirror plate (id 12)."""
    def s(v):
        return v * n // 128

    g = np.zeros((n, n, n), np.uint8)
    g[:, s(48):s(56), :] = 30
    g[s(30):s(70), s(56):s(96), s(30):s(70)] = 4
    g[s(32):s(68), s(56):s(94), s(32):s(68)] = 0
    g[s(44):s(56), s(56):s(84), s(44):s(56)] = 40
    g[s(20):s(70), s(56):s(110), s(90):s(94)] = 12
    return g


def _drone(m, k):
    """Drone k: an m^3 ellipsoid of id 17 + 8 k (half as tall as wide)."""
    c = (m - 1) / 2
    z, y, x = np.meshgrid(*[np.arange(m)] * 3, indexing="ij")
    body = ((x - c) ** 2 / (m / 2) ** 2 + (y - c) ** 2 / (m / 4) ** 2
            + (z - c) ** 2 / (m / 2) ** 2) <= 1.0
    return np.where(body, 17 + 8 * k, 0).astype(np.uint8)


def build(config, seed):
    """The five volumes from ``seed``: ``grid`` (the box's n, 128 as
    shipped) at vpu 20 n / 128 and ``drone_grid`` (m, 16) at vpu 20 m / 16,
    so that their sizes in the world stay 6.4 and 0.8 at any n and m; five
    palettes drawn from the seed.  Returns a dict of raw arrays: volumes
    [{grid, palette, pos, rot, vpu}] (the box first, at rest; the drones at
    orbit position 0), lights [(origin, radius, color, power)], sky,
    sun_dir, sun_light and the centre of the volumes' union box (``centre``)."""
    n, m = config["grid"], config["drone_grid"]
    pal = (np.random.default_rng(seed).random((1 + DRONES, 256, 3)) * 0.8 + 0.1
           ).astype(np.float32)
    eye = np.eye(3, dtype=np.float32)
    vols = [{"grid": _box(n), "palette": pal[0], "pos": np.asarray(BOX_POS, np.float32),
             "rot": eye, "vpu": 20.0 * n / 128}]
    vols += [{"grid": _drone(m, k), "palette": pal[1 + k], "pos": np.zeros(3, np.float32),
              "rot": eye, "vpu": 20.0 * m / 16} for k in range(DRONES)]
    raw = {"volumes": vols,
           "lights": [((2.0, 3.5, -1.5), 0.15, (1.0, 0.9, 0.8), 40.0)],
           "sky": procedural_sky(64, 32), "sun_dir": SUN_DIR, "sun_light": SUN_LIGHT}
    for v, (rot, pos) in zip(vols[1:], transforms(raw, 0, 1)):
        v["rot"], v["pos"] = rot, pos
    raw["centre"] = union_centre(raw)
    return raw


def yaw_matrix(yaw):
    """The rotation about +y by ``yaw`` (the port's `game/enemy` convention)."""
    c, s = math.cos(yaw), math.sin(yaw)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]], np.float32)


def transforms(raw, j, positions):
    """Each drone's (rot (3, 3), pos (3,)) float32 at orbit position j of
    ``positions``: drone k on a circle of radius FLIGHT_RADIUS around the
    box's vertical axis at FLIGHT_HEIGHT, one lap in ``positions`` frames,
    phase k pi / 2, yawed to face its velocity, yaw = atan2(v.x, v.z)
    (enemy.cpp:38-41)."""
    cx, _cy, cz = BOX_POS
    out = []
    for k in range(DRONES):
        a = 2.0 * math.pi * j / positions + k * math.pi / 2
        pos = np.array([cx + FLIGHT_RADIUS * math.cos(a), FLIGHT_HEIGHT,
                        cz + FLIGHT_RADIUS * math.sin(a)], np.float32)
        vx, vz = -math.sin(a), math.cos(a)
        out.append((yaw_matrix(math.atan2(vx, vz)), pos))
    return out


def union_centre(raw):
    """The centre of the world AABB around the volumes as they stand in
    ``raw`` (each volume's box through |R|, obb.cpp:37-46)."""
    los, his = [], []
    for v in raw["volumes"]:
        rot, pos = v["rot"], v["pos"]
        gz, gy, gx = v["grid"].shape
        half = np.array([gx, gy, gz], np.float64) / v["vpu"] * 0.5
        ext = np.abs(np.asarray(rot, np.float64)) @ half
        los.append(np.asarray(pos, np.float64) - ext)
        his.append(np.asarray(pos, np.float64) + ext)
    return (np.min(los, axis=0) + np.max(his, axis=0)) * 0.5


def pose(raw, j, positions, radius, height):
    """The camera at orbit position j of ``positions``: ``radius`` from the
    centre of the five volumes' union box and ``height`` above it, looking
    at the centre; (pos, target).  The centre is the union's at orbit
    position 0 (`build`), where the drones' circle lies inside the box's."""
    c0 = raw["centre"]
    a = 2.0 * math.pi * j / positions
    return ((float(c0[0]) + radius * math.cos(a), float(c0[1]) + height,
             float(c0[2]) + radius * math.sin(a)), tuple(float(v) for v in c0))
