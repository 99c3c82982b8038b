"""CPU oracle: scalar NumPy re-implementation of the traversal semantics.

This package's copy of `voxel_tracer_tpu/ops/oracle.py` (numpy only), for
the game's laser queries and the tests.

This is the ground truth for parity tests (BASELINE.md: "allclose to a CPU
reference re-implementation of the repo's traversal").  It mirrors the
reference C++ semantics:

- pinhole camera ray generation    (src/graphics/camera.h:32-37)
- OBB slab entry test              (src/graphics/primitives/basic/obb.cpp:48-80)
- two-level brickmap DDA           (src/graphics/primitives/vv.cpp:127-369)
- `MAX_STEPS = 256` shared step budget across brick + fine loops
  (vv.cpp:7, shared `hit.steps` counter)

Deviations from the reference (shared by the JAX implementation and
`ops/dda.py`, so parity holds by construction):

- the slab test runs in the volume's local space (our transforms are rigid,
  so this is the same math as the reference's world-space axis projections);
- the entry normal comes from the argmax slab axis instead of epsilon face
  matching (obb.cpp:108-126) — robust at corners, identical elsewhere.

Everything here is deliberately slow scalar code; it checks the traversal
on small scenes and answers single-ray queries.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

BIG_F32 = np.float32(1e30)
MAX_STEPS = 256
BRICK = 8  # brick edge length in voxels (vv.h:23-38 Brick512)


@dataclasses.dataclass
class OracleVolume:
    """Dense voxel grid with a rigid transform (OVoxelVolume analog)."""

    grid: np.ndarray          # (Z, Y, X) uint8 material ids, 0 = air
    vpu: float = 20.0         # voxels per world unit (vv.h:106 default)
    pos: np.ndarray = None    # world position of the pivot
    rot: np.ndarray = None    # (3,3) rotation matrix
    pivot: np.ndarray = None  # local pivot (default: center)
    palette: np.ndarray = None  # (256, 3) float albedo per material id

    def __post_init__(self):
        gz, gy, gx = self.grid.shape
        self.size = np.array([gx, gy, gz], np.float32) / np.float32(self.vpu)
        if self.pos is None:
            self.pos = np.zeros(3, np.float32)
        if self.rot is None:
            self.rot = np.eye(3, dtype=np.float32)
        if self.pivot is None:
            self.pivot = self.size * 0.5
        if self.palette is None:
            self.palette = np.ones((256, 3), np.float32)
        self.pos = np.asarray(self.pos, np.float32)
        self.rot = np.asarray(self.rot, np.float32)
        self.pivot = np.asarray(self.pivot, np.float32)
        # Brick occupancy: number of solid voxels per 8^3 brick (voxcnt analog)
        bz, by, bx = [int(math.ceil(s / BRICK)) for s in self.grid.shape]
        pad = np.zeros((bz * BRICK, by * BRICK, bx * BRICK), self.grid.dtype)
        pad[: gz, : gy, : gx] = self.grid
        self.brick_occ = (
            pad.reshape(bz, BRICK, by, BRICK, bx, BRICK) != 0
        ).sum(axis=(1, 3, 5)).astype(np.int32)

    def world_to_local(self, p):
        return self.rot.T @ (p - self.pos) + self.pivot

    def world_to_local_vec(self, v):
        return self.rot.T @ v

    def local_to_world_vec(self, v):
        return self.rot @ v


def make_camera(pos, target, width, height):
    """Camera basis: Camera::tick semantics (src/graphics/camera.cpp:3-16).

    Focal distance 2 ahead, half-width = aspect, half-height = 1.
    """
    pos = np.asarray(pos, np.float32)
    target = np.asarray(target, np.float32)
    up_world = np.array([0, 1, 0], np.float32)
    ahead = target - pos
    ahead = ahead / np.linalg.norm(ahead)
    right = np.cross(up_world, ahead)
    right = right / np.linalg.norm(right)
    up = np.cross(ahead, right)
    up = up / np.linalg.norm(up)
    aspect = np.float32(width) / np.float32(height)
    tl = pos + 2.0 * ahead - aspect * right + up
    tr = pos + 2.0 * ahead + aspect * right + up
    bl = pos + 2.0 * ahead - aspect * right - up
    return dict(pos=pos, tl=tl, tr=tr, bl=bl, width=width, height=height)


def primary_ray(cam, x, y):
    """Per-pixel primary ray (src/graphics/camera.h:32-37)."""
    u = np.float32(x) / np.float32(cam["width"])
    v = np.float32(y) / np.float32(cam["height"])
    end = cam["tl"] + u * (cam["tr"] - cam["tl"]) + v * (cam["bl"] - cam["tl"])
    d = end - cam["pos"]
    return cam["pos"], d / np.linalg.norm(d)


def slab_test(origin_l, dir_l, size):
    """Slab entry/exit in local space vs AABB [0, size].

    Returns (tmin, tmax, axis) with tmin clamped to >= 0; hit iff
    tmax - 1e-4 >= tmin (obb.cpp:73 early-out epsilon).
    axis = slab axis that defines the entry face.
    """
    tmin, tmax = np.float32(0.0), BIG_F32
    axis = 0
    for d in range(3):
        rcp = np.float32(1.0) / dir_l[d]  # may be +-inf
        t1 = (np.float32(0.0) - origin_l[d]) * rcp
        t2 = (size[d] - origin_l[d]) * rcp
        if t1 > t2:
            t1, t2 = t2, t1
        if t1 > tmin:
            tmin = t1
            axis = d
        tmax = min(tmax, t2)
        if tmax - np.float32(1e-4) < tmin:
            return BIG_F32, -BIG_F32, 0
    return tmin, tmax, axis


def sign_of(d):
    """+1 for d >= +0, -1 for negative (incl. -0): ray.h:80-97 bit trick."""
    return -1 if math.copysign(1.0, d) < 0 else 1


def hash_shadow(seed, x, y, z):
    """Shadow-ray hash -> uniform [0,1); bit-identical to dda.hash_shadow
    (the deterministic replacement for RandomFloat(), vv.cpp:322)."""
    M = 0xFFFFFFFF
    h = (int(seed) ^ (int(x) * 0x9E3779B1) ^ (int(y) * 0x85EBCA77)
         ^ (int(z) * 0xC2B2AE3D)) & M
    h = h ^ (h >> 16)
    h = (h * 0x7FEB352D) & M
    h = h ^ (h >> 15)
    h = (h * 0x846CA68B) & M
    h = h ^ (h >> 16)
    return np.float32(h) * np.float32(1.0 / 4294967296.0)


def _ladder_axis(tmax3):
    """Reference tmax comparison ladder (vv.cpp:208-219)."""
    if tmax3[0] < tmax3[1]:
        return 0 if tmax3[0] < tmax3[2] else 2
    return 1 if tmax3[1] < tmax3[2] else 2


@dataclasses.dataclass
class OracleHit:
    depth: float = float(BIG_F32)
    material: int = 0
    normal: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, np.float32))
    albedo: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, np.float32))
    steps: int = 0

    @property
    def no_hit(self):
        return self.depth >= BIG_F32


def intersect_volume(vol: OracleVolume, origin, dirn,
                     medium=0, ignore=0, shadow=False, seed=0):
    """Two-level brickmap DDA (vv.cpp:127-369 semantics).

    ``medium``: interior exit march (Ray::medium_id, vv.cpp:166-232) — the
    first voxel differing from the medium / an empty brick / the OBB exit
    plane terminates the march (interior rays never miss).
    ``ignore``: scan-ray pass-through of one material until air is seen
    (vv.cpp:328-335; the `exited` flag persists across bricks here, see
    ops/dda.py docstring).  ``shadow``+``seed``: stochastic <=16
    pass-through with the deterministic hash (vv.cpp:314-327).
    """
    hit = OracleHit()
    o_l = vol.world_to_local(np.asarray(origin, np.float32))
    d_l = vol.world_to_local_vec(np.asarray(dirn, np.float32))

    tmin, tmax, entry_axis = slab_test(o_l, d_l, vol.size)
    if tmax < tmin:
        if medium:
            # Slab miss inside a medium: exit at t = 0, air (vv.cpp:228-232)
            hit.depth = 0.0
            hit.material = 0
        return hit

    gz, gy, gx = vol.grid.shape
    bz, by, bx = vol.brick_occ.shape
    bsize = np.array([bx, by, bz], np.int32)       # brick-grid size, xyz order
    vsize = np.array([gx, gy, gz], np.int32)

    vpu = np.float32(vol.vpu)
    bpu = vpu / BRICK
    rbpu = np.float32(1.0) / bpu

    step = np.array([sign_of(d) for d in d_l], np.int32)
    rdir = np.float32(1.0) / d_l                    # per-axis reciprocal (inf ok)
    delta = np.abs(rdir)

    # Brick-level entry (vv.cpp:136-146)
    entry = (o_l + d_l * tmin) * bpu
    cell = np.clip(np.floor(entry).astype(np.int64), 0, bsize - 1).astype(np.int32)
    tmax3 = ((cell.astype(np.float32) - entry) + np.maximum(step, 0)) * rdir

    t = np.float32(0.0)
    axis = entry_axis
    steps = 0
    exited = False

    def world_normal(ax):
        n_l = np.zeros(3, np.float32)
        n_l[ax] = -float(step[ax])
        n_w = vol.local_to_world_vec(n_l)
        return n_w / np.linalg.norm(n_w)

    while steps < MAX_STEPS:
        # brick occupancy test
        occ = vol.brick_occ[cell[2], cell[1], cell[0]]
        if occ > 0:
            brick_entry_t = tmin + t * rbpu
            # `axis` is shared between brick and fine loops (vv.cpp:156:
            # traverse_brick takes it by reference) — a fine hit at the
            # brick's entry voxel keeps the brick-level step axis.
            fdist, steps, f_axis, fine_hit, exited = _traverse_brick(
                vol, cell, o_l, d_l, rdir, step, brick_entry_t, rbpu, vpu,
                steps, vsize, axis, medium, ignore, shadow, seed, exited
            )
            if fine_hit is not None:
                hit.depth = brick_entry_t + fdist
                hit.material = fine_hit
                hit.albedo = vol.palette[fine_hit].astype(np.float32)
                hit.steps = steps
                # Entry-voxel hits keep the slab entry normal (vv.cpp:159)
                hit.normal = world_normal(entry_axis if steps == 0 else f_axis)
                return hit
        elif medium:
            # Empty brick while inside a medium: exit at the brick entry
            # plane with material air (vv.cpp:166-175)
            hit.depth = tmin + t * rbpu
            hit.material = 0
            hit.albedo = vol.palette[0].astype(np.float32)
            hit.steps = steps
            hit.normal = world_normal(entry_axis if steps == 0 else axis)
            return hit
        elif ignore:
            exited = True

        # Amanatides & Woo brick step (vv.cpp:176-202)
        if tmax3[0] < tmax3[1]:
            if tmax3[0] < tmax3[2]:
                cell[0] += step[0]
                if cell[0] < 0 or cell[0] >= bsize[0]:
                    break
                axis, t = 0, tmax3[0]
                tmax3[0] += delta[0]
            else:
                cell[2] += step[2]
                if cell[2] < 0 or cell[2] >= bsize[2]:
                    break
                axis, t = 2, tmax3[2]
                tmax3[2] += delta[2]
        else:
            if tmax3[1] < tmax3[2]:
                cell[1] += step[1]
                if cell[1] < 0 or cell[1] >= bsize[1]:
                    break
                axis, t = 1, tmax3[1]
                tmax3[1] += delta[1]
            else:
                cell[2] += step[2]
                if cell[2] < 0 or cell[2] >= bsize[2]:
                    break
                axis, t = 2, tmax3[2]
                tmax3[2] += delta[2]
        steps += 1

    hit.steps = steps
    if medium:
        # Grid exit / step-budget exhaustion inside a medium: exit at the
        # OBB exit distance with material air, normal from the tmax ladder
        # (vv.cpp:206-225; exit_t = slab tmax, obb.cpp:82-106)
        hit.depth = float(tmax)
        hit.material = 0
        hit.albedo = vol.palette[0].astype(np.float32)
        hit.normal = world_normal(_ladder_axis(tmax3))
    return hit


def _traverse_brick(vol, bcell, o_l, d_l, rdir, step, entry_t, rbpu, vpu, steps, vsize,
                    axis=0, medium=0, ignore=0, shadow=False, seed=0,
                    exited=False):
    """Fine 8^3 DDA inside one brick (vv.cpp:237-369 semantics).

    Returns (dist_from_brick_entry, steps, axis, material_or_None, exited).
    """
    bmin = bcell.astype(np.float32) * rbpu
    entry = (o_l + d_l * entry_t - bmin) * vpu
    cell = np.clip(np.floor(entry).astype(np.int64), 0, BRICK - 1).astype(np.int32)
    delta = np.abs(rdir)
    tmax3 = ((cell.astype(np.float32) - entry) + np.maximum(step, 0)) * rdir

    t = np.float32(0.0)
    while steps < MAX_STEPS:
        # voxel coordinates in the full grid
        vc = bcell * BRICK + cell
        if np.all(vc < vsize):
            voxel = int(vol.grid[vc[2], vc[1], vc[0]])
        else:
            voxel = 0  # padding region of a non-multiple-of-8 grid
        if medium:
            # Interior exit: first voxel differing from the medium
            # (vv.cpp:297-310); material may be 0 = air
            if voxel != medium:
                return t / vpu, steps, axis, voxel, exited
        elif voxel != 0:
            if shadow:
                # ids > 16 occlude; glass/mirror occlude with p = 0.15
                # (vv.cpp:314-327)
                if voxel > 16 or hash_shadow(seed, vc[0], vc[1], vc[2]) > 0.85:
                    return t / vpu, steps, axis, voxel, exited
            elif exited or voxel != ignore:
                return t / vpu, steps, axis, voxel, exited
        elif ignore:
            exited = True

        if tmax3[0] < tmax3[1]:
            if tmax3[0] < tmax3[2]:
                cell[0] += step[0]
                if cell[0] < 0 or cell[0] >= BRICK:
                    break
                axis, t = 0, tmax3[0]
                tmax3[0] += delta[0]
            else:
                cell[2] += step[2]
                if cell[2] < 0 or cell[2] >= BRICK:
                    break
                axis, t = 2, tmax3[2]
                tmax3[2] += delta[2]
        else:
            if tmax3[1] < tmax3[2]:
                cell[1] += step[1]
                if cell[1] < 0 or cell[1] >= BRICK:
                    break
                axis, t = 1, tmax3[1]
                tmax3[1] += delta[1]
            else:
                cell[2] += step[2]
                if cell[2] < 0 or cell[2] >= BRICK:
                    break
                axis, t = 2, tmax3[2]
                tmax3[2] += delta[2]
        steps += 1

    return float(BIG_F32), steps, axis, None, exited


def intersect_scene(volumes, origin, dirn, **flags):
    """Nearest-hit composition across volumes (Scene::intersect analog)."""
    best = OracleHit()
    for vol in volumes:
        h = intersect_volume(vol, origin, dirn, **flags)
        if h.depth < best.depth:
            best = h
    return best


def render_flat(volumes, cam, background=(0.0, 0.0, 0.0)):
    """Flat-albedo forward render: image[y, x] = palette albedo or background."""
    h, w = cam["height"], cam["width"]
    img = np.zeros((h, w, 3), np.float32)
    depth = np.full((h, w), BIG_F32, np.float32)
    normals = np.zeros((h, w, 3), np.float32)
    steps = np.zeros((h, w), np.int32)
    bg = np.asarray(background, np.float32)
    for y in range(h):
        for x in range(w):
            o, d = primary_ray(cam, x, y)
            hit = intersect_scene(volumes, o, d)
            steps[y, x] = hit.steps
            if hit.no_hit:
                img[y, x] = bg
            else:
                img[y, x] = hit.albedo
                depth[y, x] = hit.depth
                normals[y, x] = hit.normal
    return dict(image=img, depth=depth, normal=normals, steps=steps)
