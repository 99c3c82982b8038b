"""Pinhole camera + view pyramid planes.

Counterpart of `voxel_tracer_tpu/models/camera.py` (the reference camera,
src/graphics/camera.{h,cpp}, and Pyramid, src/graphics/rays/pyramid.cpp).
The basis (tl/tr/bl) is derived from pos/target like Camera::tick
(camera.cpp:3-16).  Camera fields are float32 CPU tensors; ray generation
runs on the card unless the caller asks for another `device`.  The view
pyramid's planes project world points to the previous frame's UV for
temporal reprojection (`pyramid_project`, pyramid.cpp:52-66).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from voxel_tracer_tpu_torch.ops import math3d as m3

UP = (0.0, 1.0, 0.0)


class Camera(NamedTuple):
    """Immutable camera state. All fields are (3,) float32 unless noted."""

    pos: torch.Tensor
    target: torch.Tensor
    tl: torch.Tensor
    tr: torch.Tensor
    bl: torch.Tensor
    planes: torch.Tensor    # (4, 4) left/right/top/bottom plane equations
    forward: torch.Tensor   # (4,) forward plane equation

    @staticmethod
    def create(pos, target, aspect: float = 16.0 / 9.0) -> "Camera":
        """Camera looking from ``pos`` to ``target``: focal distance 2,
        frustum half-extent (aspect, 1) (camera.cpp:3-16)."""
        pos = torch.as_tensor(pos, dtype=torch.float32)
        target = torch.as_tensor(target, dtype=torch.float32)
        return Camera(pos, target, *_basis_and_pyramid(pos, target, aspect))

    def look_at(self, pos, target, aspect: float = 16.0 / 9.0) -> "Camera":
        return Camera.create(pos, target, aspect)


def _basis_and_pyramid(pos, target, aspect):
    ahead = m3.normalize(target - pos)
    right = m3.normalize(m3.cross(torch.tensor(UP, dtype=torch.float32), ahead))
    up = m3.normalize(m3.cross(ahead, right))
    tl = pos + 2.0 * ahead - aspect * right + up
    tr = pos + 2.0 * ahead + aspect * right + up
    bl = pos + 2.0 * ahead - aspect * right - up

    # Pyramid plane equations (pyramid.cpp:5-40); corner dirs relative to pos
    ctl, ctr, cbl = tl - pos, tr - pos, bl - pos
    cbr = ctr - (ctl - cbl)

    def plane(a, b):
        n = m3.normalize(m3.cross(a, b))
        return torch.cat([n, -torch.dot(n, pos)[None]])

    planes = torch.stack([
        plane(cbl, ctl),   # left
        plane(ctr, cbr),   # right
        plane(ctl, ctr),   # top
        plane(cbr, cbl),   # bottom
    ])
    fwd = torch.cat([ahead, -torch.dot(ahead, pos)[None]])
    return tl, tr, bl, planes, fwd


def primary_rays(cam: Camera, xs, ys, width, height):
    """Primary rays for pixel coordinates (camera.h:32-37 semantics).

    xs, ys: float32 tensors of matching shape, on the device the rays are
    wanted on.  Returns (origins, dirs) with a trailing dim of 3.
    """
    dev = xs.device
    tl, tr, bl, pos = (v.to(dev) for v in (cam.tl, cam.tr, cam.bl, cam.pos))
    u = (xs / width)[..., None]
    v = (ys / height)[..., None]
    end = tl + u * (tr - tl) + v * (bl - tl)
    d = m3.normalize(end - pos)
    o = torch.broadcast_to(pos, d.shape)
    return o, d


def rays_for_image(cam: Camera, width: int, height: int, jitter=None,
                   device="cuda"):
    """All primary rays for a width x height image, flattened row-major.

    jitter: optional (H, W, 2) sub-pixel offsets in [0, 1).
    Returns (origins (H*W, 3), dirs (H*W, 3)) on ``device``.
    """
    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=device),
        torch.arange(width, dtype=torch.float32, device=device),
        indexing="ij",
    )
    if jitter is not None:
        jitter = torch.as_tensor(jitter, dtype=torch.float32, device=device)
        xs = xs + jitter[..., 0]
        ys = ys + jitter[..., 1]
    o, d = primary_rays(cam, xs, ys, width, height)
    return o.reshape(-1, 3), d.reshape(-1, 3)


def pyramid_project(planes: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Project world points to the pyramid's [0,1]^2 UV (pyramid.cpp:52-66).

    planes: (4, 4) left/right/top/bottom; points: (..., 3) on any device.
    Each plane distance is summed in a fixed order, so every device rounds
    it the same way."""
    pl = planes.to(points.device, torch.float32)
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    d = [x * pl[k, 0] + y * pl[k, 1] + z * pl[k, 2] + pl[k, 3] for k in range(4)]
    u = d[0] / (d[0] + d[1])
    v = d[2] / (d[2] + d[3])
    return torch.stack([u, v], dim=-1)


def freecam_update(cam: Camera, move, look, dt: float, boost: bool = False):
    """Headless freecam (camera.cpp:18-54 semantics, no GLFW).

    move: (3,) strafe/up/forward in {-1, 0, 1}; look: (2,) yaw/pitch
    deltas.  Returns (new Camera, forward depth delta): the delta feeds the
    temporal reprojection's depth compensation (renderer.cpp:318)."""
    move = torch.as_tensor(move, dtype=torch.float32)
    look = torch.as_tensor(look, dtype=torch.float32)
    speed = 1.5 * dt * (4.0 if boost else 1.0)
    up_w = torch.tensor(UP, dtype=torch.float32)
    ahead = m3.normalize(cam.target - cam.pos)
    right = m3.normalize(m3.cross(up_w, ahead))
    up = m3.normalize(m3.cross(ahead, right))

    target = cam.target + 0.025 * dt * (right * look[0] - up * look[1])
    ahead = m3.normalize(target - cam.pos)
    right = m3.normalize(m3.cross(up_w, ahead))
    up = m3.normalize(m3.cross(ahead, right))

    pos = cam.pos + speed * (right * move[0] + up * move[1] + ahead * move[2])
    depth_delta = speed * move[2]
    return Camera.create(pos, pos + ahead), depth_delta
