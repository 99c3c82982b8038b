"""World-space debug-draw overlay (src/dev/debug.{h,cpp} analog).

Counterpart of `voxel_tracer_tpu/utils/debug_draw.py`, on this package's
`Camera` and `Surface`.

The reference draws world-space lines / normals / AABBs / OBBs onto a
second `Surface` by projecting endpoints through the camera's view pyramid
(debug.cpp:13-112) and composites the overlay over the frame each tick
(template/template.cpp:329-333).  Here the overlay is a host-side
`Surface` (numpy) — debug drawing is an observability tool, not a compute
path, so it stays off-device; the projection math reuses the camera
pyramid (`models/camera.py: pyramid_project`).
"""

from __future__ import annotations

import numpy as np

import torch

from voxel_tracer_tpu_torch.models.camera import Camera, pyramid_project
from voxel_tracer_tpu_torch.utils.framebuffer import Surface

RED = (255, 60, 60)
GREEN = (60, 255, 60)
BLUE = (80, 140, 255)
YELLOW = (255, 230, 60)


class DebugOverlay:
    """Accumulates world-space debug primitives and rasterizes an overlay.

    Usage mirrors db:: (debug.h:12-28): call draw_* during a frame, then
    `composite(frame)` to blend the overlay over the rendered image and
    `clear()` for the next frame.
    """

    def __init__(self, width: int, height: int):
        self.surface = Surface(width, height)

    def clear(self):
        self.surface.clear()

    # -- projection -------------------------------------------------------

    def _project(self, cam: Camera, points: np.ndarray):
        """World points -> pixel coords; returns (xy (N,2) f32, ok (N,) bool).

        Points behind the camera's forward plane are rejected
        (debug.cpp draws only what the pyramid sees).
        """
        pts = np.asarray(points, np.float32).reshape(-1, 3)
        fwd = cam.forward.numpy()
        depth = pts @ fwd[:3] + fwd[3]
        uv = pyramid_project(cam.planes, torch.from_numpy(pts)).numpy()
        ok = (depth > 1e-4) & np.isfinite(uv).all(axis=-1)
        xy = np.stack([uv[:, 0] * self.surface.width,
                       uv[:, 1] * self.surface.height], axis=-1)
        return xy, ok

    # -- primitives (db::draw_line/normal/aabb/obb, debug.h:12-28) ---------

    def draw_line(self, cam: Camera, a, b, color=YELLOW):
        xy, ok = self._project(cam, np.stack([np.asarray(a), np.asarray(b)]))
        if ok.all():
            (x0, y0), (x1, y1) = xy
            self.surface.line(x0, y0, x1, y1, color)

    def draw_normal(self, cam: Camera, p, n, scale: float = 0.1,
                    color=GREEN):
        p = np.asarray(p, np.float32)
        n = np.asarray(n, np.float32)
        self.draw_line(cam, p, p + n * scale, color)

    def draw_aabb(self, cam: Camera, bmin, bmax, color=BLUE):
        bmin = np.asarray(bmin, np.float32)
        bmax = np.asarray(bmax, np.float32)
        corners = np.array([
            [(bmin, bmax)[(i >> a) & 1][a] for a in range(3)]
            for i in range(8)
        ], np.float32)
        self._draw_box_edges(cam, corners, color)

    def draw_obb(self, cam: Camera, rot, pos, pivot, size, color=RED):
        """OBB from rot (3,3 local->world), pos, pivot, local size (3,)."""
        rot = np.asarray(rot, np.float32)
        pos = np.asarray(pos, np.float32)
        pivot = np.asarray(pivot, np.float32)
        size = np.asarray(size, np.float32)
        local = np.array([
            [size[a] if (i >> a) & 1 else 0.0 for a in range(3)]
            for i in range(8)
        ], np.float32)
        corners = (local - pivot) @ rot.T + pos
        self._draw_box_edges(cam, corners, color)

    _EDGES = [(0, 1), (0, 2), (1, 3), (2, 3),
              (4, 5), (4, 6), (5, 7), (6, 7),
              (0, 4), (1, 5), (2, 6), (3, 7)]

    def _draw_box_edges(self, cam: Camera, corners: np.ndarray, color):
        xy, ok = self._project(cam, corners)
        for i, j in self._EDGES:
            if ok[i] and ok[j]:
                self.surface.line(xy[i, 0], xy[i, 1], xy[j, 0], xy[j, 1],
                                  color)

    # -- compositing (template.cpp:329-333 analog) --------------------------

    def composite(self, frame: np.ndarray) -> np.ndarray:
        """Overlay non-black overlay pixels onto an (H, W, 3) u8 frame."""
        out = np.asarray(frame).copy()
        m = self.surface.pixels.any(axis=-1)
        out[m] = self.surface.pixels[m]
        return out
