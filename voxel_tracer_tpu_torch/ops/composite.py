"""Hit records and world <-> volume-local ray transforms.

Counterpart of `HitResult`, `_mat3_t_apply` and `_to_local` in
`voxel_tracer_tpu/ops/composite.py` (HitInfo, hit.h:4-13;
OBB::world_to_local, obb.cpp:128-134).  The top-K multi-object
composition comes with a later slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from voxel_tracer_tpu_torch.ops.math3d import BIG_F32


class HitResult(NamedTuple):
    """Wavefront hit record (HitInfo analog, src/graphics/rays/hit.h:4-13)."""

    t: torch.Tensor        # (N,) float32; BIG_F32 = miss
    mat: torch.Tensor      # (N,) int32 material id (0 = none)
    normal: torch.Tensor   # (N, 3) float32 world-space normal
    albedo: torch.Tensor   # (N, 3) float32 palette albedo
    steps: torch.Tensor    # (N,) int32 traversal cost
    obj: torch.Tensor      # (N,) int32 object index (-1 miss)

    @staticmethod
    def miss(n, device="cuda"):
        return HitResult(
            t=torch.full((n,), BIG_F32, dtype=torch.float32, device=device),
            mat=torch.zeros((n,), dtype=torch.int32, device=device),
            normal=torch.zeros((n, 3), dtype=torch.float32, device=device),
            albedo=torch.zeros((n, 3), dtype=torch.float32, device=device),
            steps=torch.zeros((n,), dtype=torch.int32, device=device),
            obj=torch.full((n,), -1, dtype=torch.int32, device=device),
        )

    def nearer(self, other: "HitResult") -> "HitResult":
        """Per ray, the nearer of two records (``other`` on a strict
        win); steps add."""
        take = other.t < self.t
        return HitResult(
            t=torch.where(take, other.t, self.t),
            mat=torch.where(take, other.mat, self.mat),
            normal=torch.where(take[:, None], other.normal, self.normal),
            albedo=torch.where(take[:, None], other.albedo, self.albedo),
            steps=self.steps + other.steps,
            obj=torch.where(take, other.obj, self.obj),
        )


def _mat3_t_apply(rot: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """R^T @ v, written out elementwise in a fixed order so every device
    rounds it the same way."""
    return torch.stack([
        rot[..., 0, 0] * v[..., 0] + rot[..., 1, 0] * v[..., 1] + rot[..., 2, 0] * v[..., 2],
        rot[..., 0, 1] * v[..., 0] + rot[..., 1, 1] * v[..., 1] + rot[..., 2, 1] * v[..., 2],
        rot[..., 0, 2] * v[..., 0] + rot[..., 1, 2] * v[..., 1] + rot[..., 2, 2] * v[..., 2],
    ], dim=-1)


def _to_local(rot, pos, pivot, origins, dirs):
    """World -> volume-local rays (OBB::world_to_local, obb.cpp:128-134)."""
    o_l = _mat3_t_apply(rot, origins - pos) + pivot
    d_l = _mat3_t_apply(rot, dirs)
    return o_l, d_l
