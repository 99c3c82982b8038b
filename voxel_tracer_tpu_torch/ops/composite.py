"""World <-> volume-local ray transforms.

Counterpart of `_mat3_t_apply` and `_to_local` in
`voxel_tracer_tpu/ops/composite.py` (OBB::world_to_local,
obb.cpp:128-134).  The multi-object composition comes with a later slice.
"""

from __future__ import annotations

import torch


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
