"""Tonemapping (src/graphics/tonemap.h analog) on tensors.

Counterpart of the ACES and RGB8 functions of
`voxel_tracer_tpu/ops/tonemap.py`.
"""

from __future__ import annotations

import torch


def aces_approx(v: torch.Tensor) -> torch.Tensor:
    """ACES filmic approximation (tonemap.h:22-30) — the default output
    transform (renderer.cpp:184,211)."""
    v = v * 0.6
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((v * (a * v + b)) / (v * (c * v + d) + e), 0.0, 1.0)


def to_rgb8(v: torch.Tensor) -> torch.Tensor:
    """float [0,1] -> uint8 (RGBF32_to_RGB8 analog, precomp.h:342-359)."""
    return torch.clamp(v * 255.0 + 0.5, 0, 255).to(torch.uint8)
