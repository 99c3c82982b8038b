"""Tonemapping (src/graphics/tonemap.h analog) on tensors.

Counterpart of `voxel_tracer_tpu/ops/tonemap.py`.
"""

from __future__ import annotations

import torch


def clamp_color(color: torch.Tensor, max_mag: float) -> torch.Tensor:
    """Clamp a color to a maximum magnitude (tonemap.h:6-13)."""
    sqr = torch.sum(color * color, dim=-1, keepdim=True)
    scale = torch.where(sqr > max_mag * max_mag,
                        max_mag / torch.sqrt(torch.clamp(sqr, min=1e-30)), 1.0)
    return color * scale


def reinhard(v: torch.Tensor) -> torch.Tensor:
    return v / (1.0 + v)


def reinhard_extended(v: torch.Tensor, max_white: float) -> torch.Tensor:
    return v * (1.0 + v / (max_white * max_white)) / (1.0 + v)


def aces_approx(v: torch.Tensor) -> torch.Tensor:
    """ACES filmic approximation (tonemap.h:22-30) — the default output
    transform (renderer.cpp:184,211)."""
    v = v * 0.6
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((v * (a * v + b)) / (v * (c * v + d) + e), 0.0, 1.0)


def uncharted2(v: torch.Tensor) -> torch.Tensor:
    def curve(x):
        a, b, c, d, e, f = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30
        return (x * (a * x + c * b) + d * e) / (x * (a * x + b) + d * f) - e / f

    v = curve(v * 2.0) / curve(torch.tensor(11.2, dtype=v.dtype, device=v.device))
    return torch.pow(torch.clamp(v, min=0.0), 1.0 / 2.4)


def to_rgb8(v: torch.Tensor) -> torch.Tensor:
    """float [0,1] -> uint8 (RGBF32_to_RGB8 analog, precomp.h:342-359)."""
    return torch.clamp(v * 255.0 + 0.5, 0, 255).to(torch.uint8)
