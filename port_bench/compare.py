"""The numbers `correct` compares, program against reference.

Frames are compared pixel by pixel: each number is the share of pixels
that differ by more than a fixed tolerance, so a frame that is right but
for float32 rounding reads 0 while a wrong stage, a lower precision or an
altered answer moves many pixels.  Traversal shows in the primary hit's
depth and material, shading in the albedo and irradiance (every bounce,
shadow ray and glass split), their product in the color, the tonemap in
the image.  A cell checks several frames and keeps each number's worst.
"""

from __future__ import annotations

import torch

VALUE_TOL = 1e-4        # albedo, color, irradiance, depth: |d| over max(1, |ref|)
IMAGE_LSB = 0.1         # tonemapped image, in 8-bit steps


def _rows(x, width):
    """(N, width) float64 of a tensor or array of N pixels."""
    return torch.as_tensor(x).to(torch.float64).reshape(-1, width)


def frame_numbers(prog, ref):
    """Shares of pixels that differ, program against reference: ``prog``
    and ``ref`` dicts with the image, albedo, color and irradiance (3
    channels each), the primary hit's depth (t, 1e30 on a miss) and its
    material id."""
    dev = ref["color"].device
    out = {}
    for k, w in (("albedo", 3), ("color", 3), ("irradiance", 3), ("depth", 1)):
        p, r = _rows(prog[k], w).to(dev), _rows(ref[k], w)
        bad = ((p - r).abs() > VALUE_TOL * r.abs().clamp(min=1.0)).any(dim=-1)
        out[f"{k}_share"] = float(bad.double().mean())
    p, r = _rows(prog["material"], 1).to(dev), _rows(ref["material"], 1)
    out["material_share"] = float((p != r).any(dim=-1).double().mean())
    p, r = _rows(prog["image"], 3).to(dev), _rows(ref["image"], 3)
    out["image_share"] = float((((p - r).abs() * 255.0) > IMAGE_LSB).any(dim=-1).double().mean())
    return out


def worst(numbers):
    """Each number's largest value over a list of {number: value} dicts."""
    return {k: max(n[k] for n in numbers) for k in numbers[0]}
