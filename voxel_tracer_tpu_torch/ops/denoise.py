"""Denoise filters: two-pass box blur, separable Gaussian and FXAA.

Counterpart of `voxel_tracer_tpu/ops/denoise.py`: the reference's
optional `DENOISE` post pass (renderer.h:16, renderer.cpp:226-238) and its
kernel helpers (src/graphics/noise/gaussian.h:88-112), over (H, W, C)
float tensors on any device.  The JAX filters are
`jax.lax.conv_general_dilated` (no Pallas kernel); here they are
depthwise `torch.nn.functional.conv2d` with edge-replicated padding.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _as_image(img) -> torch.Tensor:
    return torch.as_tensor(img, dtype=torch.float32)


def _sep_filter(img, kernel_1d):
    """Apply a 1D filter along H then W (separable 2D convolution).

    img: (H, W, C) float32.  Edges use edge replication, matching the
    clamped window of the reference's box blur."""
    k = torch.as_tensor(kernel_1d, dtype=torch.float32, device=img.device)
    r = k.shape[0] // 2
    x = img.permute(2, 0, 1)[:, None]                    # (C, 1, H, W)
    x = F.pad(x, (r, r, r, r), mode="replicate")
    x = F.conv2d(x, k.reshape(1, 1, -1, 1))
    x = F.conv2d(x, k.reshape(1, 1, 1, -1))
    return x[:, 0].permute(1, 2, 0)


def box_blur(img, radius: int = 1, passes: int = 2):
    """Two-pass box blur (renderer.cpp:226-238 semantics).

    Each pass is a (2r+1)^2 normalized box; two passes approximate a
    triangle filter (and three a Gaussian, by central limit)."""
    img = _as_image(img)
    n = 2 * radius + 1
    k = torch.full((n,), 1.0 / n, dtype=torch.float32)
    for _ in range(passes):
        img = _sep_filter(img, k)
    return img


def gaussian_kernel_1d(sigma: float, radius: int | None = None) -> np.ndarray:
    """Normalized 1D Gaussian taps (gaussian.h:88-112 analog)."""
    if radius is None:
        radius = max(1, int(np.ceil(3.0 * sigma)))
    xs = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (xs / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img, sigma: float = 1.0, radius: int | None = None):
    """Separable Gaussian blur over a (H, W, C) image."""
    return _sep_filter(_as_image(img), gaussian_kernel_1d(sigma, radius))


def _shift(x, dy, dx):
    """Edge-replicated neighbour fetch: x[y + dy, x + dx], clamped."""
    y = torch.roll(x, shifts=(-dy, -dx), dims=(0, 1))
    if dy == 1:
        y[-1] = x[-1]
    if dy == -1:
        y[0] = x[0]
    if dx == 1:
        y[:, -1] = x[:, -1]
    if dx == -1:
        y[:, 0] = x[:, 0]
    return y


def fxaa(img, edge_threshold: float = 1.0 / 8.0,
         edge_threshold_min: float = 1.0 / 24.0, subpix_cap: float = 0.75):
    """FXAA-style edge anti-aliasing over a (H, W, 3) LDR image.

    The reference's embedded FXAA 3.11 display shader
    (template/template.cpp:199-320: FXAA_EDGE_THRESHOLD = 1/8,
    FXAA_EDGE_THRESHOLD_MIN = 1/24) as the console-lite variant: luma
    edge detection on the 3x3 cross, sub-pixel blend toward the cross
    lowpass clamped by the local contrast.  Apply after tonemapping."""
    img = _as_image(img)
    luma_w = torch.tensor([0.299, 0.587, 0.114], dtype=torch.float32,
                          device=img.device)
    luma = img @ luma_w
    n, s = _shift(luma, -1, 0), _shift(luma, 1, 0)
    e, w = _shift(luma, 0, 1), _shift(luma, 0, -1)
    l_min = torch.minimum(luma, torch.minimum(torch.minimum(n, s), torch.minimum(e, w)))
    l_max = torch.maximum(luma, torch.maximum(torch.maximum(n, s), torch.maximum(e, w)))
    rng = l_max - l_min
    edge = rng >= torch.clamp(l_max * edge_threshold, min=edge_threshold_min)

    # sub-pixel blend amount from the cross average's deviation
    l_avg = (n + s + e + w) * 0.25
    sub = torch.clamp(torch.abs(l_avg - luma) / torch.clamp(rng, min=1e-6), 0.0, 1.0)
    blend = torch.where(edge, torch.clamp(sub * sub * subpix_cap, max=subpix_cap), 0.0)

    lowpass = (_shift(img, -1, 0) + _shift(img, 1, 0) + _shift(img, 0, 1)
               + _shift(img, 0, -1)) * 0.25
    return img + blend[..., None] * (lowpass - img)
