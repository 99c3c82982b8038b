"""Small 3D math on batched tensors with a trailing axis of size 3.

Counterpart of `voxel_tracer_tpu/ops/math3d.py` (the reference template
math layer, `template/tmpl8math.h`), restricted to what the ported frames
need.  `noise3d` is host-side numpy and is copied verbatim so the
procedural grids match the JAX package bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

BIG_F32 = 1e30  # reference: template/types.h:19


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched 3D dot product over the trailing axis."""
    return torch.sum(a * b, dim=-1)


def normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def reflect(d: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Mirror reflection of direction ``d`` about unit normal ``n``."""
    return d - 2.0 * dot(d, n)[..., None] * n


def sign_dir(d: torch.Tensor) -> torch.Tensor:
    """Per-axis ray-direction sign (+1 / -1), positive for +0.

    The sign bit alone decides (src/graphics/rays/ray.h:80-97): d >= +0 ->
    +1, d < 0 including -0 -> -1.
    """
    return torch.where(torch.signbit(d), -1.0, 1.0).to(d.dtype)


# ---------------------------------------------------------------------------
# Perlin-style value noise — analog of template/tmpl8math.cpp:60-112 noise3D,
# used by the procedurally filled volume constructor (vv.cpp:88-117).
# ---------------------------------------------------------------------------

_PERLIN_PERM = np.random.RandomState(1234).permutation(256)
_PERLIN_PERM = np.concatenate([_PERLIN_PERM, _PERLIN_PERM]).astype(np.int32)

_GRAD3 = np.array(
    [
        [1, 1, 0], [-1, 1, 0], [1, -1, 0], [-1, -1, 0],
        [1, 0, 1], [-1, 0, 1], [1, 0, -1], [-1, 0, -1],
        [0, 1, 1], [0, -1, 1], [0, 1, -1], [0, -1, -1],
    ],
    dtype=np.float32,
)


def noise3d(x, y, z):
    """Deterministic gradient noise in [-1, 1]; numpy, host-side scene setup."""
    x, y, z = np.asarray(x, np.float32), np.asarray(y, np.float32), np.asarray(z, np.float32)
    xi, yi, zi = np.floor(x).astype(np.int32) & 255, np.floor(y).astype(np.int32) & 255, np.floor(z).astype(np.int32) & 255
    xf, yf, zf = x - np.floor(x), y - np.floor(y), z - np.floor(z)

    def fade(t):
        return t * t * t * (t * (t * 6 - 15) + 10)

    u, v, w = fade(xf), fade(yf), fade(zf)
    perm = _PERLIN_PERM

    def grad_at(ix, iy, iz, fx, fy, fz):
        h = perm[perm[perm[ix] + iy] + iz] % 12
        g = _GRAD3[h]
        return g[..., 0] * fx + g[..., 1] * fy + g[..., 2] * fz

    n000 = grad_at(xi, yi, zi, xf, yf, zf)
    n100 = grad_at(xi + 1, yi, zi, xf - 1, yf, zf)
    n010 = grad_at(xi, yi + 1, zi, xf, yf - 1, zf)
    n110 = grad_at(xi + 1, yi + 1, zi, xf - 1, yf - 1, zf)
    n001 = grad_at(xi, yi, zi + 1, xf, yf, zf - 1)
    n101 = grad_at(xi + 1, yi, zi + 1, xf - 1, yf, zf - 1)
    n011 = grad_at(xi, yi + 1, zi + 1, xf, yf - 1, zf - 1)
    n111 = grad_at(xi + 1, yi + 1, zi + 1, xf - 1, yf - 1, zf - 1)

    def lerp(a, b, t):
        return a + t * (b - a)

    nx00 = lerp(n000, n100, u)
    nx10 = lerp(n010, n110, u)
    nx01 = lerp(n001, n101, u)
    nx11 = lerp(n011, n111, u)
    nxy0 = lerp(nx00, nx10, v)
    nxy1 = lerp(nx01, nx11, v)
    return lerp(nxy0, nxy1, w)
