"""Vectors, the pinhole camera, the sky and the tonemap, in plain PyTorch.

Frozen from the JAX package's semantics (src/graphics/camera.cpp:3-16,
skydome.h:34-41, tonemap.h:6-30) as the port computed them when the
benchmark was written, operation for operation, so that a sound program
agrees with it to the last bit where it runs the same float program.
Matrix-vector products are written out elementwise in a fixed order.
"""

from __future__ import annotations

import numpy as np
import torch

BIG = 1e30
UP = (0.0, 1.0, 0.0)
INV2PI = 1.0 / (2.0 * np.pi)
INVPI = 1.0 / np.pi


def dot(a, b):
    return torch.sum(a * b, dim=-1)


def normalize(v):
    return v / torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def reflect(d, n):
    return d - 2.0 * dot(d, n)[..., None] * n


def sign_dir(d):
    """+1 where the sign bit is clear (+0 included), -1 elsewhere."""
    return torch.where(torch.signbit(d), -1.0, 1.0).to(d.dtype)


def mat3_t_apply(rot, v):
    """R^T @ v over the trailing axis."""
    return torch.stack([
        rot[..., 0, 0] * v[..., 0] + rot[..., 1, 0] * v[..., 1] + rot[..., 2, 0] * v[..., 2],
        rot[..., 0, 1] * v[..., 0] + rot[..., 1, 1] * v[..., 1] + rot[..., 2, 1] * v[..., 2],
        rot[..., 0, 2] * v[..., 0] + rot[..., 1, 2] * v[..., 1] + rot[..., 2, 2] * v[..., 2],
    ], dim=-1)


def to_local(rot, pos, pivot, origins, dirs):
    """World -> volume-local rays: R^T (p - pos) + pivot, R^T d."""
    return mat3_t_apply(rot, origins - pos) + pivot, mat3_t_apply(rot, dirs)


def camera_corners(pos, target, aspect):
    """(pos, tl, tr, bl) float32 CPU tensors of a camera at ``pos``
    looking at ``target``: focal distance 2, half extent (aspect, 1)."""
    pos = torch.as_tensor(pos, dtype=torch.float32)
    target = torch.as_tensor(target, dtype=torch.float32)
    ahead = normalize(target - pos)
    right = normalize(cross(torch.tensor(UP, dtype=torch.float32), ahead))
    up = normalize(cross(ahead, right))
    tl = pos + 2.0 * ahead - aspect * right + up
    tr = pos + 2.0 * ahead + aspect * right + up
    bl = pos + 2.0 * ahead - aspect * right - up
    return pos, tl, tr, bl


def rays_for_image(corners, width, height, device, rows=None):
    """Primary rays of a width x height image, row-major, ((N, 3), (N, 3));
    ``rows`` = (first, stop) keeps a block of image rows."""
    pos, tl, tr, bl = (v.to(device) for v in corners)
    r0, r1 = rows or (0, height)
    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=device)[r0:r1],
        torch.arange(width, dtype=torch.float32, device=device), indexing="ij")
    u = (xs / width)[..., None]
    v = (ys / height)[..., None]
    end = tl + u * (tr - tl) + v * (bl - tl)
    d = normalize(end - pos)
    o = torch.broadcast_to(pos, d.shape)
    return o.reshape(-1, 3), d.reshape(-1, 3)


def sample_sky(pixels, dirs):
    """Bilinear equirectangular lookup: longitude wraps, latitude clamps."""
    h, w, _ = pixels.shape
    if h == 1 and w == 1:
        return torch.broadcast_to(pixels[0, 0], dirs.shape[:-1] + (3,))
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    u = (torch.atan2(z, x) * INV2PI) * w - 0.5
    v = (torch.arccos(torch.clamp(y, -1.0, 1.0)) * INVPI) * h - 0.5
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    fu = (u - u0)[..., None]
    fv = (v - v0)[..., None]
    flat = pixels.reshape(-1, 3)

    def fetch(ui, vi):
        ui = torch.remainder(ui.to(torch.int64), w)
        vi = torch.clamp(vi.to(torch.int64), 0, h - 1)
        return flat[vi * w + ui]

    c00, c10 = fetch(u0, v0), fetch(u0 + 1, v0)
    c01, c11 = fetch(u0, v0 + 1), fetch(u0 + 1, v0 + 1)
    return (c00 * (1 - fu) + c10 * fu) * (1 - fv) + (c01 * (1 - fu) + c11 * fu) * fv


def clamp_color(color, max_mag):
    sqr = torch.sum(color * color, dim=-1, keepdim=True)
    scale = torch.where(sqr > max_mag * max_mag,
                        max_mag / torch.sqrt(torch.clamp(sqr, min=1e-30)), 1.0)
    return color * scale


def aces(v):
    v = v * 0.6
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((v * (a * v + b)) / (v * (c * v + d) + e), 0.0, 1.0)


TONEMAPS = {"aces": aces}


def procedural_sky(width, height, sun_dir=(-0.619501, 0.465931, -0.631765)):
    """(height, width, 3) float32 numpy: the dawn gradient and sun disk
    that stand in for the reference's kiara_1_dawn_4k.hdr, with its
    sqrt * 0.65 pre-tonemap (skydome.cpp:9-11)."""
    v, u = np.meshgrid((np.arange(height) + 0.5) / height,
                       (np.arange(width) + 0.5) / width, indexing="ij")
    theta = v * np.pi
    phi = u * 2.0 * np.pi - np.pi
    y = np.cos(theta)
    d = np.stack([np.sin(theta) * np.cos(phi), y, np.sin(theta) * np.sin(phi)], axis=-1)
    sun = np.asarray(sun_dir, np.float32)
    sun = sun / np.linalg.norm(sun)
    cos_sun = d @ sun
    horizon = np.exp(-np.abs(y) * 3.0)
    zenith = np.clip(y, 0, 1)
    sky = (np.array([0.35, 0.45, 0.65])[None, None] * zenith[..., None]
           + np.array([0.85, 0.65, 0.45])[None, None] * horizon[..., None]
           + np.array([0.08, 0.08, 0.10])[None, None])
    disk = np.clip((cos_sun - 0.9995) / 0.0005, 0, 1) ** 2
    glow = np.clip(cos_sun, 0, 1) ** 32
    sky = sky + (25.0 * disk + 0.6 * glow)[..., None] * np.array([1.0, 0.9, 0.75])
    return (np.sqrt(np.maximum(sky, 0.0)) * 0.65).astype(np.float32)
