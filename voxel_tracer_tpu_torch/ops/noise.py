"""Sampling noise: blue-noise textures + R2 frame decorrelation.

Counterpart of `voxel_tracer_tpu/ops/noise.py` (src/graphics/noise/
{blue,sampler}.{h,cpp}): tiled 128x128 noise textures, decorrelated across
frames with additive R2 irrational sequences (sampler.h:22-36, frame
wrapped at 120, renderer.cpp:161-162).

The reference's CC0 blue-noise PNGs (LDR_RG01.png, LDR_RGB1.png, loaded
with a sqrt pre-transform, blue.cpp:5-17) are read only from the
directory the environment variable VOXEL_TRACER_ASSET_DIR names (its
`noise/` subdirectory or itself) and only when PIL is installed; without
them a seeded texture stands in, equal to the JAX package's array for
array.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

ASSET_DIR = os.environ.get("VOXEL_TRACER_ASSET_DIR")
_BLUE_FILES = {2: "LDR_RG01.png", 3: "LDR_RGB1.png"}

# R2 irrationals (noise/blue.h:3-10)
R2 = 1.22074408460575947536
R2X, R2Y, R2Z = 1.0 / R2, 1.0 / R2 ** 2, 1.0 / R2 ** 3
R2_2D = 1.32471795724474602596
R2X_2D, R2Y_2D = 1.0 / R2_2D, 1.0 / R2_2D ** 2

_TEX_SIZE = 128


def _load_blue_png(channels: int):
    """The blue-noise PNG for the channel count with blue.cpp:12-16's
    transform (sRGB -> linear, then sqrt); None if it or PIL is missing."""
    name = _BLUE_FILES.get(channels)
    if name is None or not ASSET_DIR:
        return None
    for path in (os.path.join(ASSET_DIR, "noise", name),
                 os.path.join(ASSET_DIR, name)):
        if os.path.isfile(path):
            try:
                from PIL import Image
                img = np.asarray(Image.open(path), np.float32) / 255.0
            except Exception:
                return None
            linear = img[..., :channels] ** 2.2   # stbi_loadf gamma
            return np.sqrt(linear).astype(np.float32)
    return None


@functools.lru_cache(maxsize=4)
def _noise_texture(channels: int) -> np.ndarray:
    """(TEX, TEX, C) noise texture in [0, 1): the blue-noise asset when
    present, else the seeded stand-in (jittered values pushed toward blue
    noise by two high-pass passes, noise.py:58-82)."""
    real = _load_blue_png(channels)
    if real is not None:
        return real
    rng = np.random.RandomState(12345 + channels)
    tex = rng.rand(_TEX_SIZE, _TEX_SIZE, channels).astype(np.float32)
    for c in range(channels):
        ch = tex[..., c]
        for _ in range(2):
            blur = (
                np.roll(ch, 1, 0) + np.roll(ch, -1, 0)
                + np.roll(ch, 1, 1) + np.roll(ch, -1, 1)
            ) * 0.25
            ch = np.clip(ch + 0.5 * (ch - blur), 0.0, 1.0)
        tex[..., c] = ch
    return tex


@functools.lru_cache(maxsize=8)
def _texture_on(channels: int, device: str) -> torch.Tensor:
    return torch.tensor(_noise_texture(channels), device=device)


def sample_texture(xs, ys, channels: int):
    """Tiled texture fetch (BlueNoise::sample_* analog, blue.h:28-40);
    xs, ys: integer tensors on the device the samples are wanted on."""
    tex = _texture_on(channels, str(xs.device))
    th, tw = tex.shape[:2]
    return tex[torch.remainder(ys, th).long(), torch.remainder(xs, tw).long()]


def _r2(base, frame, offset, r2):
    f = torch.as_tensor(frame).to(base.device, torch.float32) + offset
    r2 = torch.tensor(r2, dtype=torch.float32, device=base.device)
    return torch.remainder(base + r2 * f, 1.0)


def sample_3d(xs, ys, frame, offset=0.0):
    """NoiseSampler::sample_3d (sampler.h:22-29): tex + R2 * frame, mod 1."""
    return _r2(sample_texture(xs, ys, 3), frame, offset, [R2X, R2Y, R2Z])


def sample_2d(xs, ys, frame, offset=0.0):
    """NoiseSampler::sample_2d (sampler.h:31-36)."""
    return _r2(sample_texture(xs, ys, 2), frame, offset, [R2X_2D, R2Y_2D])


def sampler_3d(n_rays: int, frame, width: int = 0, device="cuda"):
    """Per-ray 3D noise for a flat wavefront (ray index -> pixel coords)."""
    idx = torch.arange(n_rays, dtype=torch.int32, device=device)
    w = width if width else _TEX_SIZE
    return sample_3d(idx % w, idx // w, frame)


def sampler_2d(n_rays: int, frame, width: int = 0, device="cuda"):
    idx = torch.arange(n_rays, dtype=torch.int32, device=device)
    w = width if width else _TEX_SIZE
    return sample_2d(idx % w, idx // w, frame)
