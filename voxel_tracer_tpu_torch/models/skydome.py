"""HDR equirectangular skydome (src/graphics/skydome.{h,cpp} analog).

Counterpart of `voxel_tracer_tpu/models/skydome.py`.  The sky is an
(H, W, 3) float32 image: a Radiance .hdr (minimal loader below) or the
procedural sky, built in numpy so its pixels equal the JAX package's.
`SkyDome.data(device)` puts it on a device and `sample_sky` looks
directions up there (bilinear, longitude wrap, latitude clamp).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

INV2PI = 1.0 / (2.0 * np.pi)
INVPI = 1.0 / np.pi


class SkyDomeData(NamedTuple):
    pixels: torch.Tensor  # (H, W, 3) float32; (1, 1, 3) for constant skies


class SkyDome:
    def __init__(self, pixels: np.ndarray):
        self.pixels = np.ascontiguousarray(pixels, np.float32)

    @staticmethod
    def black() -> "SkyDome":
        return SkyDome(np.zeros((1, 1, 3), np.float32))

    @staticmethod
    def constant(color) -> "SkyDome":
        return SkyDome(np.asarray(color, np.float32).reshape(1, 1, 3))

    @staticmethod
    def procedural(width: int = 512, height: int = 256,
                   sun_dir=(-0.619501, 0.465931, -0.631765)) -> "SkyDome":
        """Analytic dawn-ish gradient sky + sun disk (stands in for the
        reference's gitignored kiara_1_dawn_4k.hdr asset)."""
        v, u = np.meshgrid(
            (np.arange(height) + 0.5) / height,
            (np.arange(width) + 0.5) / width,
            indexing="ij",
        )
        theta = v * np.pi          # 0 = up
        phi = u * 2.0 * np.pi - np.pi
        y = np.cos(theta)
        x = np.sin(theta) * np.cos(phi)
        z = np.sin(theta) * np.sin(phi)
        d = np.stack([x, y, z], axis=-1)

        sun = np.asarray(sun_dir, np.float32)
        sun = sun / np.linalg.norm(sun)
        cos_sun = d @ sun

        horizon = np.exp(-np.abs(y) * 3.0)
        zenith = np.clip(y, 0, 1)
        sky = (
            np.array([0.35, 0.45, 0.65])[None, None] * zenith[..., None]
            + np.array([0.85, 0.65, 0.45])[None, None] * horizon[..., None]
            + np.array([0.08, 0.08, 0.10])[None, None]
        )
        disk = np.clip((cos_sun - 0.9995) / 0.0005, 0, 1) ** 2
        glow = np.clip(cos_sun, 0, 1) ** 32
        sky = sky + (25.0 * disk + 0.6 * glow)[..., None] * np.array([1.0, 0.9, 0.75])
        # Reference pre-tonemap: sqrt(sample) * 0.65 (skydome.cpp:9-11)
        sky = np.sqrt(np.maximum(sky, 0.0)) * 0.65
        return SkyDome(sky.astype(np.float32))

    @staticmethod
    def from_hdr(path: str) -> "SkyDome":
        """Load a Radiance RGBE .hdr file, applying the reference's
        sqrt * 0.65 pre-tonemap (skydome.cpp:9-11)."""
        pixels = _read_radiance_hdr(path)
        return SkyDome(np.sqrt(np.maximum(pixels, 0.0)) * 0.65)

    def data(self, device="cuda") -> SkyDomeData:
        return SkyDomeData(pixels=torch.tensor(self.pixels, device=device))


def sample_sky(sky: SkyDomeData, dirs: torch.Tensor) -> torch.Tensor:
    """Batched dir -> color lookup (skydome.h:34-41: atan2/acos spherical
    mapping), bilinear with longitude wrap and latitude clamp; a 1x1 sky
    is a constant."""
    px = sky.pixels
    h, w, _ = px.shape
    if h == 1 and w == 1:
        return torch.broadcast_to(px[0, 0], dirs.shape[:-1] + (3,))
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    u = (torch.atan2(z, x) * INV2PI) * w - 0.5
    v = (torch.arccos(torch.clamp(y, -1.0, 1.0)) * INVPI) * h - 0.5
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    fu = (u - u0)[..., None]
    fv = (v - v0)[..., None]
    flat_px = px.reshape(-1, 3)

    def fetch(ui, vi):
        ui = torch.remainder(ui.to(torch.int64), w)       # longitude wraps
        vi = torch.clamp(vi.to(torch.int64), 0, h - 1)    # latitude clamps
        return flat_px[vi * w + ui]

    c00 = fetch(u0, v0)
    c10 = fetch(u0 + 1, v0)
    c01 = fetch(u0, v0 + 1)
    c11 = fetch(u0 + 1, v0 + 1)
    return (c00 * (1 - fu) + c10 * fu) * (1 - fv) \
        + (c01 * (1 - fu) + c11 * fu) * fv


def _read_radiance_hdr(path: str) -> np.ndarray:
    """Minimal Radiance RGBE (.hdr) reader -> (H, W, 3) float32."""
    with open(path, "rb") as f:
        magic = f.readline()
        if not magic.startswith(b"#?"):
            raise ValueError("not a Radiance .hdr file")
        while True:
            line = f.readline()
            if line in (b"\n", b""):
                break
        dims = f.readline().split()
        if dims[0] != b"-Y" or dims[2] != b"+X":
            raise ValueError(f"unsupported .hdr orientation: {dims}")
        height, width = int(dims[1]), int(dims[3])
        data = f.read()

    img = np.zeros((height, width, 4), np.uint8)
    pos = 0
    for row in range(height):
        if data[pos:pos + 2] == b"\x02\x02":  # adaptive RLE scanline
            pos += 4
            for c in range(4):
                col = 0
                while col < width:
                    n = data[pos]
                    pos += 1
                    if n > 128:  # run
                        img[row, col:col + n - 128, c] = data[pos]
                        pos += 1
                        col += n - 128
                    else:        # literal
                        img[row, col:col + n, c] = np.frombuffer(
                            data, np.uint8, n, pos)
                        pos += n
                        col += n
        else:  # flat scanline
            flat = np.frombuffer(data, np.uint8, width * 4, pos).reshape(width, 4)
            img[row] = flat
            pos += width * 4

    rgbe = img.astype(np.float32)
    exp = np.ldexp(1.0, img[..., 3].astype(np.int32) - 136)
    rgb = rgbe[..., :3] * exp[..., None]
    rgb[img[..., 3] == 0] = 0.0
    return rgb.astype(np.float32)
