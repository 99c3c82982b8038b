"""MagicaVoxel `.vox` parser (numpy).

Counterpart of `voxel_tracer_tpu/models/vox.py`: the RIFF-style chunks
MAIN / PACK / SIZE / XYZI / RGBA, multiple models and the 256-entry
palette that the reference reads through `ogt_vox` (vv.cpp:12-54).  Grid
axis remap as vv.cpp:30,39-49: our (X, Y, Z) = (vox_size_y, vox_size_z,
vox_size_x) with the vox Y axis flipped, so models stand upright with Y up.
`parse_vox` uses the repository's C parser (`native/voxparse.c`, built as
`native/_voxnative*.so` by `native/build.sh`) when it imports, as the JAX
package does, else the numpy chunk walker below, which is its reference.

Format spec: https://github.com/ephtracy/voxel-model/blob/master/MagicaVoxel-file-format-vox.txt
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field
from typing import List

import numpy as np


def _default_palette() -> np.ndarray:
    """The canonical MagicaVoxel default palette (256 x RGBA uint8).

    A 6x6x6 color cube followed by R/G/B/gray ramps; index 0 is
    transparent black.
    """
    pal = np.zeros((256, 4), np.uint8)
    levels = [255, 204, 153, 102, 51, 0]
    i = 1
    for r in levels:
        for g in levels:
            for b in levels:
                if i >= 256:
                    break
                if (r, g, b) == (0, 0, 0):
                    continue
                pal[i] = (r, g, b, 255)
                i += 1
    ramp = [238, 221, 187, 170, 136, 119, 85, 68, 34, 17]
    for v in ramp:
        pal[i] = (v, 0, 0, 255); i += 1
    for v in ramp:
        pal[i] = (0, v, 0, 255); i += 1
    for v in ramp:
        pal[i] = (0, 0, v, 255); i += 1
    for v in ramp:
        pal[i] = (v, v, v, 255); i += 1
    return pal


@dataclass
class VoxModel:
    """One model from a .vox file, already remapped to our (Z, Y, X) grid."""

    grid: np.ndarray                 # (Z, Y, X) uint8 material ids
    palette: np.ndarray              # (256, 4) uint8 RGBA
    size: tuple = field(default=None)  # our (nx, ny, nz)

    def __post_init__(self):
        gz, gy, gx = self.grid.shape
        self.size = (gx, gy, gz)

    @property
    def palette_f32(self) -> np.ndarray:
        """(256, 3) float albedo in [0, 1] (RGB8_to_RGBF32 analog)."""
        return self.palette[:, :3].astype(np.float32) / 255.0


def _native_module():
    """The C parser (native/voxparse.c) if it is built, else None."""
    import importlib
    import sys

    if "_voxnative" in sys.modules:
        return sys.modules["_voxnative"]
    native_dir = os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), "native")
    if native_dir not in sys.path:
        sys.path.append(native_dir)
    try:
        return importlib.import_module("_voxnative")
    except ImportError:
        return None


def parse_vox(data: bytes, use_native: bool = True) -> List[VoxModel]:
    """Parse .vox bytes into a list of models (shared palette): through
    the C parser when ``use_native`` and it is built, else through the
    numpy chunk walker; both give the same models."""
    native = _native_module() if use_native else None
    if native is not None:
        raw_models, pal_bytes = native.parse_vox(data)
        palette = (np.frombuffer(pal_bytes, np.uint8).reshape(256, 4).copy()
                   if pal_bytes is not None else _default_palette())
        return [VoxModel(grid=np.frombuffer(grid, np.uint8).reshape(sx, sz, sy).copy(),
                         palette=palette)
                for sx, sy, sz, grid in raw_models]

    if data[:4] != b"VOX ":
        raise ValueError("not a .vox file (missing 'VOX ' magic)")
    pos = 8   # skip magic + version

    sizes = []
    xyzis = []
    palette = _default_palette()

    end = len(data)
    while pos + 12 <= end:
        cid = data[pos: pos + 4]
        n, _children = struct.unpack_from("<ii", data, pos + 4)
        content = data[pos + 12: pos + 12 + n]
        nxt = pos + 12 + n
        if cid == b"SIZE":
            sizes.append(struct.unpack_from("<iii", content, 0))
        elif cid == b"XYZI":
            (cnt,) = struct.unpack_from("<i", content, 0)
            arr = np.frombuffer(content, np.uint8, count=cnt * 4, offset=4)
            xyzis.append(arr.reshape(cnt, 4))
        elif cid == b"RGBA":
            raw = np.frombuffer(content, np.uint8, count=256 * 4).reshape(256, 4)
            # RGBA chunk color i maps to palette index i+1 (spec)
            palette = np.zeros((256, 4), np.uint8)
            palette[1:] = raw[:255]
        elif cid == b"MAIN":
            nxt = pos + 12  # descend into children
        pos = nxt

    models = []
    for (sx, sy, sz), vox in zip(sizes, xyzis):
        # Voxels are (x, y, z, color_index) in vox coords
        v = np.zeros((sz, sy, sx), np.uint8)
        if len(vox):
            v[vox[:, 2].astype(np.int64), vox[:, 1].astype(np.int64),
              vox[:, 0].astype(np.int64)] = vox[:, 3]
        # Axis remap (vv.cpp:39-49): grid[vx, vz, sy-1-vy] = vox[vz, vy, vx]
        grid = v.transpose(2, 0, 1)[:, :, ::-1].copy()
        models.append(VoxModel(grid=grid, palette=palette))
    return models


def load_vox(path: str, model_id: int = 0) -> VoxModel:
    """Load one model from a .vox file (OVoxelVolume ctor analog, vv.cpp:12-54)."""
    with open(path, "rb") as f:
        models = parse_vox(f.read())
    return models[model_id]


def vox_bytes(size, voxels, rgba=None) -> bytes:
    """One model as .vox bytes, the chunks `parse_vox` reads: SIZE
    ``size`` (vox x, y, z), XYZI ``voxels`` ((N, 4) x, y, z, colour
    index) and, unless None, RGBA ``rgba`` ((256, 4) uint8, entry i the
    colour of index i + 1)."""
    def chunk(cid, content, children=b""):
        return cid + struct.pack("<ii", len(content), len(children)) + content + children

    body = chunk(b"SIZE", struct.pack("<iii", *size))
    body += chunk(b"XYZI", struct.pack("<i", len(voxels))
                  + np.asarray(voxels, np.uint8).tobytes())
    if rgba is not None:
        body += chunk(b"RGBA", np.asarray(rgba, np.uint8).tobytes())
    return b"VOX " + struct.pack("<i", 150) + chunk(b"MAIN", b"", body)


def grid_vox_bytes(grid: np.ndarray, palette: np.ndarray) -> bytes:
    """The .vox bytes whose `load_vox` grid is ``grid`` ((Z, Y, X) uint8,
    y up) and whose albedo is ``palette`` ((256, 3) float in [0, 1],
    rounded to 8 bits; entry 0 unused)."""
    gz, gy, gx = grid.shape
    z, y, x = np.nonzero(grid)
    # the inverse of parse_vox's remap: grid[z, y, x] = vox[x = z, y = gx - 1 - x, z = y]
    voxels = np.stack([z, gx - 1 - x, y, grid[z, y, x]], axis=1)
    rgba = np.full((256, 4), 255, np.uint8)
    rgba[:255, :3] = np.round(np.asarray(palette)[1:, :3] * 255)
    return vox_bytes((gz, gx, gy), voxels, rgba)
