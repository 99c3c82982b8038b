"""Space-filling curves: Morton and Hilbert orderings (src/curves/ analog).

Counterpart of `voxel_tracer_tpu/ops/curves.py`, numpy on the host.  The
reference uses BMI2 `_pdep/_pext` Morton encode/decode (morton.h:13-134)
and a Hilbert 8^3 LUT (hilbert.h:4) as optional intra-brick layouts; here
the codes are computed with vectorized bit arithmetic, for brick-major
grid reordering experiments.
"""

from __future__ import annotations

import numpy as np


def _part1by1(x):
    """Spread bits of x: b_i -> position 2i (16-bit input)."""
    x = np.asarray(x, np.uint32) & 0x0000FFFF
    x = (x | (x << 8)) & 0x00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F
    x = (x | (x << 2)) & 0x33333333
    x = (x | (x << 1)) & 0x55555555
    return x


def _compact1by1(x):
    x = np.asarray(x, np.uint32) & 0x55555555
    x = (x | (x >> 1)) & 0x33333333
    x = (x | (x >> 2)) & 0x0F0F0F0F
    x = (x | (x >> 4)) & 0x00FF00FF
    x = (x | (x >> 8)) & 0x0000FFFF
    return x


def _part1by2(x):
    """Spread bits of x: b_i -> position 3i (10-bit input)."""
    x = np.asarray(x, np.uint32) & 0x000003FF
    x = (x | (x << 16)) & 0xFF0000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def _compact1by2(x):
    x = np.asarray(x, np.uint32) & 0x09249249
    x = (x | (x >> 2)) & 0x030C30C3
    x = (x | (x >> 4)) & 0x0300F00F
    x = (x | (x >> 8)) & 0xFF0000FF
    x = (x | (x >> 16)) & 0x000003FF
    return x


def morton2_encode(x, y):
    """(x, y) -> 2D Morton code (morton.h 2D analog)."""
    return _part1by1(x) | (_part1by1(y) << 1)


def morton2_decode(code):
    code = np.asarray(code, np.uint32)
    return _compact1by1(code), _compact1by1(code >> 1)


def morton3_encode(x, y, z):
    """(x, y, z) -> 3D Morton code (morton.h 3D analog)."""
    return _part1by2(x) | (_part1by2(y) << 1) | (_part1by2(z) << 2)


def morton3_decode(code):
    code = np.asarray(code, np.uint32)
    return _compact1by2(code), _compact1by2(code >> 1), _compact1by2(code >> 2)


def hilbert3_table(order: int = 1) -> np.ndarray:
    """8^(3*order) Hilbert curve index LUT for an (2^o)^3 cube.

    hilbert.h:4 ships a hand-written 8^3 LUT; here the curve is generated
    (Gilbert/Skilling transform), returning lut[z, y, x] = curve index.
    """
    n = 1 << order
    lut = np.zeros((n, n, n), np.int32)
    for idx in range(n ** 3):
        x, y, z = _hilbert_d2xyz(order, idx)
        lut[z, y, x] = idx
    return lut


def _hilbert_d2xyz(order: int, d: int):
    """Skilling's algorithm: curve distance -> 3D coords."""
    bits = 3
    # distance -> transpose form
    X = [0, 0, 0]
    for i in range(order * bits):
        X[2 - (i % 3)] |= ((d >> i) & 1) << (i // 3)
    # Gray decode
    n = 2 << (order - 1)
    t = X[2] >> 1
    for i in range(2, 0, -1):
        X[i] ^= X[i - 1]
    X[0] ^= t
    q = 2
    while q != n:
        p = q - 1
        for i in range(2, -1, -1):
            if X[i] & q:
                X[0] ^= p
            else:
                t = (X[0] ^ X[i]) & p
                X[0] ^= t
                X[i] ^= t
        q <<= 1
    return X[0], X[1], X[2]


def brick_linear_to_morton(grid: np.ndarray, brick: int = 8) -> np.ndarray:
    """Reorder a (Z, Y, X) grid so each brick's 512 voxels are contiguous
    in Morton order — the gather-friendly layout for brick staging."""
    gz, gy, gx = grid.shape
    assert gz % brick == 0 and gy % brick == 0 and gx % brick == 0
    bz, by, bx = gz // brick, gy // brick, gx // brick
    b = grid.reshape(bz, brick, by, brick, bx, brick)
    b = b.transpose(0, 2, 4, 1, 3, 5).reshape(bz * by * bx, brick ** 3 // (brick ** 2), -1)
    # voxels within brick currently in z-major; apply morton permutation
    zz, yy, xx = np.meshgrid(np.arange(brick), np.arange(brick),
                             np.arange(brick), indexing="ij")
    codes = morton3_encode(xx.ravel(), yy.ravel(), zz.ravel())
    perm = np.argsort(codes, kind="stable")
    flat = grid.reshape(bz, brick, by, brick, bx, brick)
    flat = flat.transpose(0, 2, 4, 1, 3, 5).reshape(-1, brick ** 3)
    return flat[:, perm]
