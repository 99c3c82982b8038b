"""ctypes bindings for the C++ CPU oracle (native/oracle.cpp).

Counterpart of `voxel_tracer_tpu/ops/oracle_native.py`: the same binding
of the repository's `native/liboracle.so`.  Same traversal semantics as
`ops/oracle.py`, much faster, for large parity sweeps; `available()` is
False when the library is not built (`native/build.sh`).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB_PATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native", "liboracle.so")

_lib = None


def available() -> bool:
    global _lib
    if _lib is None and os.path.exists(_LIB_PATH):
        _lib = ctypes.CDLL(_LIB_PATH)
        _lib.oracle_trace.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),    # vox
            ctypes.POINTER(ctypes.c_int32),    # occ
            ctypes.c_int, ctypes.c_int, ctypes.c_int,   # gx gy gz
            ctypes.c_int, ctypes.c_int, ctypes.c_int,   # bx by bz
            ctypes.c_float,                    # vpu
            ctypes.POINTER(ctypes.c_float),    # rays
            ctypes.c_int,                      # n
            ctypes.POINTER(ctypes.c_float),    # out
        ]
        _lib.oracle_trace.restype = None
    return _lib is not None


def trace(grid: np.ndarray, brick_occ: np.ndarray, vpu: float,
          origins_l: np.ndarray, dirs_l: np.ndarray) -> dict:
    """Trace N local-space rays; returns dict of (N,) arrays t/mat/axis/steps.

    grid: (Z, Y, X) uint8; brick_occ: (BZ, BY, BX) int32.
    """
    assert available(), "liboracle.so not built (run native/build.sh)"
    grid = np.ascontiguousarray(grid, np.uint8)
    occ = np.ascontiguousarray(brick_occ, np.int32)
    gz, gy, gx = grid.shape
    bz, by, bx = occ.shape
    n = origins_l.shape[0]
    rays = np.ascontiguousarray(
        np.concatenate([origins_l, dirs_l], axis=1), np.float32)
    out = np.empty((n, 4), np.float32)
    _lib.oracle_trace(
        grid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        occ.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        gx, gy, gz, bx, by, bz, ctypes.c_float(vpu),
        rays.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return dict(t=out[:, 0], mat=out[:, 1].astype(np.int32),
                axis=out[:, 2].astype(np.int32),
                steps=out[:, 3].astype(np.int32))
