"""The two-level DDA as one kernel (D1): host side of `csrc/dda.cu`.

Counterpart of the XLA program of `voxel_tracer_tpu/ops/dda.py`
(`intersect_volume_local`, jitted, one `lax.while_loop`), which the JAX
package runs inside each frame's jit.  Its plain version is
`ops/dda.intersect_volume_local`, a host loop of lock-step tensor
iterations; `intersect_volume_local` here has its signature and returns
the same dict, `resolved` included.  CUDA tensors launch D1, CPU tensors
run the plain version; a failed build or launch raises.

The callers: `ops/composite.py` (the wavefront traversal of
`renderer.Renderer`, `march_interior`, `is_occluded`),
`ops/cuda/whitted.MegaIntersector` (the exact fallback) and
`ops/cuda/integrate.py` (the kernel renderer's fallback).  Each takes a
``dda_fn``; passing `ops.dda.intersect_volume_local` gives the plain
frame.

One call allocates its outputs and, with a medium, an (N,) int32 scratch
and one int32 counter, then launches pass 1 and, with a medium, pass 2
(the batch rule of the JAX loop, see `csrc/dda.cu`), on the current
stream.  `KERNEL_LAUNCHES["dda"]` counts the calls that launch.
"""

from __future__ import annotations

import ctypes

import torch

from voxel_tracer_tpu_torch.ops import dda
from voxel_tracer_tpu_torch.ops.cuda import _build

KERNEL_LAUNCHES = {"dda": 0}


def reset_launch_counts():
    for k in KERNEL_LAUNCHES:
        KERNEL_LAUNCHES[k] = 0


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


class _Args(ctypes.Structure):
    """`DdaArgs` of csrc/dda.cu, field for field."""

    _fields_ = [(name, _P) for name in (
        "orig", "dirs", "grid", "bocc", "vpu_ray", "oid", "medium", "ignore", "seed",
        "t", "slab_tmin", "slab_tmax", "step_sign", "mat", "axis", "steps",
        "entry_axis", "valid", "resolved", "pend", "maxc")] + [
        (name, _I) for name in ("n", "gx", "gy", "gz", "bx", "by", "bz", "vpu_stride",
                                "max_steps", "shadow")] + [("vpu", _F)]


def _lib():
    lib = _build.load("dda")
    if not getattr(lib, "_vt_typed", False):
        lib.vt_dda.argtypes = [ctypes.POINTER(_Args), _P]
        lib.vt_dda.restype = _I
        lib.vt_error_string.argtypes = [_I]
        lib.vt_error_string.restype = ctypes.c_char_p
        lib._vt_typed = True
    return lib


def _per_ray(x, dtype, n, dev):
    """An optional per-ray integer input (or a scalar for every ray) as a
    contiguous (N,) tensor on ``dev``."""
    if x is None:
        return None
    return torch.broadcast_to(torch.as_tensor(x, device=dev), (n,)).to(dtype).contiguous()


def _ptr(x):
    return None if x is None else x.data_ptr()


def intersect_volume_local(grid, brick_occ, origin_l, dir_l, vpu,
                           oid=None, max_steps: int = dda.MAX_STEPS,
                           medium=None, ignore=None, shadow_seed=None,
                           shadow: bool = False):
    """`ops/dda.intersect_volume_local` on D1 for CUDA tensors (its plain
    version for CPU tensors): the same arguments, the same dict of (N,)
    tensors (t, mat, axis, step_sign (N, 3), steps, valid, entry_axis,
    slab_tmin, slab_tmax, resolved)."""
    dev = _build.device_of(origin_l)
    if dev.type == "cpu":
        return dda.intersect_volume_local(grid, brick_occ, origin_l, dir_l, vpu, oid=oid,
                                          max_steps=max_steps, medium=medium,
                                          ignore=ignore, shadow_seed=shadow_seed,
                                          shadow=shadow)
    n = origin_l.shape[0]
    if n >= 2 ** 31 // 4:
        raise ValueError(f"{n} rays: the kernel takes fewer than 2**29")
    if shadow and shadow_seed is None:
        raise ValueError("shadow=True needs shadow_seed")
    # (O, Z, Y, X) stacked grids; without oid every ray reads object 0
    if grid.ndim not in (3, 4) or brick_occ.ndim != grid.ndim \
            or (oid is not None and grid.ndim != 4):
        raise ValueError(f"grid {tuple(grid.shape)} and brick_occ "
                         f"{tuple(brick_occ.shape)}: expected (Z, Y, X) grids, or "
                         f"(O, Z, Y, X) with oid")
    grid = grid.to(torch.int32).contiguous()
    brick_occ = brick_occ.to(torch.int32).contiguous()
    gz, gy, gx = grid.shape[-3:]
    bz, by, bx = brick_occ.shape[-3:]
    if (bz, by, bx) != tuple(-(-s // dda.BRICK) for s in (gz, gy, gx)) \
            or brick_occ.shape[:-3] != grid.shape[:-3]:
        raise ValueError(f"brick_occ {tuple(brick_occ.shape)} does not cover grid "
                         f"{tuple(grid.shape)} in {dda.BRICK}^3 bricks")
    _build.check("grid", grid, torch.int32, grid.shape, dev)
    _build.check("brick_occ", brick_occ, torch.int32, brick_occ.shape, dev)
    _build.check("origin_l", origin_l, torch.float32, (n, 3), dev)
    _build.check("dir_l", dir_l, torch.float32, (n, 3), dev)
    oid = _per_ray(oid, torch.int64, n, dev)
    medium = _per_ray(medium, torch.int32, n, dev)
    ignore = _per_ray(ignore, torch.int32, n, dev)
    seed = _per_ray(shadow_seed, torch.int64, n, dev) if shadow else None
    if isinstance(vpu, torch.Tensor):
        vpu_ray = vpu.to(dev, torch.float32).contiguous()
        if vpu_ray.ndim not in (0, 1) or (vpu_ray.ndim == 1 and vpu_ray.shape[0] != n):
            raise ValueError(f"vpu of shape {tuple(vpu_ray.shape)} for {n} rays")
        vpu_stride, vpu_val = int(vpu_ray.ndim == 1), 0.0
    else:
        vpu_ray, vpu_stride, vpu_val = None, 0, float(vpu)

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    out = dict(t=empty(n), mat=empty(n, dtype=torch.int32), axis=empty(n, dtype=torch.int32),
               step_sign=empty(n, 3), steps=empty(n, dtype=torch.int32),
               valid=empty(n, dtype=torch.bool), entry_axis=empty(n, dtype=torch.int32),
               slab_tmin=empty(n), slab_tmax=empty(n), resolved=empty(n, dtype=torch.bool))
    if n == 0:                  # an empty grid is not a valid launch
        return out
    pend = empty(n, dtype=torch.int32) if medium is not None else None
    maxc = empty(1, dtype=torch.int32) if medium is not None else None
    args = _Args(
        origin_l.data_ptr(), dir_l.data_ptr(), grid.data_ptr(), brick_occ.data_ptr(),
        _ptr(vpu_ray), _ptr(oid), _ptr(medium), _ptr(ignore), _ptr(seed),
        *(out[k].data_ptr() for k in ("t", "slab_tmin", "slab_tmax", "step_sign", "mat",
                                      "axis", "steps", "entry_axis", "valid", "resolved")),
        _ptr(pend), _ptr(maxc), n, gx, gy, gz, bx, by, bz, vpu_stride, int(max_steps),
        int(bool(shadow)), vpu_val)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.vt_dda(ctypes.byref(args), torch.cuda.current_stream(dev).cuda_stream)
    _build.raise_on(lib, err, "dda")
    KERNEL_LAUNCHES["dda"] += 1
    return out
