"""The wavefront composite's traversal glue as three kernels: host side of
`csrc/composite.cu`.

Each traversal call of `ops/composite.py` (`intersect_scene`, `intersect_group`,
`is_occluded`, `march_interior`, a candidate slot) carries its rays to
the volume's local space, hands them to D1 and turns D1's outputs into
the hit record.  Its plain version is the tensor glue of
`ops/composite.py` (`_to_local`, the one-volume record, the candidate slot,
`HitResult.nearer`, `_march_interior`), about 70 eager operations a call;
here the same float program is `to_local` (one launch) and `record` (one
launch), with D1 between them unchanged.  A stacked group's top-K slab
prepass (`composite._topk`, about 95 eager operations an object and an
upload of the grid dims) is `topk`, one launch for every object and K up
to `TOPK_MAX`.  `ops/composite.py` takes them for CUDA tensors when the
traversal runs on D1 (``dda_fn`` None) and its glue otherwise (CPU
tensors, `composite.PLAIN`); a K above `TOPK_MAX`, a failed build or a
failed launch raises.

The ray's object is one of: ``oid`` an int (every ray reads that object
of the group), ``oid`` an (N,) int64 tensor (a candidate slot), or
``obj`` an (N,) int32 tensor of global object indices with ``obj_base``,
read as clamp(obj - obj_base, 0, O - 1) (the interior march).

`KERNEL_LAUNCHES` counts the traversal calls that took the kernels
(`composite_fused`) and those that took the glue (`composite_glue`), and
each kernel's launches (`composite_local`, `composite_record`,
`composite_topk`).
"""

from __future__ import annotations

import ctypes

import torch

from voxel_tracer_tpu_torch.ops.cuda import _build

KERNEL_LAUNCHES = {"composite_fused": 0, "composite_glue": 0, "composite_local": 0,
                   "composite_record": 0, "composite_topk": 0}
TOPK_MAX = 8        # the largest K `topk` holds in registers (csrc/composite.cu)


def reset_launch_counts():
    for k in KERNEL_LAUNCHES:
        KERNEL_LAUNCHES[k] = 0


def fused(origins, dda_fn) -> bool:
    """Whether a traversal call of these rays takes the kernels (CUDA
    tensors on D1), counted in `KERNEL_LAUNCHES`."""
    on = dda_fn is None and origins.device.type == "cuda"
    KERNEL_LAUNCHES["composite_fused" if on else "composite_glue"] += 1
    return on


_P, _I = ctypes.c_void_p, ctypes.c_int


class _LocalArgs(ctypes.Structure):
    """`LocalArgs` of csrc/composite.cu, field for field."""

    _fields_ = [(name, _P) for name in (
        "orig", "dirs", "rot", "pos", "pivot", "vpu", "oid_ray", "obj", "o_l", "d_l",
        "vpu_out", "oid_out")] + [(name, _I) for name in ("n", "orig_row", "dirs_row", "n_obj",
                                                          "oid_s", "obj_base")]


class _RecordArgs(ctypes.Structure):
    """`RecordArgs` of csrc/composite.cu, field for field."""

    _fields_ = [(name, _P) for name in (
        "t", "mat", "axis", "step_sign", "steps", "rot", "palette", "oid_ray", "obj", "live",
        "rt", "rmat", "rnormal", "ralbedo", "rsteps", "robj")] + [
        (name, _I) for name in ("n", "n_obj", "oid_s", "obj_base", "select", "fresh")]


class _TopkArgs(ctypes.Structure):
    """`TopkArgs` of csrc/composite.cu, field for field."""

    _fields_ = [(name, _P) for name in ("orig", "dirs", "rot", "pos", "pivot", "vpu", "t",
                                        "ids")] + [
        (name, _I) for name in ("n", "orig_row", "dirs_row", "n_obj", "k", "gx", "gy", "gz")]


# D1's outputs that `record` reads and the record's fields (HitResult's
# order), with their dtypes
_D1_FIELDS = (("t", torch.float32), ("mat", torch.int32), ("axis", torch.int32),
              ("step_sign", torch.float32), ("steps", torch.int32))
_RECORD_FIELDS = (("t", torch.float32), ("mat", torch.int32), ("normal", torch.float32),
                  ("albedo", torch.float32), ("steps", torch.int32), ("obj", torch.int32))


def _lib():
    lib = _build.load("composite")
    if not getattr(lib, "_vt_typed", False):
        lib.vt_composite_local.argtypes = [ctypes.POINTER(_LocalArgs), _P]
        lib.vt_composite_local.restype = _I
        lib.vt_composite_record.argtypes = [ctypes.POINTER(_RecordArgs), _P]
        lib.vt_composite_record.restype = _I
        lib.vt_composite_topk.argtypes = [ctypes.POINTER(_TopkArgs), _P]
        lib.vt_composite_topk.restype = _I
        lib.vt_error_string.argtypes = [_I]
        lib.vt_error_string.restype = ctypes.c_char_p
        lib._vt_typed = True
    return lib


def _ptr(x):
    return None if x is None else x.data_ptr()


def _checked(name, t, dtype, shape, dev):
    """``t``, if it has this dtype, shape and device and is contiguous (what
    the kernel reads through a bare pointer), tested in one line on the
    hot path; else `_build.check` raises, naming what differs."""
    if t.dtype != dtype or t.shape != shape or t.device != dev or not t.is_contiguous():
        _build.check(name, t, dtype, shape, dev)
    return t


def _rows(name, x, n, dev):
    """(N, 3) float32 rays as the kernel reads them, with their row stride:
    3, or 0 for one vector broadcast to every ray (`shading.sun_light`'s
    direction); any other layout is copied first."""
    if x.shape != (n, 3):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {(n, 3)}")
    if x.stride(-1) != 1 or x.stride(0) not in (0, 3):
        x = x.contiguous()
    _checked(name, x[:1], torch.float32, (min(n, 1), 3), dev)
    return x, x.stride(0)


def _tables(group, dev):
    """The group's (rot, pos, pivot, vpu) as the kernels read them."""
    o_count = group.rot.shape[0]
    return (_checked("rot", group.rot.contiguous(), torch.float32, (o_count, 3, 3), dev),
            _checked("pos", group.pos.contiguous(), torch.float32, (o_count, 3), dev),
            _checked("pivot", group.pivot.contiguous(), torch.float32, (o_count, 3), dev),
            _checked("vpu", group.vpu.contiguous(), torch.float32, (o_count,), dev))


def _object_source(oid, obj, n, dev):
    """(scalar oid, per-ray int64 oid or None, per-ray int32 obj or None)."""
    if obj is not None:
        return 0, None, _checked("obj", obj, torch.int32, (n,), dev)
    if isinstance(oid, torch.Tensor):
        return 0, _checked("oid", oid, torch.int64, (n,), dev), None
    return int(oid), None, None


def _on_cuda(dev, plain):
    if dev.type != "cuda":
        raise ValueError(f"the kernels take CUDA tensors, not {dev}: the plain version is "
                         f"composite.{plain}")


def _launch(fn, args, dev, what):
    lib = _lib()
    with torch.cuda.device(dev):
        err = getattr(lib, fn)(ctypes.byref(args), torch.cuda.current_stream(dev).cuda_stream)
    _build.raise_on(lib, err, what)
    KERNEL_LAUNCHES[what] += 1


def to_local(group, origins, dirs, oid=0, obj=None, obj_base: int = 0):
    """`composite._to_local` of each ray against its object of ``group``:
    (o_l, d_l, vpu, oid).  ``vpu`` is the object's (0-d) entry of
    ``group.vpu`` for a scalar ``oid`` and per ray otherwise; ``oid`` is
    D1's argument for ``obj`` (the (N,) int64 object per ray over a
    stacked group, else None) and None otherwise."""
    dev = origins.device
    _on_cuda(dev, "_local_rays")
    n = origins.shape[0]
    o_count = group.rot.shape[0]
    origins, o_row = _rows("origins", origins, n, dev)
    dirs, d_row = _rows("dirs", dirs, n, dev)
    rot, pos, pivot, vpu = _tables(group, dev)
    oid_s, oid_ray, obj = _object_source(oid, obj, n, dev)
    if not 0 <= oid_s < o_count:
        raise ValueError(f"object {oid_s} of a group of {o_count}")
    o_l = torch.empty((n, 3), dtype=torch.float32, device=dev)
    d_l = torch.empty((n, 3), dtype=torch.float32, device=dev)
    scalar = oid_ray is None and obj is None
    vpu_ray = vpu[oid_s] if scalar else torch.empty((n,), dtype=torch.float32, device=dev)
    oid_out = torch.empty((n,), dtype=torch.int64, device=dev) \
        if obj is not None and o_count > 1 else None
    if n:
        args = _LocalArgs(origins.data_ptr(), dirs.data_ptr(), rot.data_ptr(), pos.data_ptr(),
                          pivot.data_ptr(), vpu.data_ptr(), _ptr(oid_ray), _ptr(obj),
                          o_l.data_ptr(), d_l.data_ptr(), None if scalar else vpu_ray.data_ptr(),
                          _ptr(oid_out),
                          n, o_row, d_row, o_count, oid_s, int(obj_base))
        _launch("vt_composite_local", args, dev, "composite_local")
    return o_l, d_l, vpu_ray, oid_out


def record_out(best, n, dev):
    """The record a kernel merges into, as it reads it: ``best`` checked,
    or, for None, a new `composite.HitResult` the kernel writes fresh."""
    from voxel_tracer_tpu_torch.ops.composite import HitResult

    shapes = [(n, 3) if name in ("normal", "albedo") else (n,) for name, _d in _RECORD_FIELDS]
    if best is None:
        return HitResult(*(torch.empty(shape, dtype=dtype, device=dev)
                           for shape, (_name, dtype) in zip(shapes, _RECORD_FIELDS)))
    for shape, (name, dtype), x in zip(shapes, _RECORD_FIELDS, best):
        _checked(f"best.{name}", x, dtype, shape, dev)
    return best


def record(group, res, best=None, oid=0, obj=None, obj_base: int = 0, live=None,
           select: bool = False):
    """D1's outputs ``res`` against ``group`` as a `composite.HitResult`,
    merged into ``best`` in place and returned, or written fresh where
    ``best`` is None (as if merged into `HitResult.miss`).

    Nearer (``select`` False): the traced object(s)' record (a
    candidate slot's with ``live``), then `HitResult.nearer`.  Select: the interior
    march's merge, rows whose ``obj`` lies in the group taking D1's raw
    outputs and their ``obj``."""
    t = res["t"]
    dev = t.device
    _on_cuda(dev, "_record")
    n = t.shape[0]
    o_count = group.rot.shape[0]
    d1 = [_checked(name, res[name], dtype, (n, 3) if name == "step_sign" else (n,), dev)
          for name, dtype in _D1_FIELDS]
    rot = _checked("rot", group.rot.contiguous(), torch.float32, (o_count, 3, 3), dev)
    palette = _checked("palette", group.palette.contiguous(), torch.float32,
                       (o_count, 256, 3), dev)
    oid_s, oid_ray, obj = _object_source(oid, obj, n, dev)
    if select and obj is None:
        raise ValueError("select needs obj")
    if not 0 <= oid_s < o_count:
        raise ValueError(f"object {oid_s} of a group of {o_count}")
    if live is not None:
        _checked("live", live, torch.bool, (n,), dev)
    fresh = best is None
    best = record_out(best, n, dev)
    if n:
        args = _RecordArgs(*(x.data_ptr() for x in d1),
                           rot.data_ptr(), palette.data_ptr(), _ptr(oid_ray), _ptr(obj),
                           _ptr(live), *(x.data_ptr() for x in best),
                           n, o_count, oid_s, int(obj_base), int(select), int(fresh))
        _launch("vt_composite_record", args, dev, "composite_record")
    return best


def topk(group, origins, dirs, k: int):
    """`composite._topk`: each ray's ``k`` nearest objects of ``group`` by
    slab entry t, as (N, k) float32 t (1e30 where no object fills a slot)
    and (N, k) int32 ids (0 there), nearest first, a tie to the earlier
    object.  ``k`` runs from 1 to `TOPK_MAX`."""
    if not 1 <= k <= TOPK_MAX:
        raise ValueError(f"k = {k} outside 1..{TOPK_MAX}: the plain version is composite._topk")
    dev = origins.device
    _on_cuda(dev, "_topk")
    n = origins.shape[0]
    origins, o_row = _rows("origins", origins, n, dev)
    dirs, d_row = _rows("dirs", dirs, n, dev)
    rot, pos, pivot, vpu = _tables(group, dev)
    gz, gy, gx = group.grid.shape[-3:]
    t = torch.empty((n, k), dtype=torch.float32, device=dev)
    ids = torch.empty((n, k), dtype=torch.int32, device=dev)
    if n:
        args = _TopkArgs(origins.data_ptr(), dirs.data_ptr(), rot.data_ptr(), pos.data_ptr(),
                         pivot.data_ptr(), vpu.data_ptr(), t.data_ptr(), ids.data_ptr(),
                         n, o_row, d_row, rot.shape[0], k, gx, gy, gz)
        _launch("vt_composite_topk", args, dev, "composite_topk")
    return t, ids
