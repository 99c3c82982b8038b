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

The kernel reads tables derived from the caller's grid and brick counts
(`dda_tables`): a brick bitmap, 16 occupancy words and 512 material
bytes a brick, and a device flag that says whether some id lies outside
[0, 255] (the kernel then reads a solid voxel's id from the int32 grid).
`tables_for` derives them once and keeps them on the grid's base tensor,
keyed by the data pointers, shapes, strides and dtypes of the grid and
the brick counts; an entry whose tensors have since been edited in place
(their `_version` moved: `mega.set_voxel_tables`, `MegaIntersector.
set_voxel`) is derived anew, so a frame never reads stale tables.

One call allocates its outputs and, with a medium, an (N,) int32 scratch
and one int32 counter, then launches pass 1 and, with a medium, pass 2
(the batch rule of the JAX loop, see `csrc/dda.cu`), on the current
stream.  `KERNEL_LAUNCHES` counts the calls that launch (`dda`), the rays
handed to `intersect_volume_local` on either branch (`dda_rays`) and the
table derivations of `tables_for` (`dda_tables`).  Each call is a `d1`
span (`utils/profiling.annotate`) that notes how many of its rays the
calling stages keep (`profiling.count_kept`).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from voxel_tracer_tpu_torch.ops import dda
from voxel_tracer_tpu_torch.ops.cuda import _build
from voxel_tracer_tpu_torch.utils import profiling

KERNEL_LAUNCHES = {"dda": 0, "dda_rays": 0, "dda_tables": 0}


def reset_launch_counts():
    for k in KERNEL_LAUNCHES:
        KERNEL_LAUNCHES[k] = 0


# True: the kernel reads the brick bitmap from global memory whatever its
# size (the branch it takes above SMEM_BITMAP_MAX_WORDS of csrc/dda.cu);
# the card's checks set it to run that branch on small grids.
GLOBAL_BITMAP = False

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


class _Args(ctypes.Structure):
    """`DdaArgs` of csrc/dda.cu, field for field."""

    _fields_ = [(name, _P) for name in (
        "orig", "dirs", "bits", "occw", "matb", "grid", "wide", "vpu_ray", "oid", "medium",
        "ignore", "seed", "t", "slab_tmin", "slab_tmax", "step_sign", "mat", "axis", "steps",
        "entry_axis", "valid", "resolved", "pend", "maxc")] + [
        (name, _I) for name in ("n", "gx", "gy", "gz", "bx", "by", "bz", "nwords",
                                "global_bits", "vpu_stride", "max_steps", "shadow")] + [
        ("vpu", _F)]


# ---------------------------------------------------------------------------
# The kernel's tables
# ---------------------------------------------------------------------------

class DdaTables(NamedTuple):
    """What D1 reads in place of the int32 grid and brick counts, for
    (O, Z, Y, X) grids (O = 1 for a (Z, Y, X) grid) of NB = BX * BY * BZ
    bricks each.  Brick g = o * NB + (bz * BY + by) * BX + bx; voxel
    v = z * 64 + y * 8 + x inside its brick."""

    bits: torch.Tensor    # (ceil(O * NB / 32),) int32 (uint32 bits): bit g % 32 of
                          # word g // 32 iff brick_occ > 0
    occw: torch.Tensor    # (O * NB, 16) int32 (uint32 bits): bit v % 32 of word
                          # v // 32 iff the voxel is nonzero (0 past the grid's edge)
    matb: torch.Tensor    # (O * NB, 512) uint8: the low byte of each id
    wide: torch.Tensor    # (1,) int32: 1 iff some id lies outside [0, 255]


def _pack_bits(flags):
    """(..., 32) bool -> (...,) int32 words (uint32 bits): bit k of a word is
    flag k."""
    shifts = torch.arange(32, device=flags.device)
    words = (flags.to(torch.int64) << shifts).sum(dim=-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def dda_tables(grid, brick_occ) -> DdaTables:
    """Derive D1's tables from a (Z, Y, X) or (O, Z, Y, X) integer grid and
    its brick counts, on their device, with no host sync."""
    g = grid.reshape(-1, *grid.shape[-3:]).to(torch.int32)
    o, gz, gy, gx = g.shape
    bz, by, bx = brick_occ.shape[-3:]
    nb = bx * by * bz
    pad = g.new_zeros((o, bz * dda.BRICK, by * dda.BRICK, bx * dda.BRICK))
    pad[:, :gz, :gy, :gx] = g
    bricks = pad.reshape(o, bz, 8, by, 8, bx, 8).permute(0, 1, 3, 5, 2, 4, 6)
    bricks = bricks.reshape(o * nb, 512)
    flags = brick_occ.reshape(-1) > 0
    nw = -(-flags.numel() // 32)
    flags = torch.cat([flags, flags.new_zeros(nw * 32 - flags.numel())])
    return DdaTables(bits=_pack_bits(flags.reshape(nw, 32)),
                     occw=_pack_bits((bricks != 0).reshape(o * nb, 16, 32)),
                     matb=bricks.to(torch.uint8),
                     wide=((g < 0) | (g > 255)).any().to(torch.int32).reshape(1))


_CACHE_ATTR = "_vt_dda_tables"
_CACHE_ENTRIES = 16


def _key(t):
    return (t.data_ptr(), tuple(t.shape), tuple(t.stride()), t.dtype)


def tables_for(grid, brick_occ) -> DdaTables:
    """`dda_tables(grid, brick_occ)`, derived once and kept on the grid's
    base tensor (a slice `group.grid[k]` of stacked grids shares its
    base): an entry is reused while neither tensor has been edited in
    place since (`_version`).  The entry holds the brick counts' base, so
    their memory cannot be reused for another tensor under the same key."""
    if grid.is_inference() or brick_occ.is_inference():    # no version counter
        KERNEL_LAUNCHES["dda_tables"] += 1
        return dda_tables(grid, brick_occ)
    base = grid if grid._base is None else grid._base
    cache = base.__dict__.setdefault(_CACHE_ATTR, {})
    key = (_key(grid), _key(brick_occ))
    versions = (grid._version, brick_occ._version)
    hit = cache.get(key)
    if hit is not None and hit[0] == versions:
        return hit[2]
    if len(cache) >= _CACHE_ENTRIES:
        cache.clear()
    KERNEL_LAUNCHES["dda_tables"] += 1
    tables = dda_tables(grid, brick_occ)
    cache[key] = (versions, brick_occ if brick_occ._base is None else brick_occ._base,
                  tables)
    return tables


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
    n = origin_l.shape[0]
    KERNEL_LAUNCHES["dda_rays"] += n
    with profiling.annotate("d1", rays=n):
        profiling.count_kept(n)
        return _intersect(grid, brick_occ, origin_l, dir_l, vpu, oid, max_steps, medium,
                          ignore, shadow_seed, shadow)


def _intersect(grid, brick_occ, origin_l, dir_l, vpu, oid, max_steps, medium, ignore,
               shadow_seed, shadow):
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
    gz, gy, gx = grid.shape[-3:]
    bz, by, bx = brick_occ.shape[-3:]
    if (bz, by, bx) != tuple(-(-s // dda.BRICK) for s in (gz, gy, gx)) \
            or brick_occ.shape[:-3] != grid.shape[:-3]:
        raise ValueError(f"brick_occ {tuple(brick_occ.shape)} does not cover grid "
                         f"{tuple(grid.shape)} in {dda.BRICK}^3 bricks")
    for name, t in (("grid", grid), ("brick_occ", brick_occ)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
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
    tb = tables_for(grid, brick_occ)
    # the kernel reads the int32 ids only where `wide` is set, which a
    # uint8 grid never is
    grid32 = None if grid.dtype == torch.uint8 else grid.to(torch.int32).contiguous()
    pend = empty(n, dtype=torch.int32) if medium is not None else None
    maxc = empty(1, dtype=torch.int32) if medium is not None else None
    args = _Args(
        origin_l.data_ptr(), dir_l.data_ptr(), tb.bits.data_ptr(), tb.occw.data_ptr(),
        tb.matb.data_ptr(), _ptr(grid32), tb.wide.data_ptr(), _ptr(vpu_ray), _ptr(oid),
        _ptr(medium), _ptr(ignore), _ptr(seed),
        *(out[k].data_ptr() for k in ("t", "slab_tmin", "slab_tmax", "step_sign", "mat",
                                      "axis", "steps", "entry_axis", "valid", "resolved")),
        _ptr(pend), _ptr(maxc), n, gx, gy, gz, bx, by, bz, tb.bits.numel(),
        int(bool(GLOBAL_BITMAP)), vpu_stride, int(max_steps), int(bool(shadow)), vpu_val)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.vt_dda(ctypes.byref(args), torch.cuda.current_stream(dev).cuda_stream)
    _build.raise_on(lib, err, "dda")
    KERNEL_LAUNCHES["dda"] += 1
    return out
