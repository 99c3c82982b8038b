"""Coherent-kernel first-hit tracer: host side of `csrc/coherent.cu`.

Counterpart of `voxel_tracer_tpu/ops/pallas/coherent.py`, the kernel
renderer's hot path.  The TPU kernel (`_make_kernel`, launched by
`trace_coherent`) marches 1024-ray tiles through brick slices along the
tile's major axis, walks each slice's rect of bricks as scalars and
broadcasts an occupied brick's 16 words to all lanes; rays that fight the
tile's major axis or overflow the rect budget come back unresolved.  Here
one thread walks one ray's 8^3 bricks in t order (the brick-level
Amanatides-Woo walk of `csrc/diffint.cu`: each brick's [tn, tf] from its
own planes, the step on the axis of the nearest exit plane) and applies
the TPU kernel's per-brick arithmetic to every occupied brick it crosses
(`coherent.py:241-356`): the brick-AABB slab test, the `tf - 1e-5 >=
enter` crossing rule, the fine entry clipped to [0, 7], the first-cell
axis, up to 24 fine Amanatides-Woo steps.  The first hit in t order ends
the ray.  With no tile there are no fighting rays and no rect budget:
`resolved` is 0 only for a walk that ran out of steps without a hit or an
exit, which a well-formed ray cannot do.

Contract kept from the JAX function: t = `BIG` on a miss, vox = flat index
into the grid padded to whole bricks (-1 on a miss), ax = axis * 2 +
(step sign > 0) on a hit and the kernel's placeholder entry_axis * 4 on a
miss.  `steps` counts the fine steps taken in occupied bricks up to the
hit; the TPU count depends on its tiles' rect order and pruning, so it is
comparable with this module's plain version only.

Options of the JAX function that tune the TPU tiles are left out:
`max_bricks_per_tile`, `fine_iters` (24, enough for any 8^3 crossing),
`tile_rows` and `interpret`; N need not be a multiple of 1024.

`trace_coherent` runs the kernel for CUDA tensors and its plain PyTorch
version (`trace_coherent_plain`, the same float32 program batched over
rays) for CPU tensors; for a CUDA tensor it launches the kernel or raises.
`KERNEL_LAUNCHES` counts the launches.

The kernel tests a brick's occupancy in a bitmap (`brick_bits`, built
once per volume beside the flags).  A volume's launch arguments (bitmap,
table pointers, geometry floats, device) are built once and kept on its
``occ`` tensor, rebuilt when ``occ`` is edited in place or another
``words``, ``bsize`` or ``vpu`` comes with it; a call then checks the
rays, makes one (4, N) allocation and one (N,) bool allocation, and
launches once, on the current stream.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from voxel_tracer_tpu_torch.ops.cuda import _build
from voxel_tracer_tpu_torch.ops.cuda.diffint import _geometry
from voxel_tracer_tpu_torch.ops.cuda.mega import brick_bytes, occupancy_words
from voxel_tracer_tpu_torch.ops.dda import _fma

BIG = 3e37
BRICK = 8
FINE_ITERS = 24

KERNEL_LAUNCHES = {"coherent": 0}


def reset_launch_counts():
    for k in KERNEL_LAUNCHES:
        KERNEL_LAUNCHES[k] = 0


class PackedVolume(NamedTuple):
    """Brick tables of one volume on a device.  Brick index
    b = (bz * BY + by) * BX + bx; bit i = z*64 + y*8 + x of a brick is bit
    i % 32 of its word i // 32."""

    occ: torch.Tensor     # (NB,) int32: 1 if the brick holds a solid voxel
    words: torch.Tensor   # (NB, 16) int32 (uint32 bits), brick-major
    bsize: tuple          # (BX, BY, BZ)
    vpu: float


def brick_bits(occ: torch.Tensor) -> torch.Tensor:
    """(NB,) brick flags -> int32 (uint32 bits) bitmap on the flags'
    device: bit b % 32 of word b // 32 is set iff occ[b] != 0; the words
    are padded with zeros to a multiple of 4 (whole 16-byte rows)."""
    flags = (occ.reshape(-1) != 0).to(torch.int64)
    nw = -(-flags.numel() // 128) * 4
    flags = torch.nn.functional.pad(flags, (0, nw * 32 - flags.numel()))
    shifts = torch.arange(32, device=occ.device)
    words = (flags.reshape(nw, 32) << shifts).sum(dim=1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def pack_volume(grid: np.ndarray, vpu: float, device="cuda") -> PackedVolume:
    """(Z, Y, X) uint8 grid -> brick occupancy and bit words (the JAX
    `pack_volume` words transposed to one 64-byte row per brick); the
    kernel's brick bitmap and launch arguments are built here and kept on
    ``occ``."""
    matb, bsize = brick_bytes(grid)
    words = occupancy_words(matb)
    occ = torch.tensor((words != 0).any(axis=1).astype(np.int32), device=device)
    words = torch.tensor(words, device=device)
    _launch_args(occ, words, bsize, vpu, occ.device)
    return PackedVolume(occ=occ, words=words, bsize=bsize, vpu=float(vpu))


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------

def _slab(o, rd, size):
    """Volume slab entry (coherent.py:116-133): tmin, tmax, entry_axis."""
    n = o.shape[0]
    dev = o.device
    tmin = torch.zeros(n, device=dev)
    tmax = torch.full((n,), BIG, device=dev)
    entry_axis = torch.zeros(n, dtype=torch.int32, device=dev)
    for a in range(3):
        t1 = (0.0 - o[:, a]) * rd[:, a]
        t2 = (size[a] - o[:, a]) * rd[:, a]
        tn = torch.minimum(t1, t2)
        tf = torch.maximum(t1, t2)
        tn = torch.where(torch.isnan(tn), -BIG, tn)
        tf = torch.where(torch.isnan(tf), BIG, tf)
        entry_axis = torch.where(tn > tmin, a, entry_axis)
        tmin = torch.maximum(tmin, tn)
        tmax = torch.minimum(tmax, tf)
    return tmin, tmax, entry_axis


def _brick_box(o, rd, cf, rbpu):
    """Per-brick slab test (coherent.py:241-261): per-axis [lo, hi], the
    box's [tn, tf] from tn = 0, and the axis of its entry face."""
    b0 = cf * rbpu
    t1 = (b0 - o) * rd
    t2 = ((b0 + rbpu) - o) * rd
    lo = torch.minimum(t1, t2)
    hi = torch.maximum(t1, t2)
    lo = torch.where(torch.isnan(lo), -BIG, lo)
    hi = torch.where(torch.isnan(hi), BIG, hi)
    tn = torch.zeros_like(lo[:, 0])
    tf = torch.full_like(lo[:, 0], BIG)
    b_ax = torch.zeros(lo.shape[0], dtype=torch.int32, device=lo.device)
    for a in range(3):
        b_ax = torch.where(lo[:, a] > tn, a, b_ax)
        tn = torch.maximum(tn, lo[:, a])
        tf = torch.minimum(tf, hi[:, a])
    return b0, hi, tn, tf, b_ax


def _fine(o, d, rd, sgn, stp, dl, b0, enter, ax0, w16, g):
    """Fine Amanatides-Woo pass of one brick per ray (coherent.py:265-356).
    Returns (hit mask, hit ft, hit cell (n, 3), hit axis, cells tested,
    capped: neither hit nor left the brick in FINE_ITERS steps)."""
    n = o.shape[0]
    fe = (_fma(d, enter[:, None], o) - b0) * g["vpu"]
    cell = torch.clamp(torch.floor(fe).to(torch.int32), 0, 7)
    tm = ((cell.to(torch.float32) - fe) + stp) * rd
    tm = torch.clamp(torch.where(torch.isnan(tm), BIG, tm), max=BIG)
    ft = torch.zeros_like(enter)
    ax = ax0
    live = torch.ones(n, dtype=torch.bool, device=o.device)
    hit = torch.zeros_like(live)
    h_ft = torch.zeros_like(enter)
    h_cell = torch.zeros_like(cell)
    h_ax = torch.zeros_like(ax0)
    tested = torch.zeros(n, dtype=torch.int32, device=o.device)
    rows = torch.arange(n, device=o.device)
    for _ in range(FINE_ITERS):
        if not bool(live.any()):
            break
        bit = torch.where(live, cell[:, 2] * 64 + cell[:, 1] * 8 + cell[:, 0],
                          0).long()
        word = w16[rows, bit >> 5].to(torch.int64)
        is_hit = live & (((word >> (bit & 31)) & 1) == 1)
        hit |= is_hit
        h_ft = torch.where(is_hit, ft, h_ft)
        h_cell = torch.where(is_hit[:, None], cell, h_cell)
        h_ax = torch.where(is_hit, ax, h_ax)
        tested += live.to(torch.int32)
        live = live & ~is_hit
        # A&W step, reference comparison order
        tx, ty, tz = tm.unbind(1)
        use_x = (tx < ty) & (tx < tz)
        use_y = ~(tx < ty) & (ty < tz)
        axis = torch.where(use_x, 0, torch.where(use_y, 1, 2))
        onehot = torch.nn.functional.one_hot(axis, 3).bool()
        cell = cell + torch.where(onehot, sgn, 0)
        ft = torch.gather(tm, 1, axis[:, None])[:, 0]
        tm = tm + torch.where(onehot, dl, 0.0)
        ax = axis.to(torch.int32)
        live = live & ~((cell < 0) | (cell > 7)).any(dim=1)
    return hit, h_ft, h_cell, h_ax, tested, live


def _count(stats, key, n):
    if stats is not None:
        stats[key] = stats.get(key, 0) + int(n)


def trace_coherent_plain(occ, words, o_l, d_l, bsize, vpu, stats=None):
    """Plain PyTorch version of `trace_coherent`, on any device: the
    kernel's per-ray walk in lock step over compacted rays.  ``stats``:
    optional dict that receives the walk's brick steps, brick visits
    (occupied bricks crossed) and fine steps."""
    g = _geometry(bsize, vpu)
    dev = o_l.device
    n = o_l.shape[0]
    bx, by, bz = bsize
    nb3 = torch.tensor(bsize, device=dev)
    o, d = o_l, d_l
    rd = torch.clamp(torch.reciprocal(d), -BIG, BIG)
    tmin, tmax, entry_axis = _slab(o, rd, g["size"])
    valid = (tmax - 1e-4) >= tmin

    sgn = torch.where(torch.signbit(d), -1, 1).to(torch.int32)
    stp = (sgn > 0).to(torch.float32)
    dl = torch.clamp(torch.abs(rd), max=BIG)

    t = torch.full((n,), BIG, device=dev)
    vox = torch.full((n,), -1, dtype=torch.int32, device=dev)
    ax = entry_axis * 4
    steps = torch.zeros(n, dtype=torch.int32, device=dev)
    resolved = torch.ones(n, dtype=torch.bool, device=dev)

    # first brick: the one holding the slab entry point
    fb = _fma(d, tmin[:, None], o) * g["bpu"]
    c = torch.minimum(torch.clamp(torch.floor(fb).to(torch.int64), min=0),
                      nb3 - 1)
    alive = valid.clone()
    for _ in range(bx + by + bz + 2):
        ids = alive.nonzero()[:, 0]
        if ids.numel() == 0:
            break
        _count(stats, "brick_steps", ids.numel())
        oi, di, rdi, ci = o[ids], d[ids], rd[ids], c[ids]
        b0, hi, tn, tf, b_ax = _brick_box(oi, rdi, ci.to(torch.float32),
                                          g["rbpu"])
        enter = torch.maximum(tn, tmin[ids])
        b = (ci[:, 2] * by + ci[:, 1]) * bx + ci[:, 0]
        cross = (occ[b] > 0) & (tf - 1e-5 >= enter)
        hit_any = torch.zeros_like(cross)
        if bool(cross.any()):
            v = cross.nonzero()[:, 0]
            r = ids[v]
            first = enter[v] <= tmin[r] + 1e-12
            ax0 = torch.where(first, entry_axis[r], b_ax[v])
            hit, h_ft, h_cell, h_ax, tested, capped = _fine(
                oi[v], di[v], rdi[v], sgn[r], stp[r], dl[r], b0[v],
                enter[v], ax0, words[b[v]], g)
            steps[r] += tested
            _count(stats, "brick_visits", v.numel())
            _count(stats, "fine_steps", tested.sum())
            resolved[r[capped]] = False
            h = hit.nonzero()[:, 0]
            rh = r[h]
            t[rh] = _fma(h_ft[h], torch.tensor(g["rvpu"], device=dev),
                         enter[v][h])
            cv = ci[v][h] * BRICK + h_cell[h]
            vox[rh] = ((cv[:, 2] * (by * BRICK) + cv[:, 1]) * (bx * BRICK)
                       + cv[:, 0]).to(torch.int32)
            sa = torch.gather(sgn[rh], 1, h_ax[h].long()[:, None])[:, 0]
            ax[rh] = h_ax[h] * 2 + (sa > 0).to(torch.int32)
            hit_any[v] = hit | capped
        # brick step on the axis of the nearest exit plane
        hx, hy, hz = hi.unbind(1)
        use_x = (hx < hy) & (hx < hz)
        use_y = ~(hx < hy) & (hy < hz)
        axis = torch.where(use_x, 0, torch.where(use_y, 1, 2))[:, None]
        f_ax = hi.gather(1, axis)[:, 0]
        cn = ci + torch.zeros_like(ci).scatter_(1, axis, sgn[ids].gather(1, axis).long())
        c[ids] = cn
        alive[ids] = (~hit_any & (f_ax < tmax[ids])
                      & ((cn >= 0) & (cn < nb3)).all(dim=1))
    resolved &= ~alive          # the walk ran out of bricks: not reachable
    return dict(t=t, vox=vox, ax=ax, steps=steps, resolved=resolved)


# ---------------------------------------------------------------------------
# Kernel launcher
# ---------------------------------------------------------------------------

class _Params(ctypes.Structure):
    """coherent.cu's CoherentParams (occ and nwords are read by the design
    trials of tools/torch_coherent_trials.py)."""
    _fields_ = [("bits", ctypes.c_void_p), ("occ", ctypes.c_void_p),
                ("words", ctypes.c_void_p), ("nb", ctypes.c_int * 3),
                ("geo", ctypes.c_float * 7), ("nwords", ctypes.c_int),
                ("device", ctypes.c_int)]


class _Launch(NamedTuple):
    key: tuple              # (occ version, bsize, vpu, device) it was built for
    words: torch.Tensor
    bits: torch.Tensor
    params: _Params
    addr: int               # address of params


def _launch_args(occ, words, bsize, vpu, device) -> _Launch:
    """The volume's launch arguments, kept on ``occ`` (attribute
    `_vt_coherent`) and rebuilt when ``occ`` was edited in place or
    ``words``, ``bsize``, ``vpu`` or the device differ; the tables are
    checked when they are built."""
    key = (occ._version, tuple(bsize), vpu, device)
    la = getattr(occ, "_vt_coherent", None)
    if la is not None and la.words is words and la.key == key:
        return la
    nb = bsize[0] * bsize[1] * bsize[2]
    _build.check("occ", occ, torch.int32, (nb,), device)
    _build.check("words", words, torch.int32, (nb, 16), device)
    bits = brick_bits(occ)
    g = _geometry(bsize, vpu)
    params = _Params(bits.data_ptr(), occ.data_ptr(), words.data_ptr(),
                     (ctypes.c_int * 3)(*bsize),
                     (ctypes.c_float * 7)(g["vpu"], g["rvpu"], g["bpu"], g["rbpu"],
                                          *g["size"]),
                     bits.numel(), device.index or 0)
    la = _Launch(key, words, bits, params, ctypes.addressof(params))
    occ._vt_coherent = la
    return la


def _lib():
    lib = _build.load("coherent")
    if not getattr(lib, "_vt_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.vt_coherent.argtypes = [p, p, p, i, p, p, p]
        lib.vt_coherent.restype = i
        lib.vt_error_string.argtypes = [i]
        lib.vt_error_string.restype = ctypes.c_char_p
        lib._vt_typed = True
    return lib


def trace_coherent(occ, words, o_l, d_l, bsize, vpu):
    """B5: first hit of N volume-local rays (o_l, d_l: (N, 3) float32).

    occ, words: a `PackedVolume`'s tables on the rays' device.  Returns a
    dict of (N,) tensors: t (BIG = miss), vox (flat voxel index of the
    brick-padded grid, -1 = miss), ax (axis*2 + step sign > 0; entry
    axis * 4 on a miss), steps, resolved (bool).  On the card t, vox, ax
    and steps are rows of one (4, N) allocation."""
    dev = _build.device_of(o_l)
    if dev.type == "cpu":
        return trace_coherent_plain(occ, words, o_l, d_l, bsize, vpu)
    n = o_l.shape[0]
    _build.check("o_l", o_l, torch.float32, (n, 3), dev)
    _build.check("d_l", d_l, torch.float32, (n, 3), dev)
    if n >= 2 ** 31:
        raise ValueError(f"{n} rays: the kernel takes fewer than 2**31")
    la = _launch_args(occ, words, bsize, vpu, dev)
    out = torch.empty((4, n), dtype=torch.int32, device=dev)
    res = torch.empty((n,), dtype=torch.bool, device=dev)
    if n > 0:                   # an empty grid is not a valid launch
        lib = _lib()
        # the current stream's handle, without building a Stream object
        stream = torch._C._cuda_getCurrentRawStream(dev.index)
        err = lib.vt_coherent(la.addr, o_l.data_ptr(), d_l.data_ptr(), n,
                              out.data_ptr(), res.data_ptr(), stream)
        _build.raise_on(lib, err, "coherent")
        KERNEL_LAUNCHES["coherent"] += 1
    t, vox, ax, steps = out.unbind(0)
    return dict(t=t.view(torch.float32), vox=vox, ax=ax, steps=steps, resolved=res)
