"""Differentiable emission/absorption integration: host side of
`csrc/diffint.cu`.

Counterpart of `voxel_tracer_tpu/ops/pallas/diffint.py`.  The TPU kernel
`_make_kernel` becomes two hand-written CUDA kernels:

- `integrate_fwd_tiles` (B6): the emission/absorption march over sigma
  and three albedo channels with exact per-voxel segment lengths
  (alpha = 1 - exp(-sigma * dl), `ops/diff.py`), carrying the march state
  (T, Cr, Cg, Cb, D) in and out so z-slabs chain;
- `integrate_bwd_tiles` (B7): the tape-free replay of that march from the
  entering carry and the saved totals, scatter-adding d sigma and
  d albedo into packed gradient tables.

Both kernels read one interleaved record table, (NB*512, 4) float32 of
(sigma, albedo r, g, b) per voxel in `pack_rows`' brick-major order
(`pack_records`), and the backward adds into one gradient record table of
the same shape.  The record-level launchers `integrate_fwd_records` and
`integrate_bwd_records` take and return those tables; the autograd
Functions call them, so a training step packs once and unpacks once.
`integrate_fwd_tiles` / `integrate_bwd_tiles` keep the Pallas interface
(four packed tables in, four gradient tables out) and interleave on entry
and split on exit.

One thread marches one ray: a brick-level Amanatides-Woo DDA walks the
ray's 8^3 bricks in t order (so the TPU kernel's four quadrant passes and
its rect scan are not needed), skips bricks whose `occ_words` bit is 0,
and in an occupied brick steps through its voxels exactly as the Pallas
kernel's per-visit fine march does (`diffint.py:309-422`).  Every ray
that enters the volume is integrated: the k-fighter rays that the TPU
kernel flags (`flags` bit 0) and leaves at their carry do not exist here,
so bit 0 is always 0 and bit 1 marks a ray marched in this call.

The launchers take ray-ordered (N, 3) origins and directions and (N,)
carry and cotangent tensors; the (rows, 128) tiling and the +1e6 padding
rays of the TPU version were for its vector unit.  `tile_rows` and
`interpret` are accepted and ignored.

Each launcher runs its kernel for CUDA tensors and its plain PyTorch
version (`integrate_fwd_plain`, `integrate_bwd_plain`: the same march on
the record table, batched, with `index_add_` in place of the kernel's
vector reductions) for CPU tensors; for a CUDA tensor it launches the
kernel or raises, and never falls back.  `KERNEL_LAUNCHES` counts the
launches of each kernel.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from voxel_tracer_tpu_torch.ops.cuda import _build

BIG = 3e37
LANES = 128
BRICK = 8
BRICK_VOX = BRICK ** 3
FINE_ITERS = 24

KERNEL_LAUNCHES = {"integrate_fwd": 0, "integrate_bwd": 0}


def reset_launch_counts():
    for k in KERNEL_LAUNCHES:
        KERNEL_LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# Table packing (pure permutations)
# ---------------------------------------------------------------------------

def brick_dims(shape_zyx):
    """(BX, BY, BZ) of a (Z, Y, X) grid whose sides are multiples of 8."""
    gz, gy, gx = shape_zyx
    if gx % BRICK or gy % BRICK or gz % BRICK:
        raise ValueError("diffint grids must be multiples of 8 (pad the field)")
    return gx // BRICK, gy // BRICK, gz // BRICK


def pack_rows(field):
    """(Z, Y, X) -> (NB*4, 128) rows: brick b = (bz*BY+by)*BX+bx owns the
    512 consecutive floats of rows [b*4, b*4+4), in-brick index
    z*64 + y*8 + x.  Also the layout of the gradient tables."""
    gz, gy, gx = field.shape
    bx, by, bz = brick_dims(field.shape)
    f = field.reshape(bz, BRICK, by, BRICK, bx, BRICK).permute(0, 2, 4, 1, 3, 5)
    return f.reshape(bx * by * bz * 4, LANES)


def unpack_rows(rows, shape_zyx):
    """Inverse of pack_rows."""
    gz, gy, gx = shape_zyx
    bx, by, bz = brick_dims(shape_zyx)
    f = rows.reshape(bz, by, bx, BRICK, BRICK, BRICK).permute(0, 3, 1, 4, 2, 5)
    return f.reshape(gz, gy, gx)


def pack_records(sigma, albedo):
    """(Z, Y, X) sigma and (Z, Y, X, 3) albedo -> (NB*512, 4) records
    (sigma, albedo r, g, b), brick-major in pack_rows' order: the four
    pack_rows tables stacked on the last axis, in one stack and one
    permute.  Also the layout of the gradient records."""
    bx, by, bz = brick_dims(sigma.shape)
    f = torch.cat([sigma[..., None], albedo], dim=-1)
    f = f.reshape(bz, BRICK, by, BRICK, bx, BRICK, 4).permute(0, 2, 4, 1, 3, 5, 6)
    return f.reshape(bx * by * bz * BRICK_VOX, 4)


def unpack_records(rec, shape_zyx):
    """Inverse of pack_records: (NB*512, 4) -> (Z, Y, X, 4)."""
    gz, gy, gx = shape_zyx
    bx, by, bz = brick_dims(shape_zyx)
    f = rec.reshape(bz, by, bx, BRICK, BRICK, BRICK, 4).permute(0, 3, 1, 4, 2, 5, 6)
    return f.reshape(gz, gy, gx, 4)


def occ_words(sig):
    """Bit-packed brick occupancy of brick-major sigma (pack_rows' rows or
    a record table's column 0): bit b of word b >> 5 is set iff brick b
    holds some sigma > 0.  (NW,) int32 (uint32 bits)."""
    nb = sig.numel() // BRICK_VOX
    occ = sig.reshape(nb, BRICK_VOX).amax(dim=1) > 0.0
    nw = -(-nb // 32)
    occ = torch.cat([occ, occ.new_zeros(nw * 32 - nb)]).reshape(nw, 32)
    shifts = torch.arange(32, device=occ.device)
    words = (occ.to(torch.int64) << shifts).sum(dim=1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def tile_raster(x, height, width, th=32, tw=32):
    """Reorder per-pixel data (H*W, ...) from raster order to th x tw
    pixel-tile order (pure reshape/transpose; numpy arrays or tensors)."""
    rest = tuple(x.shape[1:])
    x = x.reshape(height // th, th, width // tw, tw, *rest).swapaxes(1, 2)
    return x.reshape(height * width, *rest)


def untile_raster(x, height, width, th=32, tw=32):
    """Inverse of tile_raster."""
    rest = tuple(x.shape[1:])
    x = x.reshape(height // th, width // tw, th, tw, *rest).swapaxes(1, 2)
    return x.reshape(height * width, *rest)


def _geometry(bsize, vpu):
    """The march's float32 constants, each rounded once on the host as the
    Pallas kernel's Python floats are, so that the kernel and the plain
    version multiply by the same numbers (and never divide by a scalar)."""
    def f32(v):
        return float(np.float32(v))
    vpu = float(vpu)
    return dict(vpu=f32(vpu), rvpu=f32(1.0 / vpu), bpu=f32(vpu / BRICK),
                rbpu=f32(1.0 / (vpu / BRICK)),
                size=tuple(f32(nb * BRICK / vpu) for nb in bsize))


# ---------------------------------------------------------------------------
# Plain PyTorch version of both kernels
# ---------------------------------------------------------------------------

def _march(quad, occw, origins, dirs, carry, rec, *, bsize, vpu,
           fine_iters, t_eps, bwd=None, stats=None):
    """The kernels' march on the (NB*512, 4) record table, batched over
    rays on any device.

    Returns (T, Cr, Cg, Cb, D, flags).  With ``bwd = (cts, totals, grad)``
    it also replays the gradient formulas of `diffint.py:353-370` and
    `index_add_`s them into the (NB*512, 4) gradient records ``grad``.
    With a ``stats`` dict it adds the brick steps, brick visits (occupied
    bricks marched) and fine steps it took, and the warp-steps
    (`_count_warp_duplicates`)."""
    g = _geometry(bsize, vpu)
    dev = origins.device
    n = origins.shape[0]
    bx, by, bz = bsize
    nb = torch.tensor(bsize, device=dev)
    o, d = origins, dirs

    # volume slab test (diffint.py:147-155)
    rd = torch.clamp(torch.reciprocal(d), -BIG, BIG)
    size = torch.tensor(g["size"], dtype=torch.float32, device=dev)
    t1 = (0.0 - o) * rd
    t2 = (size - o) * rd
    tmin = torch.zeros(n, device=dev)
    tmax = torch.full((n,), BIG, device=dev)
    for a in range(3):
        tmin = torch.maximum(tmin, torch.minimum(t1[:, a], t2[:, a]))
        tmax = torch.minimum(tmax, torch.maximum(t1[:, a], t2[:, a]))
    marched = (tmax - 1e-6) >= tmin
    if quad != 0:                          # dz class of the slab sequencer
        marched &= (d[:, 2] >= 0.0) == (quad > 0)
    flags = marched.to(torch.int32) << 1

    T, Cr, Cg, Cb, D = (c.clone() for c in carry)
    sgn = torch.where(torch.signbit(d), -1, 1)
    stp = (sgn > 0).to(torch.float32)
    dl3 = torch.clamp(torch.abs(rd), max=BIG) * g["rvpu"]
    rbpu = g["rbpu"]

    # first brick: the one holding the slab entry point
    p = o + d * tmin[:, None]
    c = torch.minimum(torch.clamp(torch.floor(p * g["bpu"]), min=0.0),
                      (nb - 1).to(torch.float32)).to(torch.int64)
    alive = marched.clone()
    for _ in range(bx + by + bz + 2):
        alive &= T > t_eps
        if not bool(alive.any()):
            break
        ids = alive.nonzero()[:, 0]
        if stats is not None:
            stats["brick_steps"] = stats.get("brick_steps", 0) + len(ids)
        oi, di, rdi, ci = o[ids], d[ids], rd[ids], c[ids]
        cf = ci.to(torch.float32)
        ta = (cf * rbpu - oi) * rdi
        tb = ((cf + 1.0) * rbpu - oi) * rdi
        near, far = torch.minimum(ta, tb), torch.maximum(ta, tb)
        # [tn, tf] = the ray within this brick's box and [tmin, tmax]
        tn = torch.maximum(torch.maximum(torch.maximum(tmin[ids], near[:, 0]),
                                         near[:, 1]), near[:, 2])
        tf = torch.minimum(torch.minimum(torch.minimum(tmax[ids], far[:, 0]),
                                         far[:, 1]), far[:, 2])
        b = (ci[:, 2] * by + ci[:, 1]) * bx + ci[:, 0]
        occ = (occw[b >> 5].to(torch.int64) >> (b & 31)) & 1
        visit = (tf > tn) & (occ != 0)
        if bool(visit.any()):
            v = visit.nonzero()[:, 0]
            r = ids[v]
            out = _visit(r, oi[v], di[v], rdi[v], cf[v], b[v], tn[v], tf[v],
                         sgn[r], stp[r], dl3[r],
                         (T[r], Cr[r], Cg[r], Cb[r], D[r]), g, rec,
                         fine_iters, t_eps, bwd, stats)
            T[r], Cr[r], Cg[r], Cb[r], D[r] = out
            if stats is not None:
                stats["brick_visits"] = stats.get("brick_visits", 0) + len(v)
        # brick step on the axis of the nearest exit plane, tie rule of
        # diffint.py:404-408
        fx, fy, fz = far.unbind(1)
        use_x = (fx < fy) & (fx < fz)
        use_y = ~(fx < fy) & (fy < fz)
        axis = torch.where(use_x, 0, torch.where(use_y, 1, 2))[:, None]
        f_ax = far.gather(1, axis)[:, 0]
        cn = ci + torch.zeros_like(ci).scatter_(1, axis, sgn[ids].gather(1, axis))
        c[ids] = cn
        alive[ids] = (f_ax < tmax[ids]) & ((cn >= 0) & (cn < nb)).all(dim=1)
    return T, Cr, Cg, Cb, D, flags


def _count_warp_duplicates(stats, rays, idx, nvox):
    """Warp-steps of one fine step: ``rays`` (the live rays' indices) in
    groups of 32 consecutive rays, the lanes of one warp of the kernel.
    Adds the warp-steps, those in which two lanes read (and in the
    backward update) the same voxel, and the lanes a warp-level
    aggregation would merge away (lanes minus distinct voxels)."""
    warp = rays // 32
    lanes = torch.unique(warp, return_counts=True)[1]
    key = torch.unique(warp * nvox + idx)
    distinct = torch.unique(key // nvox, return_counts=True)[1]
    stats["warp_steps"] = stats.get("warp_steps", 0) + len(lanes)
    stats["dup_warp_steps"] = stats.get("dup_warp_steps", 0) + int((lanes > distinct).sum())
    stats["dup_lanes"] = stats.get("dup_lanes", 0) + len(rays) - len(key)


def _visit(rays, o, d, rd, cf, b, tn, tf, sgn, stp, dl3, state, g, rec,
           fine_iters, t_eps, bwd, stats):
    """The fine march of one brick visit per ray (diffint.py:309-422);
    ``rays``: the visiting rays' indices."""
    T, Cr, Cg, Cb, D = state
    enter = torch.clamp(tn, min=0.0)
    fe = ((o + d * enter[:, None]) - cf * g["rbpu"]) * g["vpu"]
    cellf = torch.clamp(torch.floor(fe), 0.0, 7.0)
    cell = cellf.to(torch.int64)
    tm = torch.clamp(((cellf - fe) + stp) * rd * g["rvpu"] + enter[:, None],
                     max=BIG)
    t = enter
    live = torch.ones_like(enter, dtype=torch.bool)
    base = b * BRICK_VOX
    if bwd is not None:
        cts, totals, grad = bwd
        gcr, gcg, gcb, gt, gd = (x[rays] for x in cts)
        ctr, ctg, ctb, tfin, dtot = (x[rays] for x in totals)
        cols = torch.arange(4, device=rec.device)
        grad_flat = grad.view(-1)
    for _ in range(fine_iters):
        if not bool(live.any()):
            break
        bit = (cell[:, 2] * BRICK + cell[:, 1]) * BRICK + cell[:, 0]
        idx = torch.where(live, base + bit, 0)
        if stats is not None:
            stats["fine_steps"] = stats.get("fine_steps", 0) + int(live.sum())
            _count_warp_duplicates(stats, rays[live], idx[live], rec.shape[0])
        sg, ar, ag, ab = rec[idx].unbind(1)
        t_next = torch.minimum(torch.minimum(tm[:, 0], tm[:, 1]),
                               torch.minimum(tm[:, 2], tf))
        dl = torch.clamp(t_next - t, min=0.0)
        e = torch.exp(-torch.clamp(sg, min=0.0) * dl)
        w = torch.where(live, T * (1.0 - e), 0.0)
        seg_d = t + 0.5 * dl
        Cr2, Cg2, Cb2 = Cr + w * ar, Cg + w * ag, Cb + w * ab
        D2 = D + w * seg_d
        if bwd is not None:
            # prefix replayed -> suffix sums from the saved totals
            Te = T * e
            gsig = (gcr * (Te * ar - (ctr - Cr2)) + gcg * (Te * ag - (ctg - Cg2))
                    + gcb * (Te * ab - (ctb - Cb2))
                    + gd * (Te * seg_d - (dtot - D2)) - gt * tfin) * dl
            gsig = torch.where(live & (sg > 0.0), gsig, 0.0)
            vals = torch.stack([gsig, gcr * w, gcg * w, gcb * w], dim=1)
            # each record column adds in ray order, as four tables would
            grad_flat.index_add_(0, (idx[:, None] * 4 + cols).reshape(-1),
                                 vals.reshape(-1))
        Cr, Cg, Cb, D = Cr2, Cg2, Cb2, D2
        T = torch.where(live, T * e, T)
        tmx, tmy, tmz = tm.unbind(1)
        use_x = (tmx < tmy) & (tmx < tmz)
        use_y = ~(tmx < tmy) & (tmy < tmz)
        onehot = torch.stack([use_x, use_y, ~use_x & ~use_y], dim=1)
        cell = cell + torch.where(onehot, sgn, 0)
        tm = tm + torch.where(onehot, dl3, 0.0)
        oob = ((cell < 0) | (cell > 7)).any(dim=1)
        live = live & ~(oob | (t_next >= tf)) & (T > t_eps)
        t = t_next
    return T, Cr, Cg, Cb, D


def integrate_fwd_plain(quad, occw, origins, dirs, carry, rec, *, bsize, vpu,
                        fine_iters=FINE_ITERS, t_eps=0.0, stats=None):
    """Plain PyTorch version of `integrate_fwd_records`, on any device.
    ``stats``: optional dict that receives the march's work on this call's
    data: brick steps, brick visits, fine steps, and warp-steps with and
    without a voxel shared by two lanes (`_count_warp_duplicates`)."""
    T, Cr, Cg, Cb, D, flags = _march(
        int(quad), occw, origins, dirs, carry, rec, bsize=bsize, vpu=vpu,
        fine_iters=fine_iters, t_eps=t_eps, stats=stats)
    return Cr, Cg, Cb, T, D, flags


def integrate_bwd_plain(quad, occw, origins, dirs, carry, rec, cts, totals, *,
                        bsize, vpu, fine_iters=FINE_ITERS, t_eps=0.0):
    """Plain PyTorch version of `integrate_bwd_records`, on any device."""
    grad = torch.zeros(rec.shape, dtype=torch.float32, device=rec.device)
    _march(int(quad), occw, origins, dirs, carry, rec, bsize=bsize, vpu=vpu,
           fine_iters=fine_iters, t_eps=t_eps, bwd=(cts, totals, grad))
    return grad


# ---------------------------------------------------------------------------
# Kernel launchers
# ---------------------------------------------------------------------------

def _lib():
    lib = _build.load("diffint")
    if not getattr(lib, "_vt_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        ptrs = ctypes.POINTER(ctypes.c_void_p)
        common = [p, p, i, ptrs, p, p, ctypes.POINTER(ctypes.c_int),
                  ctypes.POINTER(ctypes.c_float), i, i, f]
        lib.vt_integrate_fwd.argtypes = [*common, ptrs, p, p]
        lib.vt_integrate_fwd.restype = i
        lib.vt_integrate_bwd.argtypes = [*common, ptrs, ptrs, p, p]
        lib.vt_integrate_bwd.restype = i
        lib.vt_error_string.argtypes = [i]
        lib.vt_error_string.restype = ctypes.c_char_p
        lib._vt_typed = True
    return lib


def _ptrs(tensors):
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def _common_args(occw, origins, dirs, carry, rec, bsize, vpu, quad,
                 fine_iters, t_eps):
    """Checks the inputs both kernels share; returns their launch args."""
    dev = origins.device
    n = origins.shape[0]
    nbk = bsize[0] * bsize[1] * bsize[2]
    if n >= 2 ** 31:
        raise ValueError(f"{n} rays: the kernels take fewer than 2**31")
    if quad not in (-1, 0, 1):
        raise ValueError(f"quad must be 0, 1 or -1, not {quad}")
    _build.check("origins", origins, torch.float32, (n, 3), dev)
    _build.check("dirs", dirs, torch.float32, (n, 3), dev)
    for name, t in zip(("T", "Cr", "Cg", "Cb", "D"), carry):
        _build.check(f"carry {name}", t, torch.float32, (n,), dev)
    _build.check("rec", rec, torch.float32, (nbk * BRICK_VOX, 4), dev)
    if rec.data_ptr() % 16:
        raise ValueError("rec is not 16-byte aligned: the kernels read a "
                         "record with one 16-byte load")
    _build.check("occw", occw, torch.int32, (-(-nbk // 32),), dev)
    g = _geometry(bsize, vpu)
    geo = (ctypes.c_float * 7)(g["vpu"], g["rvpu"], g["bpu"], g["rbpu"],
                               *g["size"])
    return [origins.data_ptr(), dirs.data_ptr(), n, _ptrs(carry),
            rec.data_ptr(), occw.data_ptr(), (ctypes.c_int * 3)(*bsize), geo,
            int(quad), int(fine_iters), float(t_eps)]


def integrate_fwd_records(quad, occw, origins, dirs, carry, rec, *, bsize, vpu,
                          fine_iters=FINE_ITERS, t_eps=0.0):
    """B6: march N rays through a (sub)volume of `bsize` bricks.

    quad: 0 (all rays) or +-1 (only rays whose dz >= 0 sign matches: the
    slab sequencer's classes).  occw: `occ_words` of the records' sigma.
    origins, dirs: (N, 3) local space.  carry: (T, Cr, Cg, Cb, D), each
    (N,), the march state entering this (sub)volume.  rec: (NB*512, 4)
    `pack_records` table.  Returns (Cr, Cg, Cb, T, D, flags), each (N,);
    flags bit 1 = marched in this call.
    """
    dev = _build.device_of(origins)
    if dev.type == "cpu":
        return integrate_fwd_plain(quad, occw, origins, dirs, carry, rec,
                                   bsize=bsize, vpu=vpu,
                                   fine_iters=fine_iters, t_eps=t_eps)
    args = _common_args(occw, origins, dirs, carry, rec, bsize, vpu, quad,
                        fine_iters, t_eps)
    n = origins.shape[0]
    out = torch.empty((5, n), dtype=torch.float32, device=dev)
    flags = torch.empty((n,), dtype=torch.int32, device=dev)
    if n > 0:                   # an empty grid is not a valid launch
        lib = _lib()
        with torch.cuda.device(dev):
            err = lib.vt_integrate_fwd(
                *args, _ptrs(list(out)), flags.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        _build.raise_on(lib, err, "integrate_fwd")
        KERNEL_LAUNCHES["integrate_fwd"] += 1
    cr, cg, cb, tr, dp = out
    return cr, cg, cb, tr, dp, flags


def integrate_bwd_records(quad, occw, origins, dirs, carry, rec, cts, totals, *,
                          bsize, vpu, fine_iters=FINE_ITERS, t_eps=0.0):
    """B7: replay the B6 march and accumulate its gradients.

    carry: the march state that entered this (sub)volume in forward order
    (the replay's prefix).  cts: (gCr, gCg, gCb, gT, gD) cotangents;
    totals: the full path's (Cr, Cg, Cb, T_final, D_total); each (N,).
    Returns (NB*512, 4) gradient records (d sigma, d albedo r, g, b).
    """
    dev = _build.device_of(origins)
    if dev.type == "cpu":
        return integrate_bwd_plain(quad, occw, origins, dirs, carry, rec, cts,
                                   totals, bsize=bsize, vpu=vpu,
                                   fine_iters=fine_iters, t_eps=t_eps)
    args = _common_args(occw, origins, dirs, carry, rec, bsize, vpu, quad,
                        fine_iters, t_eps)
    n = origins.shape[0]
    for name, t in zip(("gCr", "gCg", "gCb", "gT", "gD", "Cr", "Cg", "Cb",
                        "T_final", "D_total"), (*cts, *totals)):
        _build.check(name, t, torch.float32, (n,), dev)
    grad = torch.zeros_like(rec)
    if n > 0:
        lib = _lib()
        with torch.cuda.device(dev):
            err = lib.vt_integrate_bwd(
                *args, _ptrs(cts), _ptrs(totals), grad.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        _build.raise_on(lib, err, "integrate_bwd")
        KERNEL_LAUNCHES["integrate_bwd"] += 1
    return grad


def _records_of_tables(tables, bsize, dev):
    """Four packed (NB*4, 128) tables -> (NB*512, 4) records."""
    nbk = bsize[0] * bsize[1] * bsize[2]
    for name, t in zip(("sig_rows", "a0", "a1", "a2"), tables):
        _build.check(name, t, torch.float32, (nbk * 4, LANES), dev)
    return torch.stack([t.reshape(-1) for t in tables], dim=1)


def integrate_fwd_tiles(quad, occw, origins, dirs, carry, sig_rows, a0, a1,
                        a2, *, bsize, vpu, tile_rows=8, fine_iters=FINE_ITERS,
                        t_eps=0.0, interpret=False):
    """B6 on the Pallas interface: `integrate_fwd_records` on the records of
    four packed (NB*4, 128) tables (`pack_rows` of sigma and each albedo
    channel).  Returns (Cr, Cg, Cb, T, D, flags), each (N,)."""
    rec = _records_of_tables((sig_rows, a0, a1, a2), bsize,
                             _build.device_of(origins))
    return integrate_fwd_records(quad, occw, origins, dirs, carry, rec,
                                 bsize=bsize, vpu=vpu, fine_iters=fine_iters,
                                 t_eps=t_eps)


def integrate_bwd_tiles(quad, occw, origins, dirs, carry, sig_rows, a0, a1,
                        a2, cts, totals, *, bsize, vpu, tile_rows=8,
                        fine_iters=FINE_ITERS, t_eps=0.0, interpret=False):
    """B7 on the Pallas interface: `integrate_bwd_records` on four packed
    tables.  Returns (d_sig_rows, d_a0, d_a1, d_a2), packed like the
    tables."""
    rec = _records_of_tables((sig_rows, a0, a1, a2), bsize,
                             _build.device_of(origins))
    grad = integrate_bwd_records(quad, occw, origins, dirs, carry, rec, cts,
                                 totals, bsize=bsize, vpu=vpu,
                                 fine_iters=fine_iters, t_eps=t_eps)
    return tuple(grad.t().reshape(4, -1, LANES))


# ---------------------------------------------------------------------------
# Differentiable renderers (ops/diff.render_density drop-ins on B6/B7)
# ---------------------------------------------------------------------------

def _pack_tables(sigma, albedo):
    """The four packed tables `integrate_fwd_tiles` takes."""
    return tuple(pack_rows(f).contiguous() for f in
                 (sigma, albedo[..., 0], albedo[..., 1], albedo[..., 2]))


def _init_carry(n, device):
    one = torch.ones(n, device=device)
    zero = torch.zeros(n, device=device)
    return (one, zero, zero, zero, zero)


def _cotangents(g_color, g_trans, g_depth):
    return tuple(x.float().contiguous() for x in
                 (g_color[:, 0], g_color[:, 1], g_color[:, 2], g_trans, g_depth))


def _unpack_grads(grad, shape):
    """Gradient records -> (d sigma (Z, Y, X), d albedo (Z, Y, X, 3))."""
    g = unpack_records(grad, shape)
    return g[..., 0], g[..., 1:]


def _rays(origin_l, dir_l):
    return (origin_l.detach().float().contiguous(),
            dir_l.detach().float().contiguous())


class _Mega(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sigma, albedo, origin_l, dir_l, vpu, t_eps):
        bsize = brick_dims(sigma.shape)
        rec = pack_records(sigma, albedo)
        occ = occ_words(rec[:, 0])
        o, d = _rays(origin_l, dir_l)
        cr, cg, cb, tr, dp, fl = integrate_fwd_records(
            0, occ, o, d, _init_carry(o.shape[0], o.device), rec,
            bsize=bsize, vpu=vpu, t_eps=t_eps)
        ctx.save_for_backward(o, d, occ, rec, cr, cg, cb, tr, dp)
        ctx.args = (bsize, vpu, t_eps, tuple(sigma.shape))
        flags = fl & 1
        ctx.mark_non_differentiable(flags)
        return torch.stack([cr, cg, cb], dim=-1), tr, dp, flags

    @staticmethod
    def backward(ctx, g_color, g_trans, g_depth, _g_flags):
        o, d, occ, rec, *totals = ctx.saved_tensors
        bsize, vpu, t_eps, shape = ctx.args
        grad = integrate_bwd_records(
            0, occ, o, d, _init_carry(o.shape[0], o.device), rec,
            _cotangents(g_color, g_trans, g_depth), tuple(totals),
            bsize=bsize, vpu=vpu, t_eps=t_eps)
        return (*_unpack_grads(grad, shape), None, None, None, None)


def render_density_mega(sigma, albedo, origin_l, dir_l, vpu,
                        tile_rows: int = 8, t_eps: float = 0.0,
                        interpret: bool = False):
    """Kernel-backed emission/absorption rendering: `diff.render_density`
    semantics on B6, with a backward on B7.

    sigma (Z, Y, X) float32, albedo (Z, Y, X, 3), sides multiples of 8;
    rays local-space (N, 3); vpu a Python float.  Returns a dict of color
    (N, 3), trans (N,), depth (N,) and flags (N,), 0 everywhere: the port
    integrates every ray (see the module docstring).  `tile_rows` and
    `interpret` are accepted and ignored."""
    color, trans, depth, flags = _Mega.apply(sigma, albedo, origin_l, dir_l,
                                             float(vpu), float(t_eps))
    return {"color": color, "trans": trans, "depth": depth, "flags": flags}


def _slab_inputs(rec, o, vpu, n_slabs, bsize):
    """Per slab: its origins (z shifted into the slab's frame), records
    and occupancy words."""
    bx, by, bz = bsize
    if bz % n_slabs:
        raise ValueError(f"{bz} Z bricks do not split into {n_slabs} slabs")
    sub = (bx, by, bz // n_slabs)
    nv = bx * by * sub[2] * BRICK_VOX
    z_step = sub[2] * BRICK / float(vpu)
    out = []
    for s in range(n_slabs):
        o_s = o.clone()
        o_s[:, 2] = o[:, 2] - s * z_step
        r = rec[s * nv:(s + 1) * nv]
        out.append((o_s, r, occ_words(r[:, 0])))
    return sub, out


class _Slabs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sigma, albedo, origin_l, dir_l, vpu, n_slabs, t_eps):
        bsize = brick_dims(sigma.shape)
        rec = pack_records(sigma, albedo)
        o, d = _rays(origin_l, dir_l)
        sub, slabs = _slab_inputs(rec, o, vpu, n_slabs, bsize)
        finals, entries = {}, {}
        for cls in (1, -1):
            state = _init_carry(o.shape[0], o.device)
            ent = [None] * n_slabs
            order = range(n_slabs) if cls > 0 else range(n_slabs - 1, -1, -1)
            for s in order:
                ent[s] = state
                o_s, r, occ = slabs[s]
                cr, cg, cb, tr, dp, _ = integrate_fwd_records(
                    cls, occ, o_s, d, state, r, bsize=sub, vpu=vpu,
                    t_eps=t_eps)
                state = (tr, cr, cg, cb, dp)
            finals[cls], entries[cls] = state, ent
        # each ray marched in exactly one dz class: merge by its own sign
        pos = d[:, 2] >= 0.0
        T, Cr, Cg, Cb, D = (torch.where(pos, a, b)
                            for a, b in zip(finals[1], finals[-1]))
        saved = [x for cls in (1, -1) for ent in entries[cls] for x in ent]
        ctx.save_for_backward(o, d, rec, Cr, Cg, Cb, T, D, *saved)
        ctx.args = (bsize, vpu, n_slabs, t_eps, tuple(sigma.shape))
        flags = torch.zeros_like(T, dtype=torch.int32)
        ctx.mark_non_differentiable(flags)
        return torch.stack([Cr, Cg, Cb], dim=-1), T, D, flags

    @staticmethod
    def backward(ctx, g_color, g_trans, g_depth, _g_flags):
        o, d, rec, *rest = ctx.saved_tensors
        totals, saved = tuple(rest[:5]), rest[5:]
        bsize, vpu, n_slabs, t_eps, shape = ctx.args
        entries = {cls: [tuple(saved[(k * n_slabs + s) * 5:
                                     (k * n_slabs + s + 1) * 5])
                         for s in range(n_slabs)]
                   for k, cls in enumerate((1, -1))}
        sub, slabs = _slab_inputs(rec, o, vpu, n_slabs, bsize)
        cts = _cotangents(g_color, g_trans, g_depth)
        grads = []
        for s, (o_s, r, occ) in enumerate(slabs):
            # gradients add across the two dz classes; slabs own disjoint rows
            g1, g2 = (integrate_bwd_records(cls, occ, o_s, d, entries[cls][s],
                                            r, cts, totals, bsize=sub,
                                            vpu=vpu, t_eps=t_eps)
                      for cls in (1, -1))
            grads.append(g1 + g2)
        return (*_unpack_grads(torch.cat(grads), shape), None, None, None, None,
                None)


def render_density_slabs(sigma, albedo, origin_l, dir_l, vpu,
                         n_slabs: int = 8, tile_rows: int = 8,
                         t_eps: float = 0.0, interpret: bool = False):
    """`render_density_mega` as a chain of `n_slabs` z-slab kernel calls
    with the march state carried ray-wise between them: one chain per dz
    class (+z order and -z order), merged by each ray's own sign, so
    composition stays t-ordered; the backward replays each slab from its
    saved entry state.  On the TPU this kept each call's tables within
    VMEM; on the card one call holds a 128^3 grid, so the trainer uses it
    only when asked for more than one slab.  `tile_rows` and `interpret`
    are accepted and ignored."""
    color, trans, depth, flags = _Slabs.apply(
        sigma, albedo, origin_l, dir_l, float(vpu), int(n_slabs),
        float(t_eps))
    return {"color": color, "trans": trans, "depth": depth, "flags": flags}
