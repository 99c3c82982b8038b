"""Independent two-level DDA frame and ray-list tracer: host side of
`csrc/indep.cu`.

Counterpart of `voxel_tracer_tpu/ops/pallas/indep.py`, the `render_mega`
twin that `tools/sweep.py` sweeps.  The TPU kernel (`_make_indep_kernel`,
launched by `render_indep_tiles` and `trace_rays_indep`) lets each lane
march its own brick-level DDA over the broadcast brick bitmap (at most
4096 bricks, 128 words) and resolves occupied bricks and materials in
min-vote rounds over the tile.  Here one thread runs one ray's walk: the
brick-level Amanatides-Woo DDA in brick units from the slab entry
(`indep.py:140-169`, `:302-328`), and for each occupied brick the fine
pass of `indep.py:171-273` (enter = tmin + bft / bpu, t = enter +
h_ft / vpu).  `steps` counts brick steps and fine steps, as the JAX
kernel's `track_steps` does.  A thread has no vote rounds to overflow:
`resolved` is 0 only for a walk that ran out of steps without a hit or an
exit, which a well-formed ray cannot do; the JAX kernel can leave rays of
a tile that meets more than `vote_rounds` bricks unresolved.

This is indep's float program, not B1's (`ops/dda.py` computes t and steps
differently), so the two kernels' outputs differ by rounding and in
`steps`.  Outputs are in image order with `render_mega`'s dict keys and
`aux` layout; on a miss, ax = entry_axis * 2.

Options of the JAX functions that tune the TPU tiles are left out:
`tile_rows`, `tile_w`, `fine_iters` (24), `vote_rounds`, `fine_unroll`,
`track_steps` (steps are always counted) and `interpret`.

Each wrapper runs its kernel for CUDA tensors and its plain PyTorch
version (`*_plain`) for CPU tensors; for a CUDA tensor it launches the
kernel or raises.  `KERNEL_LAUNCHES` counts the launches.
"""

from __future__ import annotations

import ctypes

import torch

from voxel_tracer_tpu_torch.models.scene import SUN_DIR
from voxel_tracer_tpu_torch.ops.cuda import _build
from voxel_tracer_tpu_torch.ops.cuda.coherent import BIG, _count, _fine, _slab
from voxel_tracer_tpu_torch.ops.cuda.diffint import _geometry
from voxel_tracer_tpu_torch.ops.cuda.mega import (AUX_AX_SHIFT,
                                                  AUX_RESOLVED_SHIFT,
                                                  AUX_STEPS_SHIFT, _SHADING,
                                                  _SKY, MegaTables,
                                                  MegaVolume, _camera_rays,
                                                  _trace_dict, _unpack_rgb8,
                                                  mega_camera, shade_frame)
from voxel_tracer_tpu_torch.ops.dda import _fma

MAX_BRICKS = 4096   # the bitmap's 128 words (indep.py:53)

KERNEL_LAUNCHES = {"indep_camera": 0, "indep_rays": 0}


def reset_launch_counts():
    for k in KERNEL_LAUNCHES:
        KERNEL_LAUNCHES[k] = 0


def _check_bricks(nb):
    if nb > MAX_BRICKS:
        raise ValueError(f"indep traversal supports <= {MAX_BRICKS} bricks, "
                         f"got {nb}")


def pack_brickbits(occ: torch.Tensor) -> torch.Tensor:
    """(NB,) brick occupancy flags -> (128,) int32 (uint32 bits) bitmap on
    the flags' device: bit b % 32 of word b // 32 is brick b's flag."""
    flags = occ.reshape(-1).to(torch.int64) & 1
    nb = flags.numel()
    _check_bricks(nb)
    idx = torch.arange(nb, device=flags.device)
    words = torch.zeros(128, dtype=torch.int64, device=flags.device)
    words.index_add_(0, idx >> 5, flags << (idx & 31))
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def occb_of(tables: MegaTables) -> torch.Tensor:
    """Brick bitmap of a MegaTables bundle."""
    return pack_brickbits(tables.bocc)


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def _bit(occb, b):
    return ((occb[b >> 5].to(torch.int64) >> (b & 31)) & 1) == 1


def _walk(o, d, occb, tables: MegaTables, stats=None):
    """The kernel's per-ray walk in lock step over compacted rays.
    Returns (t with BIG on a miss, aux).  ``stats``: optional dict that
    receives the brick steps, brick visits and fine steps."""
    bsize = tables.bsize
    g = _geometry(bsize, tables.vpu)
    dev = o.device
    n = o.shape[0]
    bx, by, bz = bsize
    nb3 = torch.tensor(bsize, device=dev)
    rd = torch.clamp(torch.reciprocal(d), -BIG, BIG)
    tmin, tmax, entry_axis = _slab(o, rd, g["size"])
    valid = (tmax - 1e-4) >= tmin
    sgn = torch.where(torch.signbit(d), -1, 1).to(torch.int32)
    stp = (sgn > 0).to(torch.float32)
    dl = torch.clamp(torch.abs(rd), max=BIG)

    # brick-level DDA from the entry point, in brick units (indep.py:140-169)
    fb = _fma(d, tmin[:, None], o) * g["bpu"]
    cb = torch.minimum(torch.clamp(torch.floor(fb).to(torch.int64), min=0),
                       nb3 - 1)
    bt = ((cb.to(torch.float32) - fb) + stp) * rd
    bt = torch.clamp(torch.where(torch.isnan(bt), BIG, bt), max=BIG)
    bft = torch.zeros(n, device=dev)
    bax = entry_axis.clone()
    t = torch.full((n,), BIG, device=dev)
    mat = torch.zeros(n, dtype=torch.int32, device=dev)
    ax = entry_axis * 2
    steps = torch.zeros(n, dtype=torch.int32, device=dev)
    resolved = torch.ones(n, dtype=torch.int32, device=dev)
    rbpu = torch.tensor(g["rbpu"], device=dev)
    rvpu = torch.tensor(g["rvpu"], device=dev)
    live = valid.clone()
    for _ in range(bx + by + bz + 2):
        ids = live.nonzero()[:, 0]
        if ids.numel() == 0:
            break
        ci = cb[ids]
        b = (ci[:, 2] * by + ci[:, 1]) * bx + ci[:, 0]
        occ = _bit(occb, b)
        if bool(occ.any()):
            # fine pass of each occupied brick (indep.py:171-273)
            v = occ.nonzero()[:, 0]
            r = ids[v]
            enter = _fma(bft[r], rbpu, tmin[r])
            b0 = ci[v].to(torch.float32) * g["rbpu"]
            ax0 = torch.where(bft[r] <= 1e-12, entry_axis[r], bax[r])
            hit, h_ft, h_cell, h_ax, tested, capped = _fine(
                o[r], d[r], rd[r], sgn[r], stp[r], dl[r], b0, enter, ax0,
                tables.occw[b[v]], g)
            steps[r] += tested
            _count(stats, "brick_visits", v.numel())
            _count(stats, "fine_steps", tested.sum())
            resolved[r[capped]] = 0             # not reachable
            live[r[capped]] = False
            h = hit.nonzero()[:, 0]
            rh = r[h]
            t[rh] = _fma(h_ft[h], rvpu, enter[h])
            bit = (h_cell[h, 2] * 64 + h_cell[h, 1] * 8 + h_cell[h, 0]).long()
            mat[rh] = tables.matb[b[v][h], bit].to(torch.int32)
            sa = torch.gather(sgn[rh], 1, h_ax[h].long()[:, None])[:, 0]
            ax[rh] = h_ax[h] * 2 + (sa > 0).to(torch.int32)
            live[rh] = False
            ids = live.nonzero()[:, 0]
            if ids.numel() == 0:
                break
            ci = cb[ids]
        # one brick step for every still-live ray (indep.py:302-328)
        _count(stats, "brick_steps", ids.numel())
        bti = bt[ids]
        tx, ty, tz = bti.unbind(1)
        use_x = (tx < ty) & (tx < tz)
        use_y = ~(tx < ty) & (ty < tz)
        axis = torch.where(use_x, 0, torch.where(use_y, 1, 2))
        onehot = torch.nn.functional.one_hot(axis, 3).bool()
        cn = ci + torch.where(onehot, sgn[ids], 0)
        bft[ids] = torch.gather(bti, 1, axis[:, None])[:, 0]
        bt[ids] = bti + torch.where(onehot, dl[ids], 0.0)
        bax[ids] = axis.to(torch.int32)
        steps[ids] += 1
        cb[ids] = torch.minimum(torch.clamp(cn, min=0), nb3 - 1)
        live[ids] = ((cn >= 0) & (cn < nb3)).all(dim=1)
    resolved[live] = 0          # the walk ran out of bricks: not reachable
    aux = (mat | (ax << AUX_AX_SHIFT) | (resolved << AUX_RESOLVED_SHIFT)
           | (torch.clamp(steps, max=0x7ffff) << AUX_STEPS_SHIFT))
    return t, aux


def render_indep_tiles_plain(cam, occb, tables: MegaTables, *, width, height,
                             sky_mode="analytic", shading="flat",
                             ambient=0.2, stats=None):
    """Plain PyTorch version of `render_indep_tiles`, on any device
    (``stats``: see `_walk`)."""
    o, d = _camera_rays(cam, width, height)
    t, aux = _walk(o, d, occb, tables, stats)
    return shade_frame(cam, tables.pal, d, t, aux, width=width, height=height,
                       sky_mode=sky_mode, shading=shading, ambient=ambient)


def trace_rays_indep_plain(o_l, d_l, occb, tables: MegaTables, stats=None):
    """Plain PyTorch version of `trace_rays_indep`, on any device
    (``stats``: see `_walk`)."""
    return _trace_dict(*_walk(o_l, d_l, occb, tables, stats))


# ---------------------------------------------------------------------------
# Kernel launchers
# ---------------------------------------------------------------------------

def _lib():
    lib = _build.load("indep")
    if not getattr(lib, "_vt_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        ip, fp = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float)
        vol = [p, p, p, ip, fp]
        lib.vt_indep_camera.argtypes = [p, p, *vol, i, i, i, i, f, p, p, p, p]
        lib.vt_indep_camera.restype = i
        lib.vt_indep_rays.argtypes = [p, p, i, *vol, p, p, p]
        lib.vt_indep_rays.restype = i
        lib.vt_error_string.argtypes = [i]
        lib.vt_error_string.restype = ctypes.c_char_p
        lib._vt_typed = True
    return lib


def _volume_args(occb, tables: MegaTables, device):
    nb = tables.bsize[0] * tables.bsize[1] * tables.bsize[2]
    _build.check("occb", occb, torch.int32, (128,), device)
    _build.check("occw", tables.occw, torch.int32, (nb, 16), device)
    _build.check("matb", tables.matb, torch.uint8, (nb, 512), device)
    g = _geometry(tables.bsize, tables.vpu)
    geo = (ctypes.c_float * 7)(g["vpu"], g["rvpu"], g["bpu"], g["rbpu"],
                               *g["size"])
    return [occb.data_ptr(), tables.occw.data_ptr(), tables.matb.data_ptr(),
            (ctypes.c_int * 3)(*tables.bsize), geo]


def render_indep_tiles(cam, occb, tables: MegaTables, *, width, height,
                       sky_mode="analytic", shading="flat", ambient=0.2):
    """B3: fused frame via the independent two-level DDA.  Returns (rgba
    int32, t float32, aux int32), each (height, width) in image order, as
    `mega.render_mega_tiles` does.

    cam: the (29,) float32 tensor of `mega.camera_params`; occb: the
    (128,) brick bitmap (`occb_of`); shading 'flat', 'lambert', 'raw' or
    'trace'; sky_mode 'analytic', 'constant' or 'none'."""
    shade_code, sky_code = _SHADING[shading], _SKY[sky_mode]
    _check_bricks(len(tables.bocc))
    dev = _build.device_of(cam)
    if dev.type == "cpu":
        return render_indep_tiles_plain(cam, occb, tables, width=width,
                                        height=height, sky_mode=sky_mode,
                                        shading=shading, ambient=ambient)
    _build.check("cam", cam, torch.float32, (29,), dev)
    _build.check("pal", tables.pal, torch.float32, (256, 3), dev)
    vol = _volume_args(occb, tables, dev)
    rgba = torch.empty((height, width), dtype=torch.int32, device=dev)
    t = torch.empty((height, width), dtype=torch.float32, device=dev)
    aux = torch.empty((height, width), dtype=torch.int32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.vt_indep_camera(
            cam.data_ptr(), tables.pal.data_ptr(), *vol, width, height,
            shade_code, sky_code, float(ambient), rgba.data_ptr(),
            t.data_ptr(), aux.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.raise_on(lib, err, "indep_camera")
    KERNEL_LAUNCHES["indep_camera"] += 1
    return rgba, t, aux


def trace_rays_indep(o_l, d_l, occb, tables: MegaTables):
    """B4: first hit of N local-space rays (o_l, d_l: (N, 3) float32) via
    the independent two-level DDA.  Returns a dict of (N,) tensors: t (BIG
    = miss), mat, ax (axis*2 + step sign > 0; entry_axis*2 on a miss),
    steps (brick + fine), resolved."""
    _check_bricks(len(tables.bocc))
    dev = _build.device_of(o_l)
    if dev.type == "cpu":
        return trace_rays_indep_plain(o_l, d_l, occb, tables)
    n = o_l.shape[0]
    _build.check("o_l", o_l, torch.float32, (n, 3), dev)
    _build.check("d_l", d_l, torch.float32, (n, 3), dev)
    if n >= 2 ** 31:
        raise ValueError(f"{n} rays: the kernel takes fewer than 2**31")
    vol = _volume_args(occb, tables, dev)
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    aux = torch.empty((n,), dtype=torch.int32, device=dev)
    if n > 0:                   # an empty grid is not a valid launch
        lib = _lib()
        with torch.cuda.device(dev):
            err = lib.vt_indep_rays(
                o_l.data_ptr(), d_l.data_ptr(), n, *vol, t.data_ptr(),
                aux.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        _build.raise_on(lib, err, "indep_rays")
        KERNEL_LAUNCHES["indep_rays"] += 1
    return _trace_dict(t, aux)


def render_indep(mv: MegaVolume, camera, width, height, *, sun_dir=None,
                 sun_scale=1.0, sky_mode="analytic", shading="flat",
                 ambient=0.2, sky_const=(0.0, 0.0, 0.0)):
    """Fused flat/lambert frame via the independent DDA (`render_mega`
    twin: the same AOV dict).  The brick bitmap is derived from the
    volume's tables and cached on ``mv``."""
    if getattr(mv, "_occb_src", None) is not mv.tables:
        mv._occb = occb_of(mv.tables)
        mv._occb_src = mv.tables
    sd = SUN_DIR if sun_dir is None else sun_dir
    cam_p = mega_camera(mv, camera, sd, width, height, sun_scale, sky_const)
    rgba, t, aux = render_indep_tiles(cam_p, mv._occb, mv.tables,
                                      width=width, height=height,
                                      sky_mode=sky_mode, shading=shading,
                                      ambient=ambient)
    return dict(
        image=_unpack_rgb8(rgba).to(torch.uint8),
        depth=t,
        mat=aux & 255,
        steps=(aux >> AUX_STEPS_SHIFT) & 0x7ffff,
        resolved=(aux >> AUX_RESOLVED_SHIFT) & 1,
    )
