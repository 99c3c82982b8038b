"""Fused primary-ray frame and ray-list tracer: host side of `csrc/mega.cu`.

Counterpart of `voxel_tracer_tpu/ops/pallas/mega.py`.  The TPU kernel
(`_make_mega_kernel`, launched by `render_mega_tiles` and `trace_rays`)
becomes one hand-written CUDA kernel with two launchers:

- `render_mega_tiles`: camera raygen, slab test, two-level DDA first hit,
  material byte, palette albedo, flat / lambert / raw / trace shading,
  analytic or constant sky, ACES and RGBA8 in one pass;
- `trace_rays`: first hit of arbitrary volume-local rays.

Each wrapper runs the kernel for CUDA tensors and its plain PyTorch
version (`ops/dda.py` plus tensor shading, in this module) for CPU
tensors; for a CUDA tensor it launches the kernel or raises, and never
falls back.  Outputs keep the JAX package's contracts: miss depth `BIG`,
the `aux` bit layout below, the same dict keys.  They are in image order
(the TPU kernel's square-tile order was a VPU tactic).  Every ray
resolves, so `resolved` is 0 only where the shared 256-step budget ran
out; such a ray is a miss, as in `ops/dda.py`.

Options of the JAX functions that only tune the TPU traversal are left
out: `traversal`, `tile_rows`, `tile_w`, `max_bricks_per_tile`,
`fine_iters`, `fine_unroll`, `word_gather`, `track_steps` (steps are
always counted), `mat16`, `brick`, `mat_bsize`, `slice_depth`,
`conv_rows`, `sub_skip`, `matw_space`, `mat_rounds`, `footprint`,
`interpret`, `fetch_mat` of the camera frame (materials are fetched
unless shading is 'trace'), and for the lit frame `shadow_tile_rows`, `use_brick16`,
`use_hier3`, `use_hier3p`, `use_brick32`, `shadow_slice_depth` and
`shadow_block`.  The lit frame's temporal reprojection (`prev_accu`,
`prev_planes`, `depth_delta`) runs as the JAX kernel path's does, on any
width and height (the port has no tile padding).

The kernel reads the brick flags as a bitmap (`MegaTables.bitmap`, built
once by `pack_tables`) through the read-only path.

`KERNEL_LAUNCHES` counts the launches of each kernel.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from voxel_tracer_tpu_torch.models.camera import primary_rays
from voxel_tracer_tpu_torch.models.scene import SUN_DIR, SUN_LIGHT
from voxel_tracer_tpu_torch.ops import dda
from voxel_tracer_tpu_torch.ops.composite import _to_local
from voxel_tracer_tpu_torch.ops.cuda import _build
from voxel_tracer_tpu_torch.ops.math3d import BIG_F32, rigid_inverse_point
from voxel_tracer_tpu_torch.ops.tonemap import aces_approx as _aces

BIG = 3e37          # miss depth of the kernel outputs (BIG_F32 inside the DDA)
BRICK = 8

# aux word layout (mega.py:45-50): mat (8b) | ax (3b) | resolved (1b) |
# steps (19b), where ax = axis * 2 + (step sign > 0): the sign is bit 8 and
# the axis bits 9-10
AUX_MAT_SHIFT = 0
AUX_AX_SHIFT = 8
AUX_RESOLVED_SHIFT = 11
AUX_STEPS_SHIFT = 12

SKY_ZENITH = (0.35, 0.45, 0.65)
SKY_HORIZON = (0.85, 0.65, 0.45)
SKY_BASE = (0.08, 0.08, 0.10)
SKY_SUNCOL = (1.0, 0.9, 0.75)

_SHADING = {"flat": 0, "lambert": 1, "raw": 2, "trace": 3}
_SKY = {"analytic": 0, "constant": 1, "none": 2}

KERNEL_LAUNCHES = {"mega_camera": 0, "mega_rays": 0}


def reset_launch_counts():
    for k in KERNEL_LAUNCHES:
        KERNEL_LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# Tables
# ---------------------------------------------------------------------------

class MegaTables(NamedTuple):
    """Device tables of one volume.

    The kernel reads `bitmap`, `occw`, `matb` and `pal`; the plain version
    reads `grid`, `brick_occ` and `pal`.  Occupancy (`bitmap`, `occw`,
    `bocc`, `brick_occ`) and materials (`matb`) are separate, so a table
    set may mark other voxels solid than the nonzero ones (`pack_tables`'
    ``occupied``); its plain `grid` then holds 256 | id on solid voxels
    and 0 elsewhere, and the material is the low byte.  Brick index
    b = (bz * BY + by) * BX + bx; voxel index inside a brick
    i = z * 64 + y * 8 + x (vv.h:23-38); bit i of the brick's 512-bit
    occupancy is bit i % 32 of word i // 32, and brick b's flag is bit
    b % 32 of bitmap word b // 32.
    """

    bocc: torch.Tensor       # (NB,) int32, 1 where the brick holds a solid voxel
    bitmap: torch.Tensor     # (ceil(NB / 32),) int32 (uint32 bits) brick flags
    occw: torch.Tensor       # (NB, 16) int32 (uint32 bits) occupancy words
    matb: torch.Tensor       # (NB, 512) uint8 material bytes
    grid: torch.Tensor       # (Z, Y, X) uint8 material ids (int32 256 | id
                             # where ``occupied`` differs from id != 0)
    brick_occ: torch.Tensor  # (BZ, BY, BX) int32 solid count per brick
    pal: torch.Tensor        # (256, 3) float32 palette albedo
    bsize: tuple             # (BX, BY, BZ)
    gsize: tuple             # (GX, GY, GZ)
    vpu: float


def brick_bytes(grid: np.ndarray):
    """(Z, Y, X) uint8 grid -> ((NB, 512) uint8 material bytes, (BX, BY,
    BZ)), the grid zero-padded to whole 8^3 bricks, brick-major."""
    grid = np.asarray(grid, np.uint8)
    gz, gy, gx = grid.shape
    bx, by, bz = (gx + 7) // 8, (gy + 7) // 8, (gz + 7) // 8
    pad = np.zeros((bz * 8, by * 8, bx * 8), np.uint8)
    pad[:gz, :gy, :gx] = grid
    # (bz, 8, by, 8, bx, 8) -> (brick, z, y, x) -> (NB, 512) bytes
    matb = pad.reshape(bz, 8, by, 8, bx, 8).transpose(0, 2, 4, 1, 3, 5)
    return np.ascontiguousarray(matb.reshape(bx * by * bz, 512)), (bx, by, bz)


def occupancy_words(matb: np.ndarray) -> np.ndarray:
    """(NB, 512) material bytes -> (NB, 16) int32 (uint32 bits): bit i % 32
    of word i // 32 is set iff voxel i is solid."""
    bits = np.packbits(matb != 0, axis=1, bitorder="little")   # (NB, 64) bytes
    return bits.view("<u4").astype(np.uint32).view(np.int32)


def brick_bitmap(bocc: np.ndarray) -> np.ndarray:
    """(NB,) brick flags -> (ceil(NB / 32),) int32 (uint32 bits): bit b % 32
    of word b // 32 is set iff bocc[b] != 0."""
    flags = np.asarray(bocc).reshape(-1) != 0
    nw = (flags.size + 31) // 32
    bits = np.zeros(nw * 32, bool)
    bits[:flags.size] = flags
    words = np.packbits(bits.reshape(nw, 32), axis=1, bitorder="little")
    return words.view("<u4").astype(np.uint32).view(np.int32).reshape(nw)


def pack_tables(grid: np.ndarray, palette: np.ndarray, vpu: float,
                device="cuda", occupied: np.ndarray = None) -> MegaTables:
    """Pack a (Z, Y, X) uint8 grid and its palette for the kernel and the
    plain version (the layout spec is `pack_mega` of the JAX package).

    occupied: optional (Z, Y, X) bool grid of the voxels a ray stops at,
    in place of grid != 0, while the material read at the hit stays the
    grid's byte; e.g. grid != g, the inverted tables of glass id g whose
    first solid voxel is a ray's exit from the medium.  It is zero-padded
    to whole bricks like the grid."""
    grid = np.ascontiguousarray(grid, np.uint8)
    gz, gy, gx = grid.shape
    matb, (bx, by, bz) = brick_bytes(grid)
    if occupied is None:
        occ_b, plain = matb, grid
    else:
        occupied = np.asarray(occupied, bool)
        occ_b = brick_bytes(occupied.astype(np.uint8))[0]
        plain = np.where(occupied, grid.astype(np.int32) | 256, 0).astype(np.int32)
    occw = occupancy_words(occ_b)                                 # (NB, 16)
    bocc = (occw != 0).any(axis=1).astype(np.int32)
    brick_occ = occ_b.astype(bool).sum(axis=1, dtype=np.int32).reshape(bz, by, bx)
    return MegaTables(
        bocc=torch.tensor(bocc, device=device),
        bitmap=torch.tensor(brick_bitmap(bocc), device=device),
        occw=torch.tensor(occw, device=device),
        matb=torch.tensor(matb, device=device),
        grid=torch.tensor(plain, device=device),
        brick_occ=torch.tensor(brick_occ, device=device),
        pal=torch.tensor(np.asarray(palette, np.float32), device=device),
        bsize=(bx, by, bz),
        gsize=(gx, gy, gz),
        vpu=float(vpu),
    )


def _bit32(k):
    """Bit k of a word stored as int32 (uint32 bits): bit 31 is the sign."""
    return -(1 << 31) if k == 31 else 1 << k


def set_voxel_tables(tb: MegaTables, x, y, z, val, occupied=None):
    """Edit one voxel of packed tables in place, without a repack (the
    counterpart of `set_voxel_tables` in the JAX package, mega.py:449-506):
    its material byte, its occupancy bit, the brick's flag and bitmap bit,
    the plain grid and the brick's solid count.  Every step is a device
    op on the tables' device: no host sync, no allocation of a table.

    occupied: whether the voxel stops a ray (default val != 0), as
    `pack_tables`' ``occupied``; the plain grid then holds 256 | val on an
    occupied voxel and 0 elsewhere.  Table shapes never change, so a
    reference to the tables taken before the edit sees it."""
    x, y, z, val = int(x), int(y), int(z), int(val)
    solid = val != 0 if occupied is None else bool(occupied)
    plain = val if occupied is None else (256 | val if solid else 0)
    bx, by = tb.bsize[0], tb.bsize[1]
    b = ((z >> 3) * by + (y >> 3)) * bx + (x >> 3)
    i = ((z & 7) << 6) | ((y & 7) << 3) | (x & 7)
    bit = _bit32(i & 31)
    word = tb.occw[b, i >> 5]                     # views: edits land in the table
    was = (word >> (i & 31)) & 1
    if solid:
        word.bitwise_or_(bit)
    else:
        word.bitwise_and_(~bit)
    tb.matb[b, i] = val & 255
    tb.grid[z, y, x] = plain
    tb.brick_occ[z >> 3, y >> 3, x >> 3].add_(int(solid) - was)
    flag = tb.bocc[b]
    flag.copy_((tb.occw[b] != 0).any())
    bw = _bit32(b & 31)
    tb.bitmap[b >> 5].bitwise_and_(~bw).bitwise_or_(flag * bw)


class MegaVolume:
    """A volume packed for the kernel on ``device``, plus its transform.

    The rigid transform (`rot`, `pos`, `pivot`) stays in float32 CPU
    tensors: camera parameters are computed on the host.
    """

    def __init__(self, volume, device="cuda"):
        self.volume = volume
        self.device = torch.device(device)
        self.refresh()

    def set_voxel(self, x: int, y: int, z: int, val: int):
        """O(1) edit of one voxel (vv.cpp:377-432; JAX `MegaVolume.set_voxel`,
        mega.py:2649-2670): the host volume, then the device tables in
        place."""
        self.volume.set_voxel(x, y, z, val)
        set_voxel_tables(self.tables, x, y, z, val)

    def refresh(self):
        """Re-pack after bulk edits of the host volume (a model reload,
        enemy.cpp:60-63) or a change of its transform."""
        v = self.volume
        self.tables = pack_tables(v.grid, v.palette, v.vpu, self.device)
        self.rot = torch.tensor(v.rot, dtype=torch.float32)
        self.pos = torch.tensor(v.pos, dtype=torch.float32)
        self.pivot = torch.tensor(v.pivot, dtype=torch.float32)


# ---------------------------------------------------------------------------
# Camera parameters
# ---------------------------------------------------------------------------

def camera_params(cam_local, rot, sun_dir, sun_scale, sky_const, width,
                  height):
    """Pack camera + shading scalars into the kernel's 29 floats.

    cam_local: (pos_l, tl_l, tr_l, bl_l) in volume-local space.
    rot: (3,3) local->world. Layout: [0:3] pos, [3:6] tl, [6:9] ddx,
    [9:12] ddy, [12:21] rot row-major, [21:24] sun dir, [24] unused,
    [25] sun scale, [26:29] constant sky color.
    """
    def f32(v):
        if isinstance(v, torch.Tensor):
            return v.detach().to("cpu", torch.float32).clone()
        return torch.tensor(np.array(v, np.float32))

    pos_l, tl_l, tr_l, bl_l = (f32(v) for v in cam_local)
    ddx = (tr_l - tl_l) / width
    ddy = (bl_l - tl_l) / height
    return torch.cat([
        pos_l, tl_l, ddx, ddy, f32(rot).reshape(9), f32(sun_dir).reshape(3),
        torch.zeros(1), f32([sun_scale]), f32(sky_const).reshape(3),
    ])


def mega_camera(mv: MegaVolume, camera, sun_dir, width, height,
                sun_scale=1.0, sky_const=(0.0, 0.0, 0.0)):
    """World camera -> the 29 kernel floats in the volume's local frame,
    on the volume's device."""
    def to_local_pt(p):
        return rigid_inverse_point(mv.rot, mv.pos, mv.pivot,
                                   torch.as_tensor(p, dtype=torch.float32))

    cam_local = tuple(to_local_pt(p) for p in
                      (camera.pos, camera.tl, camera.tr, camera.bl))
    return camera_params(cam_local, mv.rot, sun_dir, sun_scale, sky_const,
                         width, height).to(mv.device)


# ---------------------------------------------------------------------------
# Shading formulas (shared by the plain version and the lit frame)
# ---------------------------------------------------------------------------

def _analytic_sky(dw, sun):
    """SkyDome.procedural formula at exact directions (skydome.py).

    dw, sun: 3-sequences of tensors or floats.  Returns [r, g, b]."""
    y = dw[1]
    cos_sun = dw[0] * sun[0] + dw[1] * sun[1] + dw[2] * sun[2]
    horizon = torch.exp(-torch.abs(y) * 3.0)
    zenith = torch.clamp(y, 0.0, 1.0)
    c2 = torch.clamp(cos_sun, 0.0, 1.0)
    g2 = c2 * c2
    g4 = g2 * g2
    g8 = g4 * g4
    g16 = g8 * g8
    glow = g16 * g16
    disk = torch.clamp((cos_sun - 0.9995) * 2000.0, 0.0, 1.0)
    disk = disk * disk
    lum = 25.0 * disk + 0.6 * glow
    out = []
    for c in range(3):
        v = (SKY_ZENITH[c] * zenith + SKY_HORIZON[c] * horizon + SKY_BASE[c]
             + lum * SKY_SUNCOL[c])
        out.append(torch.sqrt(torch.clamp(v, min=0.0)) * 0.65)
    return out


def _to8(v):
    return torch.clamp(v * 255.0 + 0.5, 0.0, 255.0).to(torch.int32)


def _unpack_rgb8(rgba):
    return torch.stack([(rgba >> s) & 255 for s in (0, 8, 16)], dim=-1)


# ---------------------------------------------------------------------------
# Plain PyTorch versions of the two kernel entries
# ---------------------------------------------------------------------------

def _trace_aux(tables: MegaTables, o_l, d_l, fetch_mat):
    """(t with BIG on a miss, aux) of local rays through the DDA twin."""
    r = dda.intersect_volume_local(tables.grid, tables.brick_occ, o_l, d_l,
                                   tables.vpu)
    hit = r["t"] < BIG_F32
    axis = r["axis"].long()
    sign_pos = (torch.gather(r["step_sign"], 1, axis[:, None])[:, 0] > 0)
    ax = torch.where(hit, r["axis"] * 2 + sign_pos.to(torch.int32),
                     r["entry_axis"] * 2)
    mat = r["mat"] & 255 if fetch_mat else torch.zeros_like(r["mat"])
    aux = (mat | (ax << AUX_AX_SHIFT)
           | (r["resolved"].to(torch.int32) << AUX_RESOLVED_SHIFT)
           | (torch.clamp(r["steps"], max=0x7ffff) << AUX_STEPS_SHIFT))
    t = torch.where(hit, r["t"], BIG)
    return t, aux


def _trace_dict(t, aux):
    return dict(
        t=t,
        mat=(aux >> AUX_MAT_SHIFT) & 255,
        ax=(aux >> AUX_AX_SHIFT) & 7,
        steps=(aux >> AUX_STEPS_SHIFT) & 0x7ffff,
        resolved=((aux >> AUX_RESOLVED_SHIFT) & 1).bool(),
    )


def trace_rays_plain(o_l, d_l, tables: MegaTables, *, fetch_mat=False):
    """Plain PyTorch version of `trace_rays`, on any device."""
    return _trace_dict(*_trace_aux(tables, o_l, d_l, fetch_mat))


def _camera_rays(cam, width, height):
    """Local-space rays of the kernel's raygen: tl + px*ddx + py*ddy - pos,
    no half-pixel offset, normalised by 1/sqrt (mega.py:743-748)."""
    dev = cam.device
    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=dev),
        torch.arange(width, dtype=torch.float32, device=dev), indexing="ij")
    xs, ys = xs.reshape(-1), ys.reshape(-1)
    e = [cam[3 + a] + xs * cam[6 + a] + ys * cam[9 + a] - cam[a]
         for a in range(3)]
    # PyTorch's CPU float32 sqrt is not correctly rounded (about 0.7 % of
    # results are an ulp off); the float64 root rounded to float32 is, like
    # the kernel's sqrtf, so the rays agree on every device
    n2 = e[0] * e[0] + e[1] * e[1] + e[2] * e[2]
    rn = torch.reciprocal(torch.sqrt(n2.double()).float())
    d = torch.stack([ea * rn for ea in e], dim=-1)
    o = torch.broadcast_to(cam[0:3], d.shape).contiguous()
    return o, d


def render_mega_tiles_plain(cam, tables: MegaTables, *, width, height,
                            sky_mode="analytic", shading="flat", ambient=0.2):
    """Plain PyTorch version of `render_mega_tiles`, on any device."""
    o, d = _camera_rays(cam, width, height)
    t, aux = _trace_aux(tables, o, d, fetch_mat=shading != "trace")
    return shade_frame(cam, tables.pal, d, t, aux, width=width, height=height,
                       sky_mode=sky_mode, shading=shading, ambient=ambient)


def shade_frame(cam, pal, d, t, aux, *, width, height, sky_mode, shading,
                ambient):
    """The camera kernels' shading tail on traced camera rays (d: local
    directions, t with BIG on a miss, aux): (rgba, t, aux), each
    (height, width)."""
    shp = (height, width)
    if shading == "trace":
        return torch.zeros_like(aux).reshape(shp), t.reshape(shp), aux.reshape(shp)
    hit = t < BIG
    mat = (aux & 255).long()
    ax = (aux >> AUX_AX_SHIFT) & 7
    alb = pal[mat]
    if shading == "lambert":
        # N = -step sign on the hit axis, rotated to world (mega.py:2408-2419)
        k = (ax >> 1).long()
        sgn = torch.where((ax & 1) == 1, -1.0, 1.0)
        ndl = (cam[12 + k] * cam[21] + cam[15 + k] * cam[22]
               + cam[18 + k] * cam[23]) * sgn
        irr = torch.clamp(ndl, min=0.0) * cam[25] + ambient
        alb = alb * irr[:, None]
    if sky_mode == "analytic":
        # world dir = R d_local (mega.py:2426-2431)
        dx, dy, dz = d.unbind(-1)
        dw = [cam[12 + 3 * r] * dx + cam[13 + 3 * r] * dy + cam[14 + 3 * r] * dz
              for r in range(3)]
        sky = torch.stack(_analytic_sky(dw, cam[21:24]), dim=-1)
    elif sky_mode == "constant":
        sky = torch.broadcast_to(cam[26:29], alb.shape)
    else:
        sky = torch.zeros_like(alb)
    rgb = torch.where(hit[:, None], alb, sky)
    c8 = _to8(rgb if shading == "raw" else _aces(rgb))
    rgba = c8[:, 0] | (c8[:, 1] << 8) | (c8[:, 2] << 16) | -(1 << 24)
    return rgba.reshape(shp), t.reshape(shp), aux.reshape(shp)


# ---------------------------------------------------------------------------
# Kernel launchers
# ---------------------------------------------------------------------------

def _lib():
    lib = _build.load("mega")
    if not getattr(lib, "_vt_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        vol = [p, p, p, i, i, i, i, i, i, f, i]
        lib.vt_mega_camera.argtypes = [p, p, *vol, i, i, i, i, f, p, p, p, p]
        lib.vt_mega_camera.restype = i
        lib.vt_mega_rays.argtypes = [p, p, i, *vol, i, p, p, p]
        lib.vt_mega_rays.restype = i
        lib.vt_error_string.argtypes = [i]
        lib.vt_error_string.restype = ctypes.c_char_p
        lib._vt_typed = True
    return lib


def _volume_args(tables: MegaTables, device):
    bx, by, bz = tables.bsize
    gx, gy, gz = tables.gsize
    nb = bx * by * bz
    _build.check("bitmap", tables.bitmap, torch.int32, ((nb + 31) // 32,), device)
    _build.check("occw", tables.occw, torch.int32, (nb, 16), device)
    _build.check("matb", tables.matb, torch.uint8, (nb, 512), device)
    _build.check("pal", tables.pal, torch.float32, (256, 3), device)
    return [tables.bitmap.data_ptr(), tables.occw.data_ptr(),
            tables.matb.data_ptr(), bx, by, bz, gx, gy, gz, tables.vpu,
            dda.MAX_STEPS]


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

def render_mega_tiles(cam, tables: MegaTables, *, width, height,
                      sky_mode="analytic", shading="flat", ambient=0.2):
    """Fused frame.  Returns (rgba int32, t float32, aux int32), each
    (height, width) in image order.

    cam: the (29,) float32 tensor of `camera_params` on the tables' device.
    shading: 'flat' (albedo), 'lambert' (N.L sun + ambient, no shadows),
    'raw' (albedo8, no tonemap) or 'trace' (rgba 0).  sky_mode:
    'analytic', 'constant' (cam[26:29]) or 'none' (black).
    """
    shade_code, sky_code = _SHADING[shading], _SKY[sky_mode]
    dev = _build.device_of(cam)
    if dev.type == "cpu":
        return render_mega_tiles_plain(cam, tables, width=width,
                                       height=height, sky_mode=sky_mode,
                                       shading=shading, ambient=ambient)
    _build.check("cam", cam, torch.float32, (29,), dev)
    vol = _volume_args(tables, dev)
    rgba = torch.empty((height, width), dtype=torch.int32, device=dev)
    t = torch.empty((height, width), dtype=torch.float32, device=dev)
    aux = torch.empty((height, width), dtype=torch.int32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.vt_mega_camera(
            cam.data_ptr(), tables.pal.data_ptr(), *vol, width, height,
            shade_code, sky_code, float(ambient), rgba.data_ptr(),
            t.data_ptr(), aux.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.raise_on(lib, err, "mega_camera")
    KERNEL_LAUNCHES["mega_camera"] += 1
    return rgba, t, aux


def trace_rays(o_l, d_l, tables: MegaTables, *, fetch_mat=False):
    """First hit of N local-space rays (o_l, d_l: (N, 3) float32).

    The ray-list twin of `render_mega_tiles`, for shadow rays and bounce
    wavefronts.  Returns a dict of (N,) tensors: t (BIG = miss), mat (0
    unless fetch_mat), ax (axis*2 + step-sign>0), steps, resolved.
    """
    dev = _build.device_of(o_l)
    if dev.type == "cpu":
        return trace_rays_plain(o_l, d_l, tables, fetch_mat=fetch_mat)
    n = o_l.shape[0]
    _build.check("o_l", o_l, torch.float32, (n, 3), dev)
    _build.check("d_l", d_l, torch.float32, (n, 3), dev)
    if n >= 2 ** 31:
        raise ValueError(f"{n} rays: the kernel takes fewer than 2**31")
    vol = _volume_args(tables, dev)
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    aux = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:                  # an empty grid is not a valid launch
        return _trace_dict(t, aux)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.vt_mega_rays(
            o_l.data_ptr(), d_l.data_ptr(), n, *vol, int(bool(fetch_mat)),
            t.data_ptr(), aux.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.raise_on(lib, err, "mega_rays")
    KERNEL_LAUNCHES["mega_rays"] += 1
    return _trace_dict(t, aux)


def render_mega(mv: MegaVolume, camera, width, height, *, sun_dir=None,
                sun_scale=1.0, sky_mode="analytic", shading="flat",
                ambient=0.2, sky_const=(0.0, 0.0, 0.0)):
    """Fully fused flat/lambert frame (RGB8 image + depth/mat/steps AOVs)."""
    return _mega_frame(mv, camera, width, height, sun_dir, sun_scale,
                       sky_mode, shading, ambient, sky_const,
                       render_mega_tiles)


def render_mega_plain(mv: MegaVolume, camera, width, height, *, sun_dir=None,
                      sun_scale=1.0, sky_mode="analytic", shading="flat",
                      ambient=0.2, sky_const=(0.0, 0.0, 0.0)):
    """Plain PyTorch version of `render_mega`, on any device."""
    return _mega_frame(mv, camera, width, height, sun_dir, sun_scale,
                       sky_mode, shading, ambient, sky_const,
                       render_mega_tiles_plain)


def _mega_frame(mv, camera, width, height, sun_dir, sun_scale, sky_mode,
                shading, ambient, sky_const, tiles_fn):
    sd = SUN_DIR if sun_dir is None else sun_dir
    cam_p = mega_camera(mv, camera, sd, width, height, sun_scale, sky_const)
    rgba, t, aux = tiles_fn(cam_p, mv.tables, width=width, height=height,
                            sky_mode=sky_mode, shading=shading,
                            ambient=ambient)
    return dict(
        image=_unpack_rgb8(rgba).to(torch.uint8),
        depth=t,
        mat=(aux >> AUX_MAT_SHIFT) & 255,
        steps=(aux >> AUX_STEPS_SHIFT) & 0x7ffff,
        resolved=(aux >> AUX_RESOLVED_SHIFT) & 1,
    )


def render_lambert_mega(mv: MegaVolume, camera, width, height, *,
                        sun_dir=None, sun_light=None, ambient=0.2,
                        prev_accu=None, prev_planes=None, depth_delta=0.0):
    """Sun + shadow-ray lambert frame (materials.cpp:226-244 semantics,
    minus sphere lights): a fused raw-albedo primary pass, a ray-list
    shadow pass through `trace_rays`, then tensor shading and tonemap.

    Shadow rays start at the hit point offset by 1e-4 along the normal;
    back-facing and missed pixels park theirs at 1e6, outside the volume;
    a pixel is occluded only if its shadow ray hits and is resolved.

    prev_accu (H, W, 4) + prev_planes (4, 4): temporal reprojection
    (renderer.cpp:273-329) blends 95 % irradiance history with depth
    rejection and returns the new accumulator as out["accu"]; pass this
    frame's ``camera.planes`` as the next frame's prev_planes.
    """
    return _lambert_frame(mv, camera, width, height, sun_dir, sun_light,
                          ambient, render_mega_tiles, trace_rays,
                          prev_accu, prev_planes, depth_delta)


def render_lambert_mega_plain(mv: MegaVolume, camera, width, height, *,
                              sun_dir=None, sun_light=None, ambient=0.2,
                              prev_accu=None, prev_planes=None,
                              depth_delta=0.0):
    """Plain PyTorch version of `render_lambert_mega`, on any device."""
    return _lambert_frame(mv, camera, width, height, sun_dir, sun_light,
                          ambient, render_mega_tiles_plain, trace_rays_plain,
                          prev_accu, prev_planes, depth_delta)


def _lambert_frame(mv, camera, width, height, sun_dir, sun_light, ambient,
                   tiles_fn, trace_fn, prev_accu=None, prev_planes=None,
                   depth_delta=0.0):
    dev = mv.device
    sd = torch.tensor(np.array(SUN_DIR if sun_dir is None else sun_dir,
                               np.float32))
    sl = torch.tensor(np.array(SUN_LIGHT if sun_light is None else sun_light,
                               np.float32), device=dev)
    cam_p = mega_camera(mv, camera, sd, width, height)

    # pass 1: fused primary rays -> raw albedo8 + depth + mat/axis
    rgba, t, aux = tiles_fn(cam_p, mv.tables, width=width, height=height,
                            sky_mode="none", shading="raw")
    rgba, t, aux = rgba.reshape(-1), t.reshape(-1), aux.reshape(-1)
    hit = t < BIG
    alb = _unpack_rgb8(rgba).to(torch.float32) / 255.0
    ax = (aux >> AUX_AX_SHIFT) & 7
    sgn = torch.where((ax & 1) == 1, -1.0, 1.0)     # normal = -step sign
    rot, pos, pivot = (v.to(dev) for v in (mv.rot, mv.pos, mv.pivot))
    normal = rot.T[(ax >> 1).long()] * sgn[:, None]   # local axis -> world

    ys, xs = torch.meshgrid(torch.arange(height, dtype=torch.float32, device=dev),
                            torch.arange(width, dtype=torch.float32, device=dev),
                            indexing="ij")
    origins, dirs = primary_rays(camera, xs, ys, width, height)
    origins, dirs = origins.reshape(-1, 3), dirs.reshape(-1, 3)

    # pass 2: shadow rays toward the sun from offset hit points
    sd = sd.to(dev)
    incidence = torch.sum(normal * sd, dim=-1)
    need_shadow = hit & (incidence > 0.0)
    p_w = origins + dirs * torch.clamp(t, max=BIG)[:, None] + normal * 1e-4
    p_w = torch.where(need_shadow[:, None], p_w, 1e6)
    o_s, d_s = _to_local(rot, pos, pivot, p_w, torch.broadcast_to(sd, p_w.shape))
    sh = trace_fn(o_s, d_s, mv.tables)
    occluded = (sh["t"] < BIG) & sh["resolved"]

    lit = need_shadow & ~occluded
    irr = torch.where(lit[:, None], sl * incidence[:, None], 0.0) + ambient
    out = {}
    if prev_accu is not None:
        # temporal reprojection of the irradiance term (renderer.cpp:273-329);
        # hit points come straight from the kernel's t
        from voxel_tracer_tpu_torch.ops.reproject import reproject_accumulate
        hit_points = origins + dirs * torch.clamp(t, max=BIG)[:, None]
        irr, out["accu"] = reproject_accumulate(
            irr, torch.where(hit, t, BIG), hit_points, prev_accu.to(dev),
            prev_planes, width, height, depth_delta=depth_delta,
            reproject_mask=hit)
    sun_n = sd / torch.linalg.norm(sd)
    sky = torch.stack(_analytic_sky(dirs.unbind(-1), sun_n), dim=-1)
    color = torch.where(hit[:, None], alb * irr, sky)
    img = _to8(_aces(color)).to(torch.uint8)
    steps = (aux >> AUX_STEPS_SHIFT) & 0x7ffff
    shp = (height, width)
    out.update(
        image=img.reshape(*shp, 3),
        albedo=alb.reshape(*shp, 3),
        irradiance=irr.reshape(*shp, 3),
        depth=torch.where(hit, t, BIG).reshape(shp),
        normal=normal.reshape(*shp, 3),
        steps=(steps + sh["steps"]).reshape(shp),
        material=(aux & 255).reshape(shp),
    )
    return out
