"""The coherent kernel (B5) inside the renderer.

Counterpart of `voxel_tracer_tpu/ops/pallas/integrate.py`.
`intersect_volume_fast` traces world rays through one volume with
`coherent.trace_coherent` and turns its voxel index and axis into
material, world normal and albedo: a `HitResult`, as the wavefront tracer
gives.  The JAX function traces every ray a second time through the XLA
DDA and keeps that result where the Pallas kernel left a ray unresolved;
here every ray resolves, and with ``use_fallback=True`` only rays whose
`resolved` is 0 (none, by the kernel's design) are selected with
`nonzero` and traced through D1's wrapper
(`ops/cuda/dda.intersect_volume_local`).
"""

from __future__ import annotations

import torch

from voxel_tracer_tpu_torch.models.camera import rays_for_image
from voxel_tracer_tpu_torch.models.skydome import SkyDomeData, sample_sky
from voxel_tracer_tpu_torch.ops import dda
from voxel_tracer_tpu_torch.ops.composite import HitResult, _to_local
from voxel_tracer_tpu_torch.ops.cuda import coherent
from voxel_tracer_tpu_torch.ops.cuda import dda as dda_kernel
from voxel_tracer_tpu_torch.ops.math3d import BIG_F32
from voxel_tracer_tpu_torch.ops.tonemap import aces_approx


class FastVolume:
    """A volume's grid, palette and transform on ``device``, plus its
    packed kernel tables."""

    def __init__(self, volume, device="cuda"):
        self.volume = volume
        self.device = torch.device(device)
        self.refresh()

    def refresh(self):
        """Re-pack after edits of the host volume (set_voxel) or a change
        of its transform."""
        v, dev = self.volume, self.device
        self.grid = torch.tensor(v.grid, device=dev)
        self.brick_occ = torch.tensor(v.brick_occ, device=dev)
        self.palette = torch.tensor(v.palette, dtype=torch.float32, device=dev)
        self.rot, self.pos, self.pivot = (
            torch.tensor(x, dtype=torch.float32, device=dev)
            for x in (v.rot, v.pos, v.pivot))
        self.vpu = float(v.vpu)
        self.packed = coherent.pack_volume(v.grid, v.vpu, dev)


def tiles_of_image(x, height, width, tile=32):
    """(H*W, ...) row-major rays -> square-tile order (pure relayout); H
    and W must divide by `tile`.  Neighbouring rays of a tile cross the
    same bricks."""
    rest = tuple(x.shape[1:])
    x = x.reshape(height // tile, tile, width // tile, tile, *rest)
    return x.transpose(1, 2).reshape(height * width, *rest)


def image_of_tiles(x, height, width, tile=32):
    """Inverse of `tiles_of_image`."""
    rest = tuple(x.shape[1:])
    x = x.reshape(height // tile, width // tile, tile, tile, *rest)
    return x.transpose(1, 2).reshape(height * width, *rest)


def _trace_fast(fv: FastVolume, origins, dirs, use_fallback=False,
                trace_fn=None):
    """HitResult of world rays through one volume; ``trace_fn`` is B5's
    wrapper (default) or its plain version."""
    trace_fn = trace_fn or coherent.trace_coherent
    o_l, d_l = _to_local(fv.rot, fv.pos, fv.pivot, origins, dirs)
    o_l, d_l = o_l.contiguous(), d_l.contiguous()
    pk = fv.packed
    res = trace_fn(pk.occ, pk.words, o_l, d_l, pk.bsize, pk.vpu)
    resolved, steps = res["resolved"], res["steps"]
    hit = (res["t"] < coherent.BIG) & resolved
    t = torch.where(hit, res["t"], BIG_F32)

    # decode voxel -> material, normal
    bx, by, bz = pk.bsize
    px = bx * 8
    pxy = px * (by * 8)
    vox = res["vox"]
    vz = vox // pxy
    vy = (vox - vz * pxy) // px
    vx = vox - vz * pxy - vy * px
    mat = dda._gather3(fv.grid, torch.stack([vx, vy, vz], dim=-1))
    ax = res["ax"]
    axis = torch.clamp(ax >> 1, max=2)   # a miss holds entry_axis * 4
    sign = torch.where((ax & 1) == 1, 1.0, -1.0)
    step3 = torch.nn.functional.one_hot(axis.long(), 3).to(torch.float32) * sign[:, None]
    normal = dda.normal_from_axis(axis, step3, fv.rot)

    if use_fallback:
        ids = (~resolved).nonzero()[:, 0]
        if ids.numel():
            fb = dda_kernel.intersect_volume_local(fv.grid, fv.brick_occ, o_l[ids],
                                                   d_l[ids], fv.vpu)
            fb_hit = fb["t"] < BIG_F32
            t[ids] = torch.where(fb_hit, fb["t"], BIG_F32)
            hit[ids] = fb_hit
            mat[ids] = fb["mat"]
            normal[ids] = dda.normal_from_axis(fb["axis"], fb["step_sign"], fv.rot)
            steps = steps.clone()
            steps[ids] = fb["steps"]

    mat = torch.where(hit, mat, 0)
    albedo = fv.palette[torch.clamp(mat, 0, 255).long()]
    return HitResult(
        t=t,
        mat=mat,
        normal=torch.where(hit[:, None], normal, 0.0),
        albedo=torch.where(hit[:, None], albedo, 0.0),
        steps=steps,
        obj=torch.where(hit, 0, -1).to(torch.int32),
    )


def intersect_volume_fast(fv: FastVolume, origins, dirs,
                          use_fallback: bool = True) -> HitResult:
    """First hit of N world rays ((N, 3) float32 on the volume's device)
    through one volume, via the B5 kernel (the fallback on D1)."""
    return _trace_fast(fv, origins, dirs, use_fallback)


def render_flat_fast(fv: FastVolume, sky_pixels, camera, width, height,
                     use_fallback: bool = False):
    """Kernel-backed flat-shaded frame: palette albedo on hits, the sky
    (bilinear `sample_sky` of ``sky_pixels``, (H, W, 3) on the volume's
    device) on misses, ACES.  Returns image (H, W, 3) float, depth and
    steps (H, W)."""
    return _flat(fv, sky_pixels, camera, width, height, use_fallback,
                 coherent.trace_coherent)


def render_flat_fast_plain(fv: FastVolume, sky_pixels, camera, width, height):
    """`render_flat_fast` with B5's plain PyTorch version, on any device."""
    return _flat(fv, sky_pixels, camera, width, height, False,
                 coherent.trace_coherent_plain)


def _flat(fv, sky_pixels, camera, width, height, use_fallback, trace_fn):
    origins, dirs = rays_for_image(camera, width, height, device=fv.device)
    tiled = width % 32 == 0 and height % 32 == 0
    if tiled:
        origins = tiles_of_image(origins, height, width)
        dirs = tiles_of_image(dirs, height, width)
    hit = _trace_fast(fv, origins, dirs, use_fallback, trace_fn)
    missed = hit.t >= BIG_F32
    sky = sample_sky(SkyDomeData(pixels=sky_pixels), dirs)
    img = aces_approx(torch.where(missed[:, None], sky, hit.albedo))
    t, steps = hit.t, hit.steps
    if tiled:
        img, t, steps = (image_of_tiles(x, height, width) for x in (img, t, steps))
    return dict(image=img.reshape(height, width, 3),
                depth=t.reshape(height, width),
                steps=steps.reshape(height, width))
