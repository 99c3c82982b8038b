"""The differentiable march as two kernels (D2, D3): host side of
`csrc/diff.cu`.

Counterpart of the XLA programs of `voxel_tracer_tpu/ops/diff.py`
(`render_density`, a `jax.custom_vjp` over a forward `lax.scan` and a
replay-backward `lax.scan`), which the JAX package runs under its default
trainer.  Its plain version is `ops/diff.render_density`, a host loop of
lock-step tensor steps; `render_density` here has its signature and
returns the same dict.  It is a `torch.autograd.Function` whose forward
launches D2 (`diff_fwd_kernel`: color, trans and depth) and whose
backward launches D3 (`diff_bwd_kernel`: the replay from the saved
outputs, d sigma and d albedo by atomic adds); it returns no gradient for
the rays or vpu.  CUDA tensors launch the kernels, CPU tensors run the
plain version; a failed build or launch raises, and so do inputs that are
not float32 or lie on two devices.

The callers: `parallel/sharding.make_train_step` (the wavefront trainer's
step, one render or `overlap_slabs` z-slab renders), the grid-sharded
step (`parallel/grid_train.render_grid_sharded`), `parallel/worker.py`'s
targets, `trainer.Trainer.render`, `examples/inverse_render.py` and the
benchmark's workload 4.  `ops/diff.py` never reaches this module.

The record.  D2 and D3 read one (sigma, albedo r, g, b) float4 record a
voxel, which `pack_record` interleaves (`diff_pack_kernel`); D3 adds into
one zeroed gradient record a voxel, which `unpack_grads` splits into
d sigma and d albedo (torch's two strided copies: they run at the memory
rate, where torch.cat, the pack's plain version, reaches a third of it;
tools/torch_diff_trials.py).  Under autograd the forward
packs the record once, launches D2 on it and saves it, and the backward
hands it to D3: one pack a training step.  A call that needs no gradient
packs only where the pack pays for itself (`uses_record`): otherwise D2
reads the plain grids (`diff_fwd_kernel<false>`).

`march_fwd` and `march_bwd` are the launchers; a call allocates its
outputs and launches one kernel on the current stream (`march_bwd`
packs the record first unless it is given one, and unpacks after).
`KERNEL_LAUNCHES` counts the launches of each kernel.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from voxel_tracer_tpu_torch.ops import diff
from voxel_tracer_tpu_torch.ops.cuda import _build

KERNEL_LAUNCHES = {"diff_fwd": 0, "diff_bwd": 0, "diff_pack": 0}

# A forward-only call reads the records when its rays number at least this
# share of the grid's voxels: below it the pack (32 bytes a voxel moved)
# costs more than D2 saves on its loads.  tools/torch_diff_trials.py's
# sweep on an H100 (device ms, pack + D2 on the record against D2 on the
# grids): 128^3 and inverse_128's random rays, even between 1/64 and 1/32
# rays a voxel; 64^3 and workload 4's plane rays, between 1/16 and 1/4.
# A call that needs a gradient always packs: D3 reads the record too.
RECORD_MIN_RAYS_PER_VOXEL = 1 / 32


def reset_launch_counts():
    for k in KERNEL_LAUNCHES:
        KERNEL_LAUNCHES[k] = 0


_P, _I, _F, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_int64


class _Args(ctypes.Structure):
    """`DiffArgs` of csrc/diff.cu, field for field."""

    _fields_ = [(name, _P) for name in (
        "sigma", "albedo", "orig", "dirs", "color", "trans", "depth", "g_color",
        "g_trans", "g_depth", "rec", "grec")] + [
        (name, _I) for name in ("n", "gx", "gy", "gz", "max_steps")] + [
        ("vpu", _F), ("rvpu", _F)]


def _lib():
    lib = _build.load("diff")
    if not getattr(lib, "_vt_typed", False):
        for fn in (lib.vt_diff_fwd, lib.vt_diff_bwd):
            fn.argtypes = [ctypes.POINTER(_Args), _P]
            fn.restype = _I
        lib.vt_diff_pack.argtypes = [_P, _P, _P, _I64, _P]
        lib.vt_diff_pack.restype = _I
        lib.vt_error_string.argtypes = [_I]
        lib.vt_error_string.restype = ctypes.c_char_p
        lib._vt_typed = True
    return lib


def _check(sigma, albedo, origin_l, dir_l):
    """The device of the four inputs; raises unless they are float32 on one
    device with the shapes of `ops/diff.render_density`."""
    dev = _build.device_of(origin_l)
    for name, t in (("sigma", sigma), ("albedo", albedo), ("origin_l", origin_l),
                    ("dir_l", dir_l)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, origin_l on {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} has dtype {t.dtype}, expected torch.float32")
    n = origin_l.shape[0]
    if sigma.ndim != 3 or tuple(albedo.shape) != (*sigma.shape, 3) \
            or tuple(origin_l.shape) != (n, 3) or tuple(dir_l.shape) != (n, 3):
        raise ValueError(f"sigma {tuple(sigma.shape)}, albedo {tuple(albedo.shape)}, rays "
                         f"{tuple(origin_l.shape)} and {tuple(dir_l.shape)}: expected "
                         f"(Z, Y, X), (Z, Y, X, 3), (N, 3) and (N, 3)")
    if n >= 2 ** 31 // 4:
        raise ValueError(f"{n} rays: the kernels take fewer than 2**29")
    if sigma.numel() == 0:
        raise ValueError(f"an empty grid {tuple(sigma.shape)}")
    return dev


def pack_record_plain(sigma, albedo):
    """(Z, Y, X) sigma and (Z, Y, X, 3) albedo -> the (Z * Y * X, 4)
    float32 record D2 and D3 read: (sigma, albedo r, g, b) a voxel, in the
    grids' (z, y, x) order."""
    return torch.cat([sigma[..., None], albedo], dim=-1).reshape(-1, 4)


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def pack_record(sigma, albedo):
    """`pack_record_plain` as one kernel (`diff_pack_kernel`) for CUDA
    tensors, bit for bit; the plain version for CPU tensors."""
    if sigma.device.type == "cpu":
        return pack_record_plain(sigma, albedo)
    dev = sigma.device
    sigma, albedo = sigma.contiguous(), albedo.contiguous()
    _build.check("albedo", albedo, torch.float32, (*sigma.shape, 3), dev)
    _build.check("sigma", sigma, torch.float32, albedo.shape[:-1], dev)
    rec = torch.empty((sigma.numel(), 4), dtype=torch.float32, device=dev)
    if rec.numel():
        lib = _lib()
        with torch.cuda.device(dev):
            err = lib.vt_diff_pack(sigma.data_ptr(), albedo.data_ptr(), rec.data_ptr(),
                                   sigma.numel(), _stream(dev))
        _build.raise_on(lib, err, "diff_pack")
        KERNEL_LAUNCHES["diff_pack"] += 1
    return rec


def unpack_grads(grec, shape_zyx):
    """D3's (Z * Y * X, 4) gradient record -> (d sigma (Z, Y, X),
    d albedo (Z, Y, X, 3)), each contiguous."""
    g = grec.reshape(*shape_zyx, 4)
    return g[..., 0].contiguous(), g[..., 1:].contiguous()


def uses_record(n_rays, n_voxels, needs_grad):
    """Whether a forward reads the records (else the plain grids): always
    when the call needs a gradient (the record is packed once and D3
    reads it too), else when the rays number at least
    RECORD_MIN_RAYS_PER_VOXEL of the voxels."""
    return bool(needs_grad) or n_rays >= RECORD_MIN_RAYS_PER_VOXEL * n_voxels


def _launch(fn, what, sigma, albedo, origin_l, dir_l, vpu, max_steps, color, trans,
            depth, cts=(None, None, None), recs=(None, None)):
    vpu = float(vpu)
    gz, gy, gx = sigma.shape
    ptrs = [None if t is None else t.data_ptr()
            for t in (sigma, albedo, origin_l, dir_l, color, trans, depth, *cts, *recs)]
    args = _Args(*ptrs, origin_l.shape[0], gx, gy, gz, int(max_steps), vpu,
                 float(np.float32(1.0 / vpu)))
    dev = origin_l.device
    lib = _lib()
    with torch.cuda.device(dev):
        err = getattr(lib, fn)(ctypes.byref(args), _stream(dev))
    _build.raise_on(lib, err, what)
    KERNEL_LAUNCHES[what] += 1


def _check_record(rec, sigma, dev):
    rec = rec.contiguous()
    _build.check("rec", rec, torch.float32, (sigma.numel(), 4), dev)
    return rec


def march_fwd(sigma, albedo, origin_l, dir_l, vpu, max_steps: int = 192, rec=None):
    """D2: (color (N, 3), trans (N,), depth (N,)) of N local rays; on the
    records ``rec`` (`pack_record` of sigma and albedo) when given, else
    on the plain grids; the plain forward (`ops/diff._render_fwd_only`)
    for CPU tensors."""
    dev = _check(sigma, albedo, origin_l, dir_l)
    if dev.type == "cpu":
        return diff._render_fwd_only(sigma, albedo, origin_l, dir_l, vpu, max_steps)
    sigma, albedo, origin_l, dir_l = (t.contiguous() for t in (sigma, albedo, origin_l, dir_l))
    if rec is not None:
        rec = _check_record(rec, sigma, dev)
    n = origin_l.shape[0]
    color = torch.empty((n, 3), dtype=torch.float32, device=dev)
    trans = torch.empty((n,), dtype=torch.float32, device=dev)
    depth = torch.empty((n,), dtype=torch.float32, device=dev)
    if n > 0:                   # an empty launch grid is not a valid launch
        _launch("vt_diff_fwd", "diff_fwd", sigma, albedo, origin_l, dir_l, vpu, max_steps,
                color, trans, depth, recs=(rec, None))
    return color, trans, depth


def march_bwd(sigma, albedo, origin_l, dir_l, vpu, max_steps, color, trans, depth,
              g_color, g_trans, g_depth, rec=None):
    """D3: (d sigma (Z, Y, X), d albedo (Z, Y, X, 3)) of the cotangents
    (g_color, g_trans, g_depth) of D2's outputs (color, trans, depth),
    replaying the march on the records ``rec`` (packed here when not
    given); the plain backward (`ops/diff._render_bwd`) for CPU tensors."""
    dev = _check(sigma, albedo, origin_l, dir_l)
    if dev.type == "cpu":
        return diff._render_bwd(sigma, albedo, origin_l, dir_l, vpu, max_steps, color,
                                trans, depth, g_color, g_trans, g_depth)
    sigma, albedo, origin_l, dir_l = (t.contiguous() for t in (sigma, albedo, origin_l, dir_l))
    n = origin_l.shape[0]
    saved = []
    for name, t, shape in (("color", color, (n, 3)), ("trans", trans, (n,)),
                           ("depth", depth, (n,)), ("g_color", g_color, (n, 3)),
                           ("g_trans", g_trans, (n,)), ("g_depth", g_depth, (n,))):
        t = t.contiguous()
        _build.check(name, t, torch.float32, shape, dev)
        saved.append(t)
    if rec is not None:
        rec = _check_record(rec, sigma, dev)
    if n == 0:
        return torch.zeros_like(sigma), torch.zeros_like(albedo)
    if rec is None:
        rec = pack_record(sigma, albedo)
    grec = torch.zeros_like(rec)
    _launch("vt_diff_bwd", "diff_bwd", sigma, albedo, origin_l, dir_l, vpu, max_steps,
            *saved[:3], cts=saved[3:], recs=(rec, grec))
    return unpack_grads(grec, sigma.shape)


class _RenderDensity(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sigma, albedo, origin_l, dir_l, vpu, max_steps):
        needs_grad = ctx.needs_input_grad[0] or ctx.needs_input_grad[1]
        rec = None
        if origin_l.shape[0] and uses_record(origin_l.shape[0], sigma.numel(), needs_grad):
            rec = pack_record(sigma, albedo)
        color, trans, depth = march_fwd(sigma, albedo, origin_l, dir_l, vpu, max_steps, rec)
        if needs_grad:          # the backward's D3 reads the same record
            ctx.save_for_backward(sigma, albedo, origin_l, dir_l, color, trans, depth, rec)
        ctx.args = (vpu, max_steps)
        return color, trans, depth

    @staticmethod
    def backward(ctx, g_color, g_trans, g_depth):
        sigma, albedo, origin_l, dir_l, color, trans, depth, rec = ctx.saved_tensors
        vpu, max_steps = ctx.args
        d_sigma, d_albedo = march_bwd(sigma, albedo, origin_l, dir_l, vpu, max_steps,
                                      color, trans, depth, g_color, g_trans, g_depth, rec)
        return d_sigma, d_albedo, None, None, None, None


def render_density(sigma, albedo, origin_l, dir_l, vpu, max_steps: int = 192):
    """`ops/diff.render_density` on D2 (forward) and D3 (backward) for CUDA
    tensors, the plain version for CPU tensors: sigma (Z, Y, X) and albedo
    (Z, Y, X, 3) float32, local rays (N, 3) on the same device, vpu a
    Python float.  Returns {"color": (N, 3), "trans": (N,), "depth": (N,)}."""
    dev = _check(sigma, albedo, origin_l, dir_l)
    if dev.type == "cpu":
        return diff.render_density(sigma, albedo, origin_l, dir_l, vpu, max_steps)
    color, trans, depth = _RenderDensity.apply(sigma, albedo, origin_l, dir_l, float(vpu),
                                               int(max_steps))
    return {"color": color, "trans": trans, "depth": depth}
