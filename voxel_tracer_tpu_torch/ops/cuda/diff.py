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

`march_fwd` and `march_bwd` are the launchers the autograd Function
calls; a call allocates its outputs and launches one kernel on the
current stream.  D3 reads one (sigma, albedo r, g, b) float4 record a
voxel and adds into one zeroed gradient record a voxel: `march_bwd`
packs the record (`pack_record`) before the launch and unpacks the
gradient record into d sigma and d albedo after it (`unpack_grads`).
`KERNEL_LAUNCHES` counts the launches of each kernel.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from voxel_tracer_tpu_torch.ops import diff
from voxel_tracer_tpu_torch.ops.cuda import _build

KERNEL_LAUNCHES = {"diff_fwd": 0, "diff_bwd": 0}


def reset_launch_counts():
    for k in KERNEL_LAUNCHES:
        KERNEL_LAUNCHES[k] = 0


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


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


def pack_record(sigma, albedo):
    """(Z, Y, X) sigma and (Z, Y, X, 3) albedo -> the (Z * Y * X, 4)
    float32 record D3 reads: (sigma, albedo r, g, b) a voxel, in the
    grids' (z, y, x) order."""
    return torch.cat([sigma[..., None], albedo], dim=-1).reshape(-1, 4)


def unpack_grads(grec, shape_zyx):
    """D3's (Z * Y * X, 4) gradient record -> (d sigma (Z, Y, X),
    d albedo (Z, Y, X, 3)), each contiguous."""
    g = grec.reshape(*shape_zyx, 4)
    return g[..., 0].contiguous(), g[..., 1:].contiguous()


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
        err = getattr(lib, fn)(ctypes.byref(args), torch.cuda.current_stream(dev).cuda_stream)
    _build.raise_on(lib, err, what)
    KERNEL_LAUNCHES[what] += 1


def march_fwd(sigma, albedo, origin_l, dir_l, vpu, max_steps: int = 192):
    """D2: (color (N, 3), trans (N,), depth (N,)) of N local rays; the
    plain forward (`ops/diff._render_fwd_only`) for CPU tensors."""
    dev = _check(sigma, albedo, origin_l, dir_l)
    if dev.type == "cpu":
        return diff._render_fwd_only(sigma, albedo, origin_l, dir_l, vpu, max_steps)
    sigma, albedo, origin_l, dir_l = (t.contiguous() for t in (sigma, albedo, origin_l, dir_l))
    n = origin_l.shape[0]
    color = torch.empty((n, 3), dtype=torch.float32, device=dev)
    trans = torch.empty((n,), dtype=torch.float32, device=dev)
    depth = torch.empty((n,), dtype=torch.float32, device=dev)
    if n > 0:                   # an empty launch grid is not a valid launch
        _launch("vt_diff_fwd", "diff_fwd", sigma, albedo, origin_l, dir_l, vpu, max_steps,
                color, trans, depth)
    return color, trans, depth


def march_bwd(sigma, albedo, origin_l, dir_l, vpu, max_steps, color, trans, depth,
              g_color, g_trans, g_depth):
    """D3: (d sigma (Z, Y, X), d albedo (Z, Y, X, 3)) of the cotangents
    (g_color, g_trans, g_depth) of D2's outputs (color, trans, depth),
    replaying the march; the plain backward (`ops/diff._render_bwd`) for
    CPU tensors."""
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
    if n == 0:
        return torch.zeros_like(sigma), torch.zeros_like(albedo)
    rec = pack_record(sigma, albedo)
    grec = torch.zeros_like(rec)
    _launch("vt_diff_bwd", "diff_bwd", sigma, albedo, origin_l, dir_l, vpu, max_steps,
            *saved[:3], cts=saved[3:], recs=(rec, grec))
    return unpack_grads(grec, sigma.shape)


class _RenderDensity(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sigma, albedo, origin_l, dir_l, vpu, max_steps):
        color, trans, depth = march_fwd(sigma, albedo, origin_l, dir_l, vpu, max_steps)
        ctx.save_for_backward(sigma, albedo, origin_l, dir_l, color, trans, depth)
        ctx.args = (vpu, max_steps)
        return color, trans, depth

    @staticmethod
    def backward(ctx, g_color, g_trans, g_depth):
        sigma, albedo, origin_l, dir_l, color, trans, depth = ctx.saved_tensors
        vpu, max_steps = ctx.args
        d_sigma, d_albedo = march_bwd(sigma, albedo, origin_l, dir_l, vpu, max_steps,
                                      color, trans, depth, g_color, g_trans, g_depth)
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
