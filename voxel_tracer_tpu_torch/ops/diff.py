"""Differentiable voxel rendering: exact-DDA emission/absorption
integration with a replay backward.

Counterpart of `voxel_tracer_tpu/ops/diff.py`.  Per-voxel parameters are
a density field sigma (Z, Y, X) and an albedo field (Z, Y, X, 3).  A ray
accumulates, over its Amanatides-Woo visit sequence, the
emission-absorption model with exact per-voxel segment lengths dl_i:

    alpha_i = 1 - exp(-sigma_i * dl_i)
    w_i     = T_i * alpha_i,   T_{i+1} = T_i * (1 - alpha_i)
    C       = sum_i w_i * albedo_i

`render_density` is a `torch.autograd.Function`: the forward is a
lock-step voxel DDA over `max_steps` steps, and the backward stores no
tape but replays the same march and rebuilds the suffix sums from the
saved outputs, scatter-adding the gradients with `index_add_`.  This is
the plain version of the kernels D2 and D3 (`csrc/diff.cu`), which march
one ray a thread with the same float program: the wavefront backend's
step (`parallel/`), `Trainer.render` and the examples call
`ops/cuda/diff.render_density`, which launches them for CUDA tensors and
runs this function for CPU tensors.  This module never reaches the
kernels.
Divisors are tensors on the rays' device (PyTorch's CUDA division by a
CPU scalar multiplies by the reciprocal, which rounds differently).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from voxel_tracer_tpu_torch.ops.dda import _fma, slab_test
from voxel_tracer_tpu_torch.ops.math3d import BIG_F32, sign_dir

# dead rays leave the state unchanged, so the march may stop early; it
# checks every this many steps (one host sync each)
_SYNC_EVERY = 8


class _March(NamedTuple):
    cell: torch.Tensor    # (N, 3) int64
    tmax3: torch.Tensor   # (N, 3) float32
    t: torch.Tensor       # (N,) current segment start (world units)
    alive: torch.Tensor   # (N,) bool


def _march_setup(origin_l, dir_l, vpu, rvpu, size3_i):
    """Shared DDA setup: identical in forward and backward replay.

    vpu, rvpu: 0-dim float32 tensors (vpu and its float32 reciprocal) on
    the rays' device; size3_i: (3,) int64 (X, Y, Z) on the same device.
    Rounding follows the JAX function as XLA compiles it under `jit` (the
    trainer's step), where vpu is a constant: division by it becomes a
    multiply by its float32 reciprocal, and the entry point and the first
    crossing t are fused multiply-adds."""
    size_l = size3_i.to(torch.float32) / vpu
    tmin, tmax, _, ok = slab_test(origin_l, dir_l, size_l)
    stepf = sign_dir(dir_l)
    rdir = torch.reciprocal(dir_l)
    # clamp inf (axis-parallel rays) to BIG so 0 * delta stays 0, not NaN
    delta = torch.clamp(torch.abs(rdir), max=BIG_F32)
    entry = _fma(dir_l, tmin[..., None], origin_l) * vpu
    cell = torch.minimum(torch.clamp(torch.floor(entry), min=0.0),
                         (size3_i - 1).to(torch.float32)).to(torch.int64)
    tmax3 = _fma(((cell.to(torch.float32) - entry)
                  + torch.clamp(stepf, min=0.0)) * rdir, rvpu, tmin[..., None])
    tmax3 = torch.where(torch.isnan(tmax3), BIG_F32, tmax3)
    tmax3 = torch.clamp(tmax3, max=BIG_F32)
    st = _March(cell=cell, tmax3=tmax3,
                t=torch.where(ok, tmin, BIG_F32), alive=ok)
    return st, stepf.to(torch.int64), delta * rvpu, tmin, tmax


def _step(st: _March, stepi, delta, size3_i, t_exit):
    """One DDA step; returns (new_state, seg_cell, seg_len, seg_valid)."""
    t_next = torch.minimum(st.tmax3.amin(dim=-1), t_exit)
    seg_len = torch.clamp(t_next - st.t, min=0.0)
    seg_valid = st.alive & (seg_len > 0.0)
    onehot = torch.nn.functional.one_hot(st.tmax3.argmin(dim=-1), 3)
    cell = st.cell + onehot * stepi
    tmax3 = st.tmax3 + onehot.to(torch.float32) * delta
    oob = ((cell < 0) | (cell >= size3_i)).any(dim=-1)
    alive = st.alive & ~oob & (t_next < t_exit)
    return _March(cell, tmax3, t_next, alive), st.cell, seg_len, seg_valid


def _flat_idx(cell, size3_i):
    gx, gy, gz = (int(v) for v in size3_i)
    return (torch.clamp(cell[..., 2], 0, gz - 1) * (gy * gx)
            + torch.clamp(cell[..., 1], 0, gy - 1) * gx
            + torch.clamp(cell[..., 0], 0, gx - 1))


def _setup(sigma, origin_l, dir_l, vpu):
    gz, gy, gx = sigma.shape
    dev = origin_l.device
    size3_i = torch.tensor([gx, gy, gz], device=dev)
    vpu_t, rvpu_t = (torch.tensor(v, dtype=torch.float32, device=dev)
                     for v in (float(vpu), float(np.float32(1.0 / vpu))))
    return size3_i, _march_setup(origin_l, dir_l, vpu_t, rvpu_t, size3_i)


def _render_fwd_only(sigma, albedo, origin_l, dir_l, vpu, max_steps):
    size3_i, (st, stepi, delta, _, t_exit) = _setup(sigma, origin_l, dir_l, vpu)
    n = origin_l.shape[0]
    sig_flat = sigma.reshape(-1)
    alb_flat = albedo.reshape(-1, 3)
    T = torch.ones(n, device=origin_l.device)
    C = torch.zeros((n, 3), device=origin_l.device)
    D = torch.zeros(n, device=origin_l.device)
    for i in range(max_steps):
        if i % _SYNC_EVERY == 0 and not bool(st.alive.any()):
            break
        st2, cell, dl, valid = _step(st, stepi, delta, size3_i, t_exit)
        idx = _flat_idx(cell, size3_i)
        sg, al = sig_flat[idx], alb_flat[idx]
        alpha = 1.0 - torch.exp(-torch.clamp(sg, min=0.0) * dl)
        w = torch.where(valid, T * alpha, 0.0)
        C = C + w[:, None] * al
        D = D + w * (st.t + 0.5 * dl)
        T = torch.where(valid, T * (1.0 - alpha), T)
        st = st2
    return C, T, D


def _render_bwd(sigma, albedo, origin_l, dir_l, vpu, max_steps, C_total,
                T_final, D_total, gC, gT, gD):
    """Replay the march; reconstruct suffix sums from the saved outputs.

    For C = sum w_i a_i with w_i = T_i alpha_i:
      dC/da_i     = w_i
      dC/dsigma_i = dl_i * [ T_i e^{-sigma_i dl_i} a_i - S_i ]
    where S_i = sum_{j>i} w_j a_j is the suffix radiance, obtained during
    replay as S_i = C_total - C_prefix_including_i.  Depth is handled
    alike with the suffix depth; trans contributes -dl_i * T_final.
    """
    size3_i, (st, stepi, delta, _, t_exit) = _setup(sigma, origin_l, dir_l, vpu)
    n = origin_l.shape[0]
    sig_flat = sigma.reshape(-1)
    alb_flat = albedo.reshape(-1, 3)
    d_sigma = torch.zeros_like(sig_flat)
    d_albedo = torch.zeros_like(alb_flat)
    T = torch.ones(n, device=origin_l.device)
    Cpre = torch.zeros((n, 3), device=origin_l.device)
    Dpre = torch.zeros(n, device=origin_l.device)
    for i in range(max_steps):
        if i % _SYNC_EVERY == 0 and not bool(st.alive.any()):
            break
        st2, cell, dl, valid = _step(st, stepi, delta, size3_i, t_exit)
        idx = _flat_idx(cell, size3_i)
        sg, al = sig_flat[idx], alb_flat[idx]
        e = torch.exp(-torch.clamp(sg, min=0.0) * dl)
        alpha = 1.0 - e
        w = torch.where(valid, T * alpha, 0.0)
        seg_d = st.t + 0.5 * dl
        Cpre = Cpre + w[:, None] * al
        Dpre = Dpre + w * seg_d
        suffix_c = C_total - Cpre
        suffix_d = D_total - Dpre
        relu = (sg > 0.0).to(torch.float32)     # sigma clamped at 0 in fwd
        gsig = (torch.sum(gC * (T * e)[:, None] * al - gC * suffix_c, dim=-1)
                + gD * ((T * e) * seg_d - suffix_d)
                - gT * T_final) * dl * relu
        gsig = torch.where(valid, gsig, 0.0)
        galb = torch.where(valid[:, None], gC * w[:, None], 0.0)
        d_sigma.index_add_(0, idx, gsig)
        d_albedo.index_add_(0, idx, galb)
        T = torch.where(valid, T * (1.0 - alpha), T)
        st = st2
    return d_sigma.reshape(sigma.shape), d_albedo.reshape(albedo.shape)


class _RenderDensity(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sigma, albedo, origin_l, dir_l, vpu, max_steps):
        color, trans, depth = _render_fwd_only(sigma, albedo, origin_l,
                                               dir_l, vpu, max_steps)
        ctx.save_for_backward(sigma, albedo, origin_l, dir_l, color, trans,
                              depth)
        ctx.args = (vpu, max_steps)
        return color, trans, depth

    @staticmethod
    def backward(ctx, g_color, g_trans, g_depth):
        sigma, albedo, origin_l, dir_l, color, trans, depth = ctx.saved_tensors
        vpu, max_steps = ctx.args
        d_sigma, d_albedo = _render_bwd(sigma, albedo, origin_l, dir_l, vpu,
                                        max_steps, color, trans, depth,
                                        g_color, g_trans, g_depth)
        return d_sigma, d_albedo, None, None, None, None


def render_density(sigma, albedo, origin_l, dir_l, vpu, max_steps: int = 192):
    """Volume-render N local-space rays through a density/albedo grid.

    Args:
      sigma:  (Z, Y, X) float32 density (>= 0).
      albedo: (Z, Y, X, 3) float32 per-voxel color.
      origin_l, dir_l: (N, 3) float32 local-space rays (unit dir), on the
        grid's device.
      vpu: voxels per unit (a Python float).
    Returns:
      dict: color (N, 3) pre-multiplied radiance, trans (N,) final
      transmittance (for background compositing), depth (N,) expected depth.
    """
    color, trans, depth = _RenderDensity.apply(sigma, albedo, origin_l,
                                               dir_l, float(vpu),
                                               int(max_steps))
    return {"color": color, "trans": trans, "depth": depth}
