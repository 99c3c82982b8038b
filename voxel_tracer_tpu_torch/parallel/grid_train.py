"""Sharded-grid differentiable training: the model-parallel axis for
sigma / albedo fields too large to replicate per device.

Counterpart of `voxel_tracer_tpu/parallel/grid_train.py`.  Emission /
absorption integration along a ray is an affine composition over z-slabs,
so each rank integrates only its own slab (entering with T = 1, C = 0)
and one all_gather of the per-slab partials (T_j, C_j, D_j) over GRID
composes the full-ray result in each ray's z order:

    T = prod_j T_j,   C = sum_j (prod_{k before j} T_k) * C_j

("before" in the ray's own z direction: ascending slabs for dz >= 0,
descending otherwise; D composes like C).  The gather is differentiable
(`_GatherGrid`): its backward sums the cotangent over GRID and hands the
rank its own block, which is JAX's transpose of `all_gather`
(`psum_scatter`).  Every grid rank computes the identical composition, so
that sum holds g copies of each slab's cotangent, and the step divides by
g as the JAX step does.  Gradients are then averaged over RAYS only: each
slab's gradient, parameters and Adam moments live on its owner alone.
"""

from __future__ import annotations

import numpy as np
import torch

from voxel_tracer_tpu_torch.ops import diff
from voxel_tracer_tpu_torch.parallel.mesh import GRID, RAYS, Mesh

PARAM_NAMES = ("sigma", "albedo")


def compose_slabs(Tg, Cg, Dg, dz):
    """Compose per-slab integrals (g, n[, 3]) in each ray's z order."""
    ones = torch.ones_like(Tg[:1])
    cum = torch.cumprod(Tg, dim=0)
    pref_asc = torch.cat([ones, cum[:-1]], dim=0)
    cum_d = torch.cumprod(Tg.flip(0), dim=0).flip(0)
    pref_desc = torch.cat([cum_d[1:], ones], dim=0)
    pref = torch.where((dz >= 0.0)[None, :], pref_asc, pref_desc)
    color = torch.sum(pref[..., None] * Cg, dim=0)
    depth = torch.sum(pref * Dg, dim=0)
    return color, cum[-1], depth


class _GatherGrid(torch.autograd.Function):
    """all_gather over GRID into (g, ...); backward: the cotangent summed
    over GRID, this rank's block."""

    @staticmethod
    def forward(ctx, x, mesh: Mesh):
        ctx.mesh = mesh
        return mesh.all_gather(GRID, x)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        return mesh.psum(GRID, g)[mesh.coords[GRID]], None


def slab_origins(o_l, z_shift):
    """Rays moved into a slab's frame: local z shifted by ``z_shift``
    (a float32 number of units), x and y untouched."""
    shift = torch.tensor([0.0, 0.0, float(z_shift)], dtype=torch.float32,
                         device=o_l.device)
    return o_l - shift


def render_grid_sharded(mesh: Mesh, params_slab, o_l, d_l, vpu, max_steps):
    """This rank's slab render + gather over GRID + composition, for the
    rank's rays.  ``params_slab`` holds the rank's z-slab."""
    zs = params_slab["sigma"].shape[0]
    z0 = np.float32(mesh.coords[GRID]) * np.float32(zs / vpu)
    out = diff.render_density(params_slab["sigma"], params_slab["albedo"],
                              slab_origins(o_l, z0), d_l, vpu, max_steps)
    Tg, Cg, Dg = (_GatherGrid.apply(out[k], mesh)
                  for k in ("trans", "color", "depth"))
    return compose_slabs(Tg, Cg, Dg, d_l[:, 2])


def make_optimizer(params, optimizer):
    """`torch.optim.Adam(lr)` over the params in PARAM_NAMES order when
    ``optimizer`` is a number, else ``optimizer(list of params)``."""
    tensors = [params[k] for k in PARAM_NAMES]
    if callable(optimizer):
        return optimizer(tensors)
    return torch.optim.Adam(tensors, lr=float(optimizer))


def background_rgb(background, device):
    """The background colour behind the transmittance, black by default."""
    if background is None:
        return torch.zeros(3, device=device)
    return torch.as_tensor(background, dtype=torch.float32, device=device)


def make_grid_sharded_train_step(mesh: Mesh, optimizer, vpu: float,
                                 max_steps: int = 192, background=None):
    """Inverse-rendering train step with the grid sharded over z-slabs.

    params = {"sigma": (Z/g, Y, X), "albedo": (Z/g, Y, X, 3)}: this rank's
    slab (`place_grid_params`), leaf tensors with ``requires_grad``; rays
    and targets are the rank's RAYS shard.  Returns
    step(params, opt, o_l, d_l, target) -> (params, opt, loss) as
    `sharding.make_train_step` does: ``opt`` None builds the optimizer
    (`make_optimizer`) over the slab, so its moments hold the slab alone.
    """
    g = mesh.shape[GRID]

    def step(params, opt, o_l, d_l, target):
        if opt is None:
            opt = make_optimizer(params, optimizer)
        color, trans, _ = render_grid_sharded(mesh, params, o_l, d_l, vpu,
                                              max_steps)
        color = color + trans[:, None] * background_rgb(background, o_l.device)
        loss = torch.mean((color - target) ** 2)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        for k in PARAM_NAMES:
            # g copies of the cotangent came back through the gather; then
            # the mean over ray shards, and no collective over GRID
            params[k].grad = mesh.pmean(RAYS, params[k].grad / g)
        opt.step()
        return params, opt, mesh.pmean(RAYS, loss.detach())

    return step


def place_grid_params(mesh: Mesh, params):
    """This rank's z-slab of each field (Z divisible by the GRID size), a
    fresh leaf tensor on the mesh's device that requires grad."""
    out = {}
    for k, v in params.items():
        v = torch.as_tensor(v)
        sl = v[mesh.block(GRID, v.shape[0])]
        out[k] = sl.to(mesh.device, torch.float32).clone().requires_grad_()
    return out
