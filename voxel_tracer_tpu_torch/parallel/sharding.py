"""Ray-sharded render and train steps.

Counterpart of `voxel_tracer_tpu/parallel/sharding.py`.  Forward
rendering is embarrassingly parallel over rays: each rank traces its
contiguous block of rays against the replicated scene, with no
collective until the frame is assembled.  Training averages the voxel
parameters' gradients over RAYS with `all_reduce`, the analog of the
reference's missing gradient path (SURVEY.md §2.4).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from voxel_tracer_tpu_torch.models.camera import rays_for_image
from voxel_tracer_tpu_torch.ops import composite
from voxel_tracer_tpu_torch.ops.cuda import diff as diff_kernel
from voxel_tracer_tpu_torch.parallel.grid_train import (
    PARAM_NAMES, background_rgb, compose_slabs, make_optimizer, slab_origins)
from voxel_tracer_tpu_torch.parallel import mesh as pmesh
from voxel_tracer_tpu_torch.parallel.mesh import RAYS, Mesh
from voxel_tracer_tpu_torch.renderer import RenderConfig, render_rays


def sharded_render(mesh: Mesh, config: RenderConfig):
    """Ray-sharded full-frame render function.

    Each rank renders its contiguous block of image rows through
    `render_rays`, with the rows' global ray offset, so noise and shadow
    seeds are those of the unsharded frame; then every AOV is gathered
    over RAYS, so that every rank holds the full frame, as JAX's global
    arrays do.  No temporal accumulation (JAX's `sharded_render` has
    none).  Returns fn(scene, camera, frame) -> aov dict.
    """
    n = mesh.shape[RAYS]
    w, h = config.width, config.height
    assert h % n == 0, f"{h} rows must divide over {n} ray shards"
    rows = h // n
    local = dataclasses.replace(config, height=rows, accumulate=False)
    offset = mesh.coords[RAYS] * rows * w

    def render(scene, camera, frame):
        o, d = rays_for_image(camera, w, h, device=mesh.device)
        out = render_rays(scene, o[offset:offset + rows * w],
                          d[offset:offset + rows * w], frame, config=local,
                          ray_offset=offset)
        return {k: mesh.all_gather(RAYS, v).reshape((h,) + v.shape[1:])
                for k, v in out.items()}

    return render


def shard_rays(mesh: Mesh, origins, dirs):
    """This rank's RAYS blocks of a ray list: JAX's `shard_rays`, which
    places both arrays on the mesh, in the port's row-block placement."""
    return pmesh.shard_rays(mesh, origins), pmesh.shard_rays(mesh, dirs)


def make_sharded_trace(mesh: Mesh, config: RenderConfig):
    """Scene intersection sharded over RAYS, scene replicated, no
    collective: fn(scene, o, d) traces this rank's block of the rays and
    returns its HitResult."""

    def trace_shard(scene, o, d):
        return composite.intersect_scene(scene, *shard_rays(mesh, o, d),
                                         config.max_candidates, config.max_steps)

    return trace_shard


class _GradMean(torch.autograd.Function):
    """Identity whose backward averages the cotangent over one mesh axis:
    attached to a parameter slice, it places that slice's gradient
    all-reduce at the point of the backward pass where the slice's replay
    completes."""

    @staticmethod
    def forward(ctx, x, mesh: Mesh, axis: str):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.pmean(ctx.axis, g), None, None


def make_train_step(mesh: Mesh, optimizer, vpu: float, max_steps: int = 192,
                    background=None, sync_grads: bool = True,
                    overlap_slabs: int = 1, slab_max_steps: int | None = None):
    """Ray-sharded inverse-rendering train step (BASELINE config 5).

    params = {"sigma": (Z, Y, X), "albedo": (Z, Y, X, 3)}, replicated:
    leaf tensors with ``requires_grad``; o_l, d_l, target: this rank's
    RAYS shard; ``optimizer`` an Adam learning rate or a factory of a
    `torch.optim.Optimizer` over [sigma, albedo].  Returns
    step(params, opt, o_l, d_l, target) -> (params, opt, loss), the loss
    the mean over RAYS.  ``opt`` is the optimizer (None on the first call
    builds it, as `optax`'s `init`); parameters and moments are updated in
    place.

    sync_grads=False skips the gradient and loss reductions: the ranks
    then diverge, but each does the same local work, so the two timings
    isolate the collectives.

    overlap_slabs=S > 1 composes the loss from S z-slab renders
    (`grid_train.compose_slabs`), each slab's parameters behind a
    `_GradMean`, so each slab's gradient is averaged as soon as its
    backward replay completes; the same math and the same bytes as one
    reduction at the end.
    """
    S = overlap_slabs
    slab_steps = max_steps if slab_max_steps is None else slab_max_steps

    def local_loss(params, o_l, d_l, target):
        sigma, albedo = params["sigma"], params["albedo"]
        if S == 1:
            out = diff_kernel.render_density(sigma, albedo, o_l, d_l, vpu, max_steps)
            color, trans = out["color"], out["trans"]
        else:
            zs = sigma.shape[0] // S
            assert zs * S == sigma.shape[0], (
                f"Z={sigma.shape[0]} not divisible by overlap_slabs={S}")
            parts = []
            for s in range(S):
                sig, alb = sigma[s * zs:(s + 1) * zs], albedo[s * zs:(s + 1) * zs]
                if sync_grads:
                    sig = _GradMean.apply(sig, mesh, RAYS)
                    alb = _GradMean.apply(alb, mesh, RAYS)
                # the JAX step shifts by float32(s * zs / vpu)
                out = diff_kernel.render_density(
                    sig, alb, slab_origins(o_l, np.float32(s * zs / vpu)), d_l,
                    vpu, slab_steps)
                parts.append(out)
            color, trans, _ = compose_slabs(
                *(torch.stack([p[k] for p in parts])
                  for k in ("trans", "color", "depth")), d_l[:, 2])
        color = color + trans[:, None] * background_rgb(background, o_l.device)
        return torch.mean((color - target) ** 2)

    def step(params, opt, o_l, d_l, target):
        if opt is None:
            opt = make_optimizer(params, optimizer)
        loss = local_loss(params, o_l, d_l, target)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        loss = loss.detach()
        if sync_grads:
            if S == 1:
                for k in PARAM_NAMES:
                    params[k].grad = mesh.pmean(RAYS, params[k].grad)
            loss = mesh.pmean(RAYS, loss)
        opt.step()
        return params, opt, loss

    return step
