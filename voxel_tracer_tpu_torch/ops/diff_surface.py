"""Differentiable SURFACE rendering: gradients through the Lambert shading
of the discrete voxel hit (BASELINE config 2, "512^2 diff. Lambertian").

Counterpart of `voxel_tracer_tpu/ops/diff_surface.py`.  Which voxel a ray
hits is not a continuous function of the appearance parameters, so the
traversal's outputs -- hit mask, material id, normal, depth, shadow
visibility -- are detached constants, like the reference's fixed geometry.
What is differentiable is the appearance model evaluated on those hits:

    color = palette[mat] * (sun_light * max(n . sun_dir, 0) * vis + ambient)
            + miss * sky

with parameters (palette, sun_light, ambient, sky).  `torch.autograd`
carries the gradient through the palette gather (a scatter-add in the
backward pass) and the shading arithmetic.  Geometry gradients are the
volumetric path's (`ops/diff.py`); the two compose.

`render_lambert_surface` takes its hits from the wavefront DDA
(`ops/composite.py`, on the D1 kernel), `render_lambert_surface_mega`
from the kernels' lit frame (`ops/cuda/mega.render_lambert_mega`: B1 for
the primary rays, B2 for the shadow rays).
"""

from __future__ import annotations

import torch

from voxel_tracer_tpu_torch.models.skydome import sample_sky
from voxel_tracer_tpu_torch.ops import composite
from voxel_tracer_tpu_torch.ops.math3d import BIG_F32, dot


def _albedo(palette, mat):
    return palette[torch.clamp(mat, 0, 255).long()]


def render_lambert_surface(palette, scene, origins, dirs, sun_light=None,
                           ambient=0.2, max_candidates: int = 4,
                           max_steps: int = 256, *, isect=composite):
    """Lambert surface render, differentiable w.r.t. ``palette`` (256, 3)
    (and ``sun_light`` (3,) if given); the scene's geometry gives the hits
    and its own palette is not read.  ``isect``: the traversal backend
    (`ops/composite`, on D1 for CUDA tensors, or `composite.PLAIN`).

    Returns dict(color (N, 3), hit (N,), mat (N,))."""
    sl = scene.sun_light if sun_light is None else sun_light

    hit = isect.intersect_scene(scene, origins, dirs, max_candidates, max_steps)
    t, mat, normal = hit.t.detach(), hit.mat.detach(), hit.normal.detach()
    missed = t >= BIG_F32

    p = origins + dirs * t[:, None] + normal * 1e-4
    incidence = dot(normal, scene.sun_dir)
    occluded, _ = isect.is_occluded(
        scene, p, torch.broadcast_to(scene.sun_dir, p.shape), BIG_F32,
        max_candidates, shadow_seed=None)
    vis = ((incidence > 0.0) & ~occluded).to(torch.float32).detach()

    irr = sl * (torch.clamp(incidence, min=0.0) * vis)[:, None] + ambient
    sky = sample_sky(scene.sky, dirs)
    color = torch.where(missed[:, None], sky, _albedo(palette, mat) * irr)
    return {"color": color, "hit": ~missed, "mat": mat}


def palette_fit_loss(palette, scene, origins, dirs, target, **kw):
    """MSE appearance-fitting loss; its gradient w.r.t. ``palette`` is the
    config-2 backward pass."""
    out = render_lambert_surface(palette, scene, origins, dirs, **kw)
    return torch.mean((out["color"] - target) ** 2)


def render_lambert_surface_mega(palette, mv, camera, width, height,
                                sun_light=None, ambient=0.2, *,
                                lambert_fn=None, **_tpu_options):
    """Kernel-backed `render_lambert_surface`: the discrete hits, normals
    and shadow visibility come from the lit frame on the kernels
    (``lambert_fn``, default `mega.render_lambert_mega`; pass
    `mega.render_lambert_mega_plain` for the plain version), and only the
    palette gather and the shading arithmetic are differentiated.  The
    JAX function's TPU tuning options (`interpret`, `tile_rows`, ...) are
    accepted and ignored.

    mv: `mega.MegaVolume`.  Returns dict(color (N, 3), hit (N,), mat (N,))."""
    from voxel_tracer_tpu_torch.models.camera import rays_for_image
    from voxel_tracer_tpu_torch.models.scene import SUN_DIR
    from voxel_tracer_tpu_torch.ops.cuda import mega

    lambert_fn = mega.render_lambert_mega if lambert_fn is None else lambert_fn
    out = lambert_fn(mv, camera, width, height, sun_light=sun_light, ambient=ambient)
    n = width * height
    mat = out["material"].reshape(n).detach()
    hit = out["depth"].reshape(n).detach() < BIG_F32
    # irradiance already folds incidence * shadow visibility + ambient
    irr = out["irradiance"].reshape(n, 3).detach()

    _, dirs = rays_for_image(camera, width, height, device=mv.device)
    sun = torch.as_tensor(SUN_DIR, device=mv.device)
    sky = torch.stack(mega._analytic_sky(dirs.unbind(-1), sun / torch.linalg.norm(sun)),
                      dim=-1)
    color = torch.where(hit[:, None], _albedo(palette, mat) * irr, sky)
    return {"color": color, "hit": hit, "mat": mat}


def palette_fit_loss_mega(palette, mv, camera, width, height, target, **kw):
    """MSE palette-fitting loss on the kernel-backed surface render."""
    out = render_lambert_surface_mega(palette, mv, camera, width, height, **kw)
    return torch.mean((out["color"] - target) ** 2)
