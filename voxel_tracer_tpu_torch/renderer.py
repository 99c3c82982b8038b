"""Renderer: end-to-end frame rendering on the wavefront path.

Counterpart of `voxel_tracer_tpu/renderer.py` (src/graphics/renderer.
{h,cpp}): ray generation -> scene intersection -> shading -> tonemap,
run eagerly (no `jit`).  The per-pixel loop (renderer.cpp:199-223) is a
flat ray wavefront; display modes (dev/dev.h:36-46) are AOV outputs
returned beside the image.

`render_rays` takes any traversal backend (``isect``): `ops/composite`,
the wavefront DDA on the D1 kernel (its plain loop for CPU tensors), by
default; `composite.PLAIN`, every traversal on the plain loop; or
`ops/cuda/whitted.MegaIntersector`, on which `render_whitted_mega` runs
the same shading with every traversal on the B1 / B2 kernels.
`Renderer(config, isect=...)` renders its frames on that backend.

Spans (`utils/profiling.annotate`, off by default): each `Renderer.render`
call is a root `frame` span whose ``frame_id`` counts the renderer's
calls (`Renderer.renders`), with `raygen`, and `sky` and `tonemap` in
`render_rays`; the traversals and shading stages beneath open their own.
"""

from __future__ import annotations

import dataclasses

import torch

from voxel_tracer_tpu_torch.models.camera import Camera, rays_for_image
from voxel_tracer_tpu_torch.models.skydome import sample_sky
from voxel_tracer_tpu_torch.ops import composite, tonemap
from voxel_tracer_tpu_torch.ops.math3d import BIG_F32
from voxel_tracer_tpu_torch.utils import profiling


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render settings (the reference's compile-time defines,
    template/common.h:6-30)."""

    width: int = 1280
    height: int = 720
    shading: str = "full"        # flat | lambert | full
    max_steps: int = 256         # vv.cpp:7 MAX_STEPS
    max_candidates: int = 4      # per-ray candidate objects (BVH front size)
    max_bounces: int = 8         # materials.cpp:16 recursion cap
    glass_reflections: int = 4   # glass internal-reflection cap (reference
                                 # MAX_REFLECTIONS = 8, materials.cpp:128)
    tonemapper: str = "aces"     # aces | reinhard | uncharted2 | none
    ambient: float = 0.2         # flat ambient for lambert mode
    accumulate: bool = False     # temporal reprojection (renderer.cpp:273)
    compact: bool = False        # live-ray compaction in shade_full
                                 # (ops/compact.py)
    compact_fracs: tuple = (1 / 64, 1 / 16, 1 / 2)  # kept for the JAX
                                                    # signature; unused

    @property
    def aspect(self) -> float:
        return self.width / self.height


def empty_accu(width, height, device):
    """An accumulator that rejects all history: depth BIG everywhere."""
    return torch.cat([torch.zeros((height, width, 3), device=device),
                      torch.full((height, width, 1), BIG_F32, device=device)],
                     dim=-1)


class Renderer:
    """Owns the config and the frame counter; ``device`` is where rays
    are made (the scene's `SceneData` must live there too).

    With ``config.accumulate`` the renderer carries the temporal
    accumulator and the previous frame's view pyramid across `render`
    calls (renderer.cpp:240-244, camera.cpp:3-16) and blends 95 % history
    with depth rejection (renderer.cpp:273-329).  ``isect`` is the
    traversal backend of every frame (`render_rays`)."""

    def __init__(self, config: RenderConfig = RenderConfig(), device="cuda", *,
                 isect=composite):
        self.config = config
        self.device = torch.device(device)
        self.isect = isect
        self.frame = 0
        self.renders = 0           # render calls: the frame id of their spans
        self._accu = None          # (H, W, 4) irradiance + depth history
        self._prev_planes = None   # (4, 4) previous-frame pyramid planes

    def camera(self, pos, target) -> Camera:
        return Camera.create(pos, target, self.config.aspect)

    def reset_history(self):
        self._accu = None
        self._prev_planes = None

    def render(self, scene, camera: Camera, frame: int | None = None,
               depth_delta: float = 0.0):
        """Render one frame; returns a dict with 'image' (H, W, 3) float32
        in [0, 1] plus AOVs: albedo, irradiance, color, depth, normal,
        steps, material (and accu with ``config.accumulate``).

        depth_delta: camera forward motion since the previous frame
        (player.cpp:7-53), compensates the depth rejection."""
        cfg = self.config
        self.renders += 1
        with profiling.annotate("frame", frame_id=self.renders, width=cfg.width,
                                height=cfg.height, shading=cfg.shading):
            return self._render(scene, camera, frame, depth_delta)

    def _render(self, scene, camera, frame, depth_delta):
        cfg = self.config
        if frame is None:
            frame = self.frame
            self.frame = (self.frame + 1) % 120  # renderer.cpp:161-162
        with profiling.annotate("raygen"):
            origins, dirs = rays_for_image(camera, cfg.width, cfg.height,
                                           device=self.device)
        if not cfg.accumulate:
            return render_rays(scene, origins, dirs, frame, config=cfg, isect=self.isect)
        if self._accu is None:
            self._accu = empty_accu(cfg.width, cfg.height, self.device)
            self._prev_planes = camera.planes
        out = render_rays(scene, origins, dirs, frame, config=cfg,
                          prev_accu=self._accu, prev_planes=self._prev_planes,
                          depth_delta=depth_delta, isect=self.isect)
        self._accu = out["accu"]
        self._prev_planes = camera.planes  # Camera::tick prev_pyramid save
        return out


_TONEMAPS = {"aces": tonemap.aces_approx, "reinhard": tonemap.reinhard,
             "uncharted2": tonemap.uncharted2, "none": lambda x: x}


def render_rays(scene, origins, dirs, frame, *, config: RenderConfig,
                prev_accu=None, prev_planes=None, depth_delta=0.0,
                isect=composite, primary_hit=None, ray_offset=0):
    """Render a ray wavefront (origins, dirs: (H*W, 3), row-major).

    ``isect`` swaps the traversal backend: any module or object with
    composite-compatible `intersect_scene` / `march_interior` /
    `is_occluded`.  ``primary_hit`` supplies a precomputed primary
    HitResult (e.g. from the camera kernel), so the primary intersect is
    skipped.  ``ray_offset``: the global index of the first ray, when the
    wavefront is a block of a larger frame's rays (full shading keys its
    noise and shadow seeds on it)."""
    from voxel_tracer_tpu_torch.ops.shading import lambert_irradiance, shade_full

    w, h = config.width, config.height
    if primary_hit is None:
        hit = isect.intersect_scene(
            scene, origins, dirs, config.max_candidates, config.max_steps)
    else:
        hit = primary_hit
    missed = hit.t >= BIG_F32

    with profiling.annotate("sky"):
        sky = sample_sky(scene.sky, dirs)
    albedo = torch.where(missed[:, None], sky, hit.albedo)

    if config.shading == "flat":
        irradiance = torch.ones_like(albedo)
    elif config.shading == "lambert":
        irradiance = lambert_irradiance(scene, origins, dirs, hit, config,
                                        isect=isect)
    else:
        albedo, irradiance = shade_full(
            scene, origins, dirs, hit, frame, config, isect=isect,
            ray_offset=ray_offset)
        albedo = torch.where(missed[:, None], sky, albedo)

    irradiance = torch.where(missed[:, None], 1.0, torch.clamp(irradiance, min=0.0))

    out = {}
    if config.accumulate and prev_accu is not None:
        # temporal reprojection of the irradiance (renderer.cpp:205-221:
        # albedo stays crisp, the noisy lighting term is history-blended)
        from voxel_tracer_tpu_torch.ops.reproject import reproject_accumulate
        hit_points = origins + dirs * hit.t[:, None]
        irradiance, new_accu = reproject_accumulate(
            irradiance, hit.t, hit_points, prev_accu, prev_planes, w, h,
            depth_delta=depth_delta, reproject_mask=~missed)
        out["accu"] = new_accu
    color = albedo * irradiance
    with profiling.annotate("tonemap"):
        image = _TONEMAPS[config.tonemapper](color)

    shp = (h, w)
    out.update(
        image=image.reshape(h, w, 3),
        albedo=albedo.reshape(h, w, 3),
        irradiance=irradiance.reshape(h, w, 3),
        color=color.reshape(h, w, 3),
        depth=hit.t.reshape(shp),
        normal=hit.normal.reshape(h, w, 3),
        steps=hit.steps.reshape(shp),
        material=hit.mat.reshape(shp),
    )
    return out
