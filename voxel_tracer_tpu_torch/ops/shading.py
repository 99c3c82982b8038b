"""Shading: lights, shadows and material evaluation (wavefront style).

Counterpart of `voxel_tracer_tpu/ops/shading.py` (src/graphics/lighting/
materials.{h,cpp} and sphere-light.cpp).  The reference's recursive
Whitted evaluation (materials.cpp:15-48, <= 8 bounces) is a bounded
wavefront loop with masked per-ray state: every bounce intersects the
whole wavefront once and updates throughput and irradiance with `where`
selects.  It runs eagerly; the glass sub-loop is skipped by a Python
branch when no ray hit glass.

``isect`` swaps the traversal backend: this package's `ops/composite`
(the wavefront DDA, the default) or any object with the same
`intersect_scene` / `march_interior` / `is_occluded`, such as
`ops/cuda/whitted.MegaIntersector`, whose traversals run on the CUDA
kernels.  Shadow seeds are uint32 values carried in int64 tensors.

Spans (`utils/profiling.annotate`, off by default): `shade` around
`shade_full`, `shade.bounce` around each bounce, and in it the stages
whose traversals trace rows they then throw away, each naming the rows
it keeps: `shade.diffuse` (the diffuse rows), `shade.glass` (the glass
rows) with `shade.glass.march` and `shade.glass.scan` for each internal
reflection (the rows still inside, the rows whose later scan counts),
and `shade.continue` (the rows still alive).
"""

from __future__ import annotations

import math

import torch

from voxel_tracer_tpu_torch.models.skydome import sample_sky
from voxel_tracer_tpu_torch.ops import composite
from voxel_tracer_tpu_torch.ops.compact import masked_apply
from voxel_tracer_tpu_torch.ops.math3d import BIG_F32, cross, dot, normalize, reflect
from voxel_tracer_tpu_torch.ops.noise import _TEX_SIZE, sample_2d, sample_3d
from voxel_tracer_tpu_torch.ops.tonemap import clamp_color
from voxel_tracer_tpu_torch.utils import profiling

INVPI = 1.0 / math.pi
FOURPI = 4.0 * math.pi
MIN_REFLECT = 0.01  # materials.h MIN_REFLECT
_U32 = 0xFFFFFFFF


def _vec(v, like):
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def hit_point(origins, dirs, t, normal):
    """Offset intersection point (ray.h:51-53: + normal * 1e-4)."""
    return origins + dirs * t[:, None] + normal * 1e-4


def sun_light(scene, p, n, jitter3=None, max_candidates=4,
              shadow_seed=None, isect=composite):
    """Sun contribution with shadow ray (materials.cpp:226-244).  With
    ``shadow_seed`` the shadow ray uses stochastic glass/mirror
    pass-through (vv.cpp:314-327)."""
    sun_dir = scene.sun_dir
    if jitter3 is not None:
        intensity = 6.0 / 16.0
        sun_dir = normalize(sun_dir + jitter3 * intensity - intensity * 0.5)
    else:
        sun_dir = torch.broadcast_to(sun_dir, p.shape)
    incidence = dot(n, sun_dir)
    lit = incidence > 0.0
    occluded, _hit = isect.is_occluded(
        scene, p, sun_dir, BIG_F32, max_candidates, shadow_seed=shadow_seed)
    vis = lit & ~occluded
    return torch.where(vis[:, None], scene.sun_light * incidence[:, None], 0.0)


def cos_diffuse_reflect(n, r1, r2):
    """Cosine-weighted hemisphere direction around normal n."""
    theta = torch.arccos(torch.sqrt(torch.clamp(1.0 - r1, 0.0, 1.0)))
    phi = 2.0 * math.pi * r2
    xs = torch.sin(theta) * torch.cos(phi)
    ys = torch.cos(theta)
    zs = torch.sin(theta) * torch.sin(phi)
    # tangent frame: the axis least aligned with n
    ax, ay, az = torch.abs(n[..., 0:1]), torch.abs(n[..., 1:2]), torch.abs(n[..., 2:3])
    h = torch.where(
        (ax <= ay) & (ax <= az), _vec([1.0, 0.0, 0.0], n),
        torch.where(ay <= az, _vec([0.0, 1.0, 0.0], n), _vec([0.0, 0.0, 1.0], n)),
    ) + n * 0.0
    x = normalize(cross(h + n * 0.0 + 0.0, n) + 1e-12)
    z = normalize(cross(x, n))
    return normalize(xs[..., None] * x + ys[..., None] * n + zs[..., None] * z)


def ambient_light(scene, p, n, r2pair, max_candidates=4,
                  shadow_seed=None, isect=composite):
    """Ambient sky term: cosine-weighted ray, occlusion within 1 unit,
    sky sample / pdf, clamped (materials.cpp:249-269)."""
    amb_dir = cos_diffuse_reflect(n, r2pair[..., 0], r2pair[..., 1])
    occluded, _hit = isect.is_occluded(scene, p, amb_dir, 1.0, max_candidates,
                                       shadow_seed=shadow_seed)
    pdf = torch.clamp(dot(amb_dir, n) * INVPI, min=1e-6)
    sky = sample_sky(scene.sky, amb_dir) * 0.25
    contrib = clamp_color(sky / pdf[:, None], 8.0)
    return torch.where(occluded[:, None], 0.0, contrib)


def sphere_lights(scene, p, n, sample3, max_candidates=4,
                  shadow_seed=None, isect=composite, live=None):
    """Monte-Carlo spherical area lights (sphere-light.cpp:8-37).

    ``live`` (optional bool mask) parks dead rows' shadow rays: the shadow
    ray starts at the light's sampled point, so a parked surface point
    alone doesn't stop the traversal from doing real work."""
    lights = scene.lights
    total = torch.zeros_like(p)
    for li in range(lights.origin.shape[0]):
        origin = lights.origin[li]
        radius = lights.radius[li]
        diameter = radius * 2.0
        sample_point = origin + (sample3 * diameter - radius)
        ext = sample_point - p
        dist_sqr = dot(ext, ext)
        in_aoe = dist_sqr <= lights.aoe_sqr[li]
        dist = torch.sqrt(torch.clamp(dist_sqr, min=1e-12))
        sdir = ext / dist[:, None]
        incidence = dot(n, sdir)
        facing = incidence > 0.0
        # shadow ray from the sampled light point back toward the surface
        # (sphere-light.cpp:20-24)
        so, sdd = sample_point, -sdir
        if live is not None:
            so = torch.where(live[:, None], so, 1e6)
            sdd = torch.where(live[:, None], sdd, _vec([0.0, 0.0, 1.0], p))
        occluded, _hit = isect.is_occluded(
            scene, so, sdd, dist - 0.01, max_candidates, shadow_seed=shadow_seed)
        pdf = FOURPI * diameter
        intensity = lights.power[li] / (FOURPI * torch.clamp(dist_sqr, min=1e-12))
        contrib = lights.color[li] * (intensity * incidence * pdf)[:, None]
        ok = in_aoe & facing & ~occluded
        total = total + torch.where(ok[:, None], contrib, 0.0)
    return total


def diffuse_irradiance(scene, p, n, noise3, noise2, config, shadow_seed=None,
                       isect=composite, live=None):
    """Sphere lights + sun + ambient (materials.cpp:194-221)."""
    irr = torch.zeros_like(p)
    salt = shadow_seed
    if scene.lights.origin.shape[0] > 0:
        irr = irr + sphere_lights(scene, p, n, noise3, config.max_candidates,
                                  shadow_seed=salt, isect=isect, live=live)
    irr = irr + sun_light(scene, p, n, noise3, config.max_candidates,
                          shadow_seed=None if salt is None else salt ^ 0xA511E9B3,
                          isect=isect)
    irr = irr + ambient_light(scene, p, n, noise2, config.max_candidates,
                              shadow_seed=None if salt is None else salt ^ 0x63D83595,
                              isect=isect)
    return irr


def lambert_irradiance(scene, origins, dirs, hit, config, isect=composite):
    """Deterministic Lambertian shading: sun + shadow ray + flat ambient."""
    p = hit_point(origins, dirs, hit.t, hit.normal)
    sun = sun_light(scene, p, hit.normal, None, config.max_candidates,
                    isect=isect)
    return sun + config.ambient


def fresnel_reflect_prob(n1, n2, n, incident):
    """Schlick reflect probability with reflectivity floor
    (materials.cpp:271-289)."""
    r0 = ((n1 - n2) / (n1 + n2)) ** 2
    cos_x = -dot(n, incident)
    nd = n1 / n2
    sin_t2 = nd * nd * (1.0 - cos_x * cos_x)
    tir = sin_t2 > 1.0
    if n1 > n2:
        cos_x = torch.sqrt(torch.clamp(1.0 - sin_t2, 0.0, 1.0))
    x = 1.0 - cos_x
    ret = r0 + (1.0 - r0) * x ** 5
    ret = MIN_REFLECT + (1.0 - MIN_REFLECT) * ret
    return torch.where(tir, 1.0, ret) if n1 > n2 else ret


def refract(n, incident, eta):
    """Refraction direction; 0 on total internal reflection
    (materials.cpp:291-298)."""
    d = dot(n, incident)
    k = 1.0 - eta * eta * (1.0 - d * d)
    out = eta * incident - (eta * d + torch.sqrt(torch.clamp(k, min=0.0)))[..., None] * n
    out = normalize(out + 1e-20)
    return torch.where((k < 0.0)[..., None], 0.0, out)


def material_row(mat):
    """Material id -> row (materials.h:8-14): row = floor((id-1)/8);
    0 glass, 1 mirror, 15 unlit; ids are 1..255 when hit."""
    return torch.floor((mat.to(torch.float32) - 1.0) / 8.0).to(torch.int32)


def eval_glass_wavefront(scene, cur_o, cur_d, cur_hit, is_glass, config,
                         isect=composite):
    """Glass evaluation: bounded internal-reflection loop with Beer
    absorption and Fresnel splits (materials.cpp:119-189 semantics).

    Per iteration: march the interior to the exit (medium-aware DDA,
    vv.cpp:166-232), accumulate Beer's law over the total interior length,
    compute the Schlick reflect/refract split, and either emit a refracted
    scan ray or reflect internally and continue.  The first emitted scan
    ray becomes the wavefront continuation; later scans are evaluated
    terminally (sky on a miss, albedo x (shadowless sun Lambert + ambient)
    on a hit), as in the JAX function.

    Returns (cont_o, cont_d, cont_w, emitted, alb_acc, irr_acc).
    """
    n = cur_o.shape[0]
    dev = cur_o.device
    p = hit_point(cur_o, cur_d, cur_hit.t, cur_hit.normal)
    entry_dir = refract(cur_hit.normal, cur_d, 1.0 / 1.5)
    # nudge into the medium so the first tested voxel is the glass itself
    i_o = p + entry_dir * 1e-3
    i_d = entry_dir
    g_medium = torch.where(is_glass, cur_hit.mat, 0)
    absorption = -(1.0 - cur_hit.albedo)          # materials.cpp:130
    mul = torch.ones((n,), dtype=torch.float32, device=dev)
    absorb_t = torch.zeros((n,), dtype=torch.float32, device=dev)
    g_live = is_glass
    emitted = torch.zeros((n,), dtype=torch.bool, device=dev)
    cont_o, cont_d = p, cur_d
    cont_w = torch.ones((n, 3), dtype=torch.float32, device=dev)
    alb_acc = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    irr_acc = torch.zeros((n, 3), dtype=torch.float32, device=dev)

    for i in range(config.glass_reflections):
        with profiling.annotate("shade.glass.march", reflection=i, keep=g_live):
            i_hit = isect.march_interior(
                scene, cur_hit.obj, i_o, i_d, g_medium, config.max_steps)
        exit_p = i_o + i_d * i_hit.t[:, None]
        absorb_t = absorb_t + torch.where(g_live, i_hit.t, 0.0)
        absorb = torch.exp(absorption * 2.0 * absorb_t[:, None])
        refl = fresnel_reflect_prob(1.5, 1.0, i_d, i_hit.normal)
        refr = 1.0 - refl
        do_refract = refr >= 0.2                   # materials.cpp:148
        scan_d = refract(i_hit.normal, i_d, 1.5)
        scan_o = exit_p + i_hit.normal * 1e-4      # materials.cpp:159
        w = absorb * (refr * mul)[:, None]

        first = g_live & do_refract & ~emitted
        cont_o = torch.where(first[:, None], scan_o, cont_o)
        cont_d = torch.where(first[:, None], scan_d, cont_d)
        cont_w = torch.where(first[:, None], w, cont_w)
        emitted = emitted | first

        if i > 0:
            later = g_live & do_refract & ~first
            with profiling.annotate("shade.glass.scan", reflection=i, keep=later):
                s_hit = isect.intersect_scene(
                    scene, scan_o, scan_d, config.max_candidates,
                    config.max_steps, ignore=g_medium)
            s_miss = s_hit.t >= BIG_F32
            s_sky = sample_sky(scene.sky, scan_d)
            s_sun = torch.clamp(dot(s_hit.normal, scene.sun_dir), min=0.0)
            s_unlit = (material_row(s_hit.mat) == 15) | (s_hit.mat == 255)
            approx_irr = torch.where(
                s_unlit[:, None], 1.0,
                scene.sun_light * s_sun[:, None] + config.ambient)
            t_alb = torch.where(s_miss[:, None], s_sky, s_hit.albedo)
            t_irr = torch.where(s_miss[:, None], 1.0, approx_irr)
            alb_acc = alb_acc + torch.where(later[:, None], t_alb * w, 0.0)
            irr_acc = irr_acc + torch.where(later[:, None], t_irr * w, 0.0)

        # stop after a scan unless both split weights stay significant
        # (materials.cpp:163-181); TIR-ish rays (refr < 0.2) reflect
        # internally and continue without touching `mul`
        stop = do_refract & ((refl < 0.2) | (mul < 0.1))
        mul = torch.where(g_live & do_refract, mul * refl, mul)
        g_live = g_live & ~stop
        int_d = reflect(i_d, i_hit.normal)
        i_o = torch.where(g_live[:, None], exit_p + int_d * 1e-3, i_o)
        i_d = torch.where(g_live[:, None], int_d, i_d)

    return cont_o, cont_d, cont_w, emitted, alb_acc, irr_acc


def _over_rows(compact, mask, fn, args, fill):
    """Run the stage ``fn(live, idx, *args)`` over the rows of ``mask``.

    With ``compact`` this is `ops/compact.masked_apply`: ``fn`` sees the
    gathered rows alone (``live`` all True, ``idx`` their indices) and
    ``fill()`` gives each output where ``mask`` is False.  Otherwise
    ``fn`` runs on every row with ``mask`` as its live mask and ``idx``
    None, and ``fill`` is not called.
    """
    if compact:
        return masked_apply(mask, fn, args, fill())
    return fn(mask, None, *args)


@profiling.annotate("shade")
def shade_full(scene, origins, dirs, hit, frame, config, isect=composite,
               ray_offset: int = 0):
    """Full Whitted-style wavefront shading (materials.cpp:15-48 analog).

    Mirror rays multiply the albedo throughput and continue
    (materials.cpp:95-114); glass rays run `eval_glass_wavefront` and
    continue along their first refracted exit with the Beer/Fresnel weight
    on both throughputs; diffuse rays terminate with sphere-light + sun +
    ambient irradiance, their shadow rays seeded per (ray, frame, bounce).

    Compaction is decided here and in `_over_rows` alone.  With
    ``config.compact`` the bounce loop runs on the rays that hit anything,
    and each heavy stage inside (diffuse light queries, the glass
    sub-loop, the continuation trace) on its own live rows, gathered by
    `ops/compact.masked_apply`; without it every stage runs on every row
    and masks its results.  Each row carries its original ray index,
    ``ray_offset`` plus its row (a ray shard, `parallel.sharding.
    sharded_render`, draws the noise and seeds of the unsharded frame's
    rays); noise and seeds key on it, so the results equal the
    uncompacted call's bit for bit.
    Returns (albedo, irradiance), each (N, 3).
    """
    n = origins.shape[0]
    compact = config.compact
    ray_idx = torch.arange(n, device=origins.device) + ray_offset

    def body(live, _idx, o, d, rid, *h):
        return _bounces(scene, o, d, composite.HitResult(*h), live, rid, frame,
                        config, isect, compact)

    return _over_rows(
        compact, hit.t < BIG_F32, body, (origins, dirs, ray_idx, *hit),
        lambda: (torch.zeros((n, 3), dtype=torch.float32, device=origins.device),) * 2)


def _seed(idx, frame, bounce):
    """Per-ray shadow seed (uint32 in int64) keyed on the original ray
    index, the frame and the bounce (JAX shading.py:356-360)."""
    f = ((int(frame) & _U32) * 2654435761) & _U32
    s = (idx.long() * 0x9E3779B9 + f) & _U32
    return s ^ ((0x85EBCA77 * (bounce + 1)) & _U32)


def _bounces(scene, origins, dirs, hit, live, ray_idx, frame, config, isect,
             compact):
    """shade_full's bounce loop over its rows; ``live`` marks the rows that
    hit, ``ray_idx`` holds each row's original ray index."""
    n = origins.shape[0]
    dev = origins.device
    # samples computed once for every bounce
    noise3 = sample_3d(ray_idx % _TEX_SIZE, ray_idx // _TEX_SIZE, frame)
    noise2 = sample_2d(ray_idx % _TEX_SIZE, ray_idx // _TEX_SIZE, frame)

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def _diffuse_fn(_lv, _idx, p_g, nrm_g, n3_g, n2_g, rid_g):
        # called within the loop below: `bounce` is the current bounce
        return diffuse_irradiance(scene, p_g, nrm_g, n3_g, n2_g, config,
                                  shadow_seed=_seed(rid_g, frame, bounce), isect=isect)

    def _glass_fn(lv, _idx, o_g, d_g, t_g, nrm_g, mat_g, alb_g, obj_g):
        # rows that are not glass trace from far away: their slab tests
        # reject them at once (gathered rows are all glass)
        o_g = torch.where(lv[:, None], o_g, 1e6)
        d_g = torch.where(lv[:, None], d_g, _vec([0.0, 0.0, 1.0], d_g))
        ghit = composite.HitResult(
            t=t_g, mat=mat_g, normal=nrm_g, albedo=alb_g,
            steps=torch.zeros_like(mat_g), obj=obj_g)
        return eval_glass_wavefront(scene, o_g, d_g, ghit, lv, config, isect=isect)

    def _continue_fn(lv, _idx, o_g, d_g, ign_g, ta_g, ti_g):
        # the continuation's hit record, and the sky terms of the rows
        # that miss
        h = isect.intersect_scene(scene, o_g, d_g, config.max_candidates,
                                  config.max_steps, ignore=ign_g)
        sky_g = sample_sky(scene.sky, d_g)
        m_g = (lv & (h.t >= BIG_F32))[:, None]
        return (*h, torch.where(m_g, ta_g * sky_g, 0.0), torch.where(m_g, ti_g, 0.0))

    albedo_out = zeros(n, 3)
    irr_out = zeros(n, 3)
    thr_a = torch.ones((n, 3), dtype=torch.float32, device=dev)  # albedo side
    thr_i = torch.ones((n, 3), dtype=torch.float32, device=dev)  # irradiance side
    cur_o, cur_d = origins, dirs
    cur_hit = hit

    for bounce in range(config.max_bounces):
        with profiling.annotate("shade.bounce", bounce=bounce):
            row = material_row(cur_hit.mat)
            is_unlit = (row == 15) | (cur_hit.mat == 255)
            is_glass = live & (row == 0) & ~is_unlit
            is_mirror = live & (row == 1) & ~is_unlit
            is_diffuse = live & ~(is_glass | is_mirror | is_unlit)

            p = hit_point(cur_o, cur_d, cur_hit.t, cur_hit.normal)

            # --- diffuse terminate ---------------------------------------------
            with profiling.annotate("shade.diffuse", bounce=bounce, keep=is_diffuse):
                irr = _over_rows(compact, is_diffuse, _diffuse_fn,
                                 (p, cur_hit.normal, noise3, noise2, ray_idx),
                                 lambda: zeros(n, 3))
            albedo_out = albedo_out + torch.where(
                is_diffuse[:, None], thr_a * cur_hit.albedo, 0.0)
            irr_out = irr_out + torch.where(is_diffuse[:, None], thr_i * irr, 0.0)

            # --- unlit terminate (laser/unlit rows, materials.cpp:23-27,39-42) -
            unlit_mask = live & is_unlit
            albedo_out = albedo_out + torch.where(
                unlit_mask[:, None], thr_a * cur_hit.albedo, 0.0)
            irr_out = irr_out + torch.where(unlit_mask[:, None], thr_i, 0.0)

            live = is_mirror | is_glass
            if bounce == config.max_bounces - 1:
                break

            # --- mirror bounce (materials.cpp:95-114) ---------------------------
            mir_d = reflect(cur_d, cur_hit.normal)

            # --- glass sub-loop, skipped when no ray hit glass ------------------
            with profiling.annotate("shade.glass", bounce=bounce, keep=is_glass):
                ones3 = torch.ones((n, 3), dtype=torch.float32, device=dev)
                no_glass = (cur_o, cur_d, ones3, zeros(n, dtype=torch.bool),
                            zeros(n, 3), zeros(n, 3))
                glass = no_glass
                if bool(is_glass.any()):
                    glass = _over_rows(
                        compact, is_glass, _glass_fn,
                        (cur_o, cur_d, cur_hit.t, cur_hit.normal, cur_hit.mat,
                         cur_hit.albedo, cur_hit.obj),
                        lambda: no_glass)
            cont_o, cont_d, cont_w, emitted, g_alb, g_irr = glass

            # terminal contributions from internal reflections past the 1st exit
            albedo_out = albedo_out + thr_a * g_alb
            irr_out = irr_out + thr_i * g_irr

            # continuation ray + throughput updates
            next_o = torch.where(is_glass[:, None], cont_o, p)
            next_d = torch.where(is_glass[:, None], cont_d, mir_d)
            thr_a = torch.where(is_mirror[:, None], thr_a * cur_hit.albedo, thr_a)
            thr_a = torch.where(is_glass[:, None], thr_a * cont_w, thr_a)
            thr_i = torch.where(is_glass[:, None], thr_i * cont_w, thr_i)
            live = is_mirror | (is_glass & emitted)

            # scan rays ignore their own medium until they see air
            ign = torch.where(is_glass, cur_hit.mat, 0)
            cur_o, cur_d = next_o, next_d
            with profiling.annotate("shade.continue", bounce=bounce, keep=live):
                # without compaction the rows that are not live are traced
                # too, and their records build the next bounce's rays
                *rec, sky_alb, sky_irr = _over_rows(
                    compact, live, _continue_fn, (cur_o, cur_d, ign, thr_a, thr_i),
                    lambda: (*composite.HitResult.miss(n, dev), zeros(n, 3), zeros(n, 3)))
                cur_hit = composite.HitResult(*rec)
                albedo_out = albedo_out + sky_alb
                irr_out = irr_out + sky_irr
                live = live & (cur_hit.t < BIG_F32)

    return albedo_out, irr_out
