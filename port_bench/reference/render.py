"""The reference frame: scene composition, Whitted shading and tonemap.

A frozen plain copy, in plain PyTorch, of what the port's wavefront
`Renderer.render` computes (the JAX package's `renderer.py`,
`ops/composite.py`, `ops/shading.py` and `ops/noise.py` semantics):
raygen -> nearest hit over the scene's volumes (slab prepass, one DDA
pass a candidate) -> flat, lambert or full Whitted shading (sphere
lights, sun, ambient, mirror, glass with Beer absorption and Fresnel
splits, stochastic shadow rays seeded per ray, frame and bounce) -> sky
on misses -> tonemap.  It works everything out from the raw arrays the
benchmark made (`RefScene.build`): tables, noise textures, seeds.

Two hooks serve the benchmark and change nothing of the arithmetic when
left at their defaults: ``scene.q`` rounds each stage's float outputs
(identity here; bfloat16 storage for the control), and ``scene.calls``
records every traversal call's rays and DDA steps (for D1's roofline).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from port_bench.reference import dda
from port_bench.reference.geometry import (
    BIG, TONEMAPS, clamp_color, cross, dot, normalize, rays_for_image, reflect,
    sample_sky, to_local)

INVPI = 1.0 / math.pi
FOURPI = 4.0 * math.pi
MIN_REFLECT = 0.01
_U32 = 0xFFFFFFFF
TEX = 128
R2 = 1.22074408460575947536
R2_3D = (1.0 / R2, 1.0 / R2 ** 2, 1.0 / R2 ** 3)
R2_2D = (1.0 / 1.32471795724474602596, 1.0 / 1.32471795724474602596 ** 2)


def identity(x):
    return x


def bf16(x):
    """The control's storage precision: float32 rounded to bfloat16."""
    return x.to(torch.bfloat16).to(torch.float32)


class Group(NamedTuple):
    """Volumes of one grid shape, each field with a leading object axis."""

    grid: torch.Tensor        # (O, Z, Y, X) int32
    brick_occ: torch.Tensor   # (O, BZ, BY, BX) int32
    palette: torch.Tensor     # (O, 256, 3)
    rot: torch.Tensor         # (O, 3, 3)
    pos: torch.Tensor         # (O, 3)
    pivot: torch.Tensor       # (O, 3)
    vpu: torch.Tensor         # (O,)


class RefScene(NamedTuple):
    groups: tuple
    sun_dir: torch.Tensor
    sun_light: torch.Tensor
    light_origin: torch.Tensor   # (L, 3)
    light_radius: torch.Tensor   # (L,)
    light_color: torch.Tensor    # (L, 3)
    light_power: torch.Tensor    # (L,)
    light_aoe: torch.Tensor      # (L,) power / 4 pi
    sky: torch.Tensor            # (H, W, 3)
    tex2: torch.Tensor           # (128, 128, 2) noise
    tex3: torch.Tensor           # (128, 128, 3) noise
    q: object = identity
    calls: list = None

    @staticmethod
    def build(volumes, lights, sky, sun_dir, sun_light, device, q=identity):
        """``volumes``: [(grid uint8 (Z, Y, X), palette (256, 3), pos (3,),
        vpu)] with identity rotation and a centred pivot; ``lights``:
        [(origin, radius, color, power)]."""
        by_shape = {}
        for v in volumes:
            by_shape.setdefault(v[0].shape, []).append(v)
        groups = []
        for _shape, vols in sorted(by_shape.items()):
            fields = [_volume(*v, device) for v in vols]
            groups.append(Group(*(torch.stack(f) for f in zip(*fields))))

        def f32(xs, shape):
            return torch.tensor(np.array(xs, np.float32).reshape(shape), device=device)

        nl = len(lights)
        power = f32([l[3] for l in lights], (nl,))
        return RefScene(
            groups=tuple(groups), sun_dir=f32(sun_dir, (3,)), sun_light=f32(sun_light, (3,)),
            light_origin=f32([l[0] for l in lights], (nl, 3)),
            light_radius=f32([l[1] for l in lights], (nl,)),
            light_color=f32([l[2] for l in lights], (nl, 3)), light_power=power,
            light_aoe=power / (4.0 * np.pi),
            sky=torch.tensor(np.ascontiguousarray(sky, np.float32), device=device),
            tex2=torch.tensor(noise_texture(2), device=device),
            tex3=torch.tensor(noise_texture(3), device=device), q=q, calls=[])


def brick_counts(grid):
    """8^3 brick occupancy counts of a (Z, Y, X) grid."""
    gz, gy, gx = grid.shape
    bz, by, bx = (-(-s // 8) for s in (gz, gy, gx))
    pad = np.zeros((bz * 8, by * 8, bx * 8), np.uint8)
    pad[:gz, :gy, :gx] = grid != 0
    return pad.reshape(bz, 8, by, 8, bx, 8).sum(axis=(1, 3, 5)).astype(np.int32)


def _volume(grid, palette, pos, vpu, device):
    grid = np.ascontiguousarray(grid, np.uint8)
    gz, gy, gx = grid.shape
    vpu = float(vpu)
    size = np.array([gx, gy, gz], np.float32) / vpu
    pivot = size * 0.5

    def f32(v):
        return torch.tensor(np.asarray(v, np.float32), device=device)

    return (torch.tensor(grid.astype(np.int32), device=device),
            torch.tensor(brick_counts(grid), device=device), f32(palette),
            f32(np.eye(3)), f32(pos), f32(pivot), f32(vpu))


def noise_texture(channels):
    """(128, 128, C) float32 noise: seeded values pushed toward blue noise
    by two high-pass passes (the stand-in for the reference's PNGs)."""
    rng = np.random.RandomState(12345 + channels)
    tex = rng.rand(TEX, TEX, channels).astype(np.float32)
    for c in range(channels):
        ch = tex[..., c]
        for _ in range(2):
            blur = (np.roll(ch, 1, 0) + np.roll(ch, -1, 0)
                    + np.roll(ch, 1, 1) + np.roll(ch, -1, 1)) * 0.25
            ch = np.clip(ch + 0.5 * (ch - blur), 0.0, 1.0)
        tex[..., c] = ch
    return tex


def _sample(tex, idx, frame, r2):
    xs, ys = idx % TEX, idx // TEX
    base = tex[torch.remainder(ys, TEX).long(), torch.remainder(xs, TEX).long()]
    f = torch.as_tensor(frame).to(base.device, torch.float32) + 0.0
    return torch.remainder(base + torch.tensor(r2, dtype=torch.float32,
                                               device=base.device) * f, 1.0)


# ---------------------------------------------------------------------------
# Composition
# ---------------------------------------------------------------------------

class Hit(NamedTuple):
    t: torch.Tensor
    mat: torch.Tensor
    normal: torch.Tensor
    albedo: torch.Tensor
    steps: torch.Tensor
    obj: torch.Tensor

    @staticmethod
    def miss(n, device):
        return Hit(torch.full((n,), BIG, dtype=torch.float32, device=device),
                   torch.zeros((n,), dtype=torch.int32, device=device),
                   torch.zeros((n, 3), dtype=torch.float32, device=device),
                   torch.zeros((n, 3), dtype=torch.float32, device=device),
                   torch.zeros((n,), dtype=torch.int32, device=device),
                   torch.full((n,), -1, dtype=torch.int32, device=device))

    def nearer(self, o):
        take = o.t < self.t
        return Hit(torch.where(take, o.t, self.t), torch.where(take, o.mat, self.mat),
                   torch.where(take[:, None], o.normal, self.normal),
                   torch.where(take[:, None], o.albedo, self.albedo),
                   self.steps + o.steps, torch.where(take, o.obj, self.obj))


def _dda(scene, grid, bocc, o_l, d_l, vpu, **kw):
    res = dda.intersect_volume_local(grid, bocc, o_l, d_l, vpu, **kw)
    tables = grid.numel() * grid.element_size() + bocc.numel() * bocc.element_size()
    scene.calls.append({"rays": o_l.shape[0], "steps": int(res["steps"].sum()),
                        "modes": sorted(k for k in kw if kw[k] is not None
                                        and k != "max_steps" and kw[k] is not False),
                        "per_ray_vpu": isinstance(vpu, torch.Tensor) and vpu.ndim == 1,
                        "table_bytes": tables})
    return res


def _hit_of(scene, res, hit, rot, albedo, obj, steps):
    q = scene.q
    normal = dda.normal_from_axis(res["axis"], res["step_sign"], rot)
    return Hit(t=q(torch.where(hit, res["t"], BIG)), mat=torch.where(hit, res["mat"], 0),
               normal=q(torch.where(hit[:, None], normal, 0.0)),
               albedo=q(torch.where(hit[:, None], albedo, 0.0)), steps=steps,
               obj=obj)


def _trace_one(scene, g, origins, dirs, max_steps, obj_base, **kw):
    rot = g.rot[0]
    o_l, d_l = to_local(rot, g.pos[0], g.pivot[0], origins, dirs)
    res = _dda(scene, g.grid[0], g.brick_occ[0], o_l, d_l, g.vpu[0], max_steps=max_steps, **kw)
    hit = res["t"] < BIG
    albedo = g.palette[0][torch.clamp(res["mat"], 0, 255).long()]
    return _hit_of(scene, res, hit, rot, albedo,
                   torch.where(hit, obj_base, -1).to(torch.int32), res["steps"])


def _prepass(g, origins, dirs, k):
    n, dev = origins.shape[0], origins.device
    gz, gy, gx = g.grid.shape[-3:]
    vsize = torch.tensor([gx, gy, gz], dtype=torch.float32, device=dev)
    tk = torch.full((n, k), BIG, dtype=torch.float32, device=dev)
    idk = torch.zeros((n, k), dtype=torch.int32, device=dev)
    for oid in range(g.grid.shape[0]):
        o_l, d_l = to_local(g.rot[oid], g.pos[oid], g.pivot[oid], origins, dirs)
        tmin, _tmax, _ax, ok = dda.slab_test(o_l, d_l, vsize / g.vpu[oid])
        t = torch.where(ok, tmin, BIG)
        o = torch.full((n,), oid, dtype=torch.int32, device=dev)
        for j in range(k):
            cur_t, cur_i = tk[:, j].clone(), idk[:, j].clone()
            take = t < cur_t
            tk[:, j] = torch.where(take, t, cur_t)
            idk[:, j] = torch.where(take, o, cur_i)
            t = torch.where(take, cur_t, t)
            o = torch.where(take, cur_i, o)
    return tk, idk


def _group_hit(scene, g, origins, dirs, k, max_steps, obj_base, **kw):
    n = origins.shape[0]
    if g.grid.shape[0] == 1:
        return _trace_one(scene, g, origins, dirs, max_steps, obj_base, **kw)
    k = min(k, g.grid.shape[0])
    cand_t, cand_id = _prepass(g, origins, dirs, k)
    best = Hit.miss(n, origins.device)
    pal = g.palette.reshape(-1, 3)
    for slot in range(k):
        oid = cand_id[:, slot].long()
        live = (cand_t[:, slot] < BIG) & (cand_t[:, slot] < best.t)
        rot = g.rot[oid]
        o_l, d_l = to_local(rot, g.pos[oid], g.pivot[oid], origins, dirs)
        res = _dda(scene, g.grid, g.brick_occ, o_l, d_l, g.vpu[oid], oid=oid,
                   max_steps=max_steps, **kw)
        hit = live & (res["t"] < BIG)
        albedo = pal[oid * 256 + torch.clamp(res["mat"], 0, 255).long()]
        best = best.nearer(_hit_of(
            scene, res, hit, rot, albedo,
            torch.where(hit, obj_base + oid.to(torch.int32), -1).to(torch.int32),
            torch.where(live, res["steps"], 0)))
    return best


def intersect(scene, origins, dirs, k, max_steps, ignore=None, shadow_seed=None):
    """Nearest hit over every group; ``ignore`` the scan-ray pass-through,
    ``shadow_seed`` the stochastic shadow semantics."""
    kw = {}
    if ignore is not None:
        kw["ignore"] = ignore
    if shadow_seed is not None:
        kw.update(shadow=True, shadow_seed=shadow_seed)
    best = Hit.miss(origins.shape[0], origins.device)
    base = 0
    for g in scene.groups:
        best = best.nearer(_group_hit(scene, g, origins, dirs, k, max_steps, base, **kw))
        base += g.grid.shape[0]
    return best


def march_interior(scene, obj, origins, dirs, medium, max_steps):
    n = origins.shape[0]
    out = Hit.miss(n, origins.device)
    base = 0
    for g in scene.groups:
        count = g.grid.shape[0]
        oid = torch.clamp(obj - base, 0, count - 1).long()
        sel = (obj >= base) & (obj < base + count)
        rot = g.rot[oid]
        o_l, d_l = to_local(rot, g.pos[oid], g.pivot[oid], origins, dirs)
        res = _dda(scene, g.grid, g.brick_occ, o_l, d_l, g.vpu[oid],
                   oid=oid if count > 1 else None, max_steps=max_steps, medium=medium)
        normal = dda.normal_from_axis(res["axis"], res["step_sign"], rot)
        albedo = g.palette.reshape(-1, 3)[oid * 256 + torch.clamp(res["mat"], 0, 255).long()]
        q = scene.q
        out = Hit(t=q(torch.where(sel, res["t"], out.t)),
                  mat=torch.where(sel, res["mat"], out.mat),
                  normal=q(torch.where(sel[:, None], normal, out.normal)),
                  albedo=q(torch.where(sel[:, None], albedo, out.albedo)),
                  steps=torch.where(sel, res["steps"], out.steps),
                  obj=torch.where(sel, obj.to(torch.int32), out.obj))
        base += count
    return out


def occluded(scene, origins, dirs, tmax, k, shadow_seed=None):
    """Shadow rays walk the DDA's own 256-step budget, whatever the frame's."""
    return intersect(scene, origins, dirs, k, dda.MAX_STEPS, shadow_seed=shadow_seed).t < tmax


# ---------------------------------------------------------------------------
# Shading
# ---------------------------------------------------------------------------

def _vec(v, like):
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def hit_point(origins, dirs, t, normal):
    return origins + dirs * t[:, None] + normal * 1e-4


def sun_light(scene, p, n, jitter3, cfg, shadow_seed=None):
    sun_dir = scene.sun_dir
    if jitter3 is not None:
        intensity = 6.0 / 16.0
        sun_dir = normalize(sun_dir + jitter3 * intensity - intensity * 0.5)
    else:
        sun_dir = torch.broadcast_to(sun_dir, p.shape)
    incidence = dot(n, sun_dir)
    occ = occluded(scene, p, sun_dir, BIG, cfg["max_candidates"], shadow_seed)
    vis = (incidence > 0.0) & ~occ
    return scene.q(torch.where(vis[:, None], scene.sun_light * incidence[:, None], 0.0))


def cos_diffuse_reflect(n, r1, r2):
    theta = torch.arccos(torch.sqrt(torch.clamp(1.0 - r1, 0.0, 1.0)))
    phi = 2.0 * math.pi * r2
    xs = torch.sin(theta) * torch.cos(phi)
    ys = torch.cos(theta)
    zs = torch.sin(theta) * torch.sin(phi)
    ax, ay, az = torch.abs(n[..., 0:1]), torch.abs(n[..., 1:2]), torch.abs(n[..., 2:3])
    h = torch.where((ax <= ay) & (ax <= az), _vec([1.0, 0.0, 0.0], n),
                    torch.where(ay <= az, _vec([0.0, 1.0, 0.0], n),
                                _vec([0.0, 0.0, 1.0], n))) + n * 0.0
    x = normalize(cross(h + n * 0.0 + 0.0, n) + 1e-12)
    z = normalize(cross(x, n))
    return normalize(xs[..., None] * x + ys[..., None] * n + zs[..., None] * z)


def ambient_light(scene, p, n, r2pair, cfg, shadow_seed=None):
    amb = cos_diffuse_reflect(n, r2pair[..., 0], r2pair[..., 1])
    occ = occluded(scene, p, amb, 1.0, cfg["max_candidates"], shadow_seed)
    pdf = torch.clamp(dot(amb, n) * INVPI, min=1e-6)
    contrib = clamp_color(scene.q(sample_sky(scene.sky, amb)) * 0.25 / pdf[:, None], 8.0)
    return scene.q(torch.where(occ[:, None], 0.0, contrib))


def sphere_lights(scene, p, n, sample3, cfg, shadow_seed=None):
    total = torch.zeros_like(p)
    for li in range(scene.light_origin.shape[0]):
        origin, radius = scene.light_origin[li], scene.light_radius[li]
        diameter = radius * 2.0
        sample_point = origin + (sample3 * diameter - radius)
        ext = sample_point - p
        dist_sqr = dot(ext, ext)
        in_aoe = dist_sqr <= scene.light_aoe[li]
        dist = torch.sqrt(torch.clamp(dist_sqr, min=1e-12))
        sdir = ext / dist[:, None]
        incidence = dot(n, sdir)
        occ = occluded(scene, sample_point, -sdir, dist - 0.01, cfg["max_candidates"],
                       shadow_seed)
        pdf = FOURPI * diameter
        intensity = scene.light_power[li] / (FOURPI * torch.clamp(dist_sqr, min=1e-12))
        contrib = scene.light_color[li] * (intensity * incidence * pdf)[:, None]
        ok = in_aoe & (incidence > 0.0) & ~occ
        total = total + torch.where(ok[:, None], contrib, 0.0)
    return scene.q(total)


def diffuse_irradiance(scene, p, n, noise3, noise2, cfg, salt):
    irr = torch.zeros_like(p)
    if scene.light_origin.shape[0] > 0:
        irr = irr + sphere_lights(scene, p, n, noise3, cfg, salt)
    irr = irr + sun_light(scene, p, n, noise3, cfg, salt ^ 0xA511E9B3)
    return irr + ambient_light(scene, p, n, noise2, cfg, salt ^ 0x63D83595)


def fresnel_reflect_prob(n1, n2, n, incident):
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
    d = dot(n, incident)
    k = 1.0 - eta * eta * (1.0 - d * d)
    out = eta * incident - (eta * d + torch.sqrt(torch.clamp(k, min=0.0)))[..., None] * n
    out = normalize(out + 1e-20)
    return torch.where((k < 0.0)[..., None], 0.0, out)


def material_row(mat):
    return torch.floor((mat.to(torch.float32) - 1.0) / 8.0).to(torch.int32)


def eval_glass(scene, cur_o, cur_d, hit, is_glass, cfg):
    """The bounded internal-reflection loop of a glass hit: Beer
    absorption over the interior length, Schlick splits, the first
    refracted exit as the continuation, later exits shaded terminally."""
    n, dev = cur_o.shape[0], cur_o.device
    k, steps = cfg["max_candidates"], cfg["max_steps"]
    p = hit_point(cur_o, cur_d, hit.t, hit.normal)
    entry_dir = refract(hit.normal, cur_d, 1.0 / 1.5)
    i_o, i_d = p + entry_dir * 1e-3, entry_dir
    medium = torch.where(is_glass, hit.mat, 0)
    absorption = -(1.0 - hit.albedo)
    mul = torch.ones((n,), dtype=torch.float32, device=dev)
    absorb_t = torch.zeros((n,), dtype=torch.float32, device=dev)
    live = is_glass
    emitted = torch.zeros((n,), dtype=torch.bool, device=dev)
    cont_o, cont_d = p, cur_d
    cont_w = torch.ones((n, 3), dtype=torch.float32, device=dev)
    alb_acc = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    irr_acc = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    for i in range(cfg["glass_reflections"]):
        ih = march_interior(scene, hit.obj, i_o, i_d, medium, steps)
        exit_p = i_o + i_d * ih.t[:, None]
        absorb_t = absorb_t + torch.where(live, ih.t, 0.0)
        absorb = torch.exp(absorption * 2.0 * absorb_t[:, None])
        refl = fresnel_reflect_prob(1.5, 1.0, i_d, ih.normal)
        refr = 1.0 - refl
        do_refract = refr >= 0.2
        scan_d = refract(ih.normal, i_d, 1.5)
        scan_o = exit_p + ih.normal * 1e-4
        w = absorb * (refr * mul)[:, None]
        first = live & do_refract & ~emitted
        cont_o = torch.where(first[:, None], scan_o, cont_o)
        cont_d = torch.where(first[:, None], scan_d, cont_d)
        cont_w = torch.where(first[:, None], w, cont_w)
        emitted = emitted | first
        if i > 0:
            later = live & do_refract & ~first
            sh = intersect(scene, scan_o, scan_d, k, steps, ignore=medium)
            s_miss = sh.t >= BIG
            s_sun = torch.clamp(dot(sh.normal, scene.sun_dir), min=0.0)
            s_unlit = (material_row(sh.mat) == 15) | (sh.mat == 255)
            approx = torch.where(s_unlit[:, None], 1.0,
                                 scene.sun_light * s_sun[:, None] + cfg["ambient"])
            t_alb = torch.where(s_miss[:, None], scene.q(sample_sky(scene.sky, scan_d)), sh.albedo)
            t_irr = torch.where(s_miss[:, None], 1.0, approx)
            alb_acc = alb_acc + torch.where(later[:, None], t_alb * w, 0.0)
            irr_acc = irr_acc + torch.where(later[:, None], t_irr * w, 0.0)
        stop = do_refract & ((refl < 0.2) | (mul < 0.1))
        mul = torch.where(live & do_refract, mul * refl, mul)
        live = live & ~stop
        int_d = reflect(i_d, ih.normal)
        i_o = torch.where(live[:, None], exit_p + int_d * 1e-3, i_o)
        i_d = torch.where(live[:, None], int_d, i_d)
    q = scene.q
    return cont_o, cont_d, q(cont_w), emitted, q(alb_acc), q(irr_acc)


def _seed(idx, frame, bounce):
    f = ((int(frame) & _U32) * 2654435761) & _U32
    s = (idx.long() * 0x9E3779B9 + f) & _U32
    return s ^ ((0x85EBCA77 * (bounce + 1)) & _U32)


def shade_full(scene, origins, dirs, hit, frame, cfg, ray_idx):
    """(albedo, irradiance) of the Whitted bounce loop (<= max_bounces)."""
    n, dev = origins.shape[0], origins.device
    k, steps = cfg["max_candidates"], cfg["max_steps"]
    noise3 = _sample(scene.tex3, ray_idx, frame, R2_3D)
    noise2 = _sample(scene.tex2, ray_idx, frame, R2_2D)
    zeros3 = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    albedo_out, irr_out = zeros3, zeros3
    thr_a = torch.ones((n, 3), dtype=torch.float32, device=dev)
    thr_i = torch.ones((n, 3), dtype=torch.float32, device=dev)
    cur_o, cur_d, cur = origins, dirs, hit
    live = hit.t < BIG
    for bounce in range(cfg["max_bounces"]):
        row = material_row(cur.mat)
        unlit = (row == 15) | (cur.mat == 255)
        is_glass = live & (row == 0) & ~unlit
        is_mirror = live & (row == 1) & ~unlit
        is_diffuse = live & ~(is_glass | is_mirror | unlit)
        p = hit_point(cur_o, cur_d, cur.t, cur.normal)
        irr = diffuse_irradiance(scene, p, cur.normal, noise3, noise2, cfg,
                                 _seed(ray_idx, frame, bounce))
        albedo_out = albedo_out + torch.where(is_diffuse[:, None], thr_a * cur.albedo, 0.0)
        irr_out = irr_out + torch.where(is_diffuse[:, None], thr_i * irr, 0.0)
        unlit_mask = live & unlit
        albedo_out = albedo_out + torch.where(unlit_mask[:, None], thr_a * cur.albedo, 0.0)
        irr_out = irr_out + torch.where(unlit_mask[:, None], thr_i, 0.0)
        live = is_mirror | is_glass
        if bounce == cfg["max_bounces"] - 1:
            break
        mir_d = reflect(cur_d, cur.normal)
        if bool(is_glass.any()):
            g_o = torch.where(is_glass[:, None], cur_o, 1e6)
            g_d = torch.where(is_glass[:, None], cur_d, _vec([0.0, 0.0, 1.0], cur_d))
            glass = eval_glass(scene, g_o, g_d, cur, is_glass, cfg)
        else:
            glass = (cur_o, cur_d, torch.ones((n, 3), dtype=torch.float32, device=dev),
                     torch.zeros(n, dtype=torch.bool, device=dev), zeros3, zeros3)
        cont_o, cont_d, cont_w, emitted, g_alb, g_irr = glass
        albedo_out = albedo_out + thr_a * g_alb
        irr_out = irr_out + thr_i * g_irr
        next_o = torch.where(is_glass[:, None], cont_o, p)
        next_d = torch.where(is_glass[:, None], cont_d, mir_d)
        thr_a = torch.where(is_mirror[:, None], thr_a * cur.albedo, thr_a)
        thr_a = torch.where(is_glass[:, None], thr_a * cont_w, thr_a)
        thr_i = torch.where(is_glass[:, None], thr_i * cont_w, thr_i)
        live = is_mirror | (is_glass & emitted)
        ign = torch.where(is_glass, cur.mat, 0)
        cur_o, cur_d = next_o, next_d
        cur = intersect(scene, cur_o, cur_d, k, steps, ignore=ign)
        sky = scene.q(sample_sky(scene.sky, cur_d))
        missed = cur.t >= BIG
        albedo_out = albedo_out + torch.where((live & missed)[:, None], thr_a * sky, 0.0)
        irr_out = irr_out + torch.where((live & missed)[:, None], thr_i, 0.0)
        live = live & ~missed
    return scene.q(albedo_out), scene.q(irr_out)


def render_block(scene, corners, cfg, frame, rows):
    """The image, albedo, color and irradiance ((N, 3) each) and the primary
    hit's depth and material ((N,) each) of image rows [rows[0], rows[1])
    of one frame."""
    w, h = cfg["width"], cfg["height"]
    dev = scene.sky.device
    o, d = rays_for_image(corners, w, h, dev, rows)
    o, d = scene.q(o), scene.q(d)
    hit = intersect(scene, o, d, cfg["max_candidates"], cfg["max_steps"])
    missed = hit.t >= BIG
    sky = scene.q(sample_sky(scene.sky, d))
    albedo = torch.where(missed[:, None], sky, hit.albedo)
    if cfg["shading"] == "flat":
        irr = torch.ones_like(albedo)
    elif cfg["shading"] == "lambert":
        p = hit_point(o, d, hit.t, hit.normal)
        irr = sun_light(scene, p, hit.normal, None, cfg) + cfg["ambient"]
    else:
        idx = torch.arange(o.shape[0], device=dev) + rows[0] * w
        albedo, irr = shade_full(scene, o, d, hit, frame, cfg, idx)
        albedo = torch.where(missed[:, None], sky, albedo)
    irr = torch.where(missed[:, None], 1.0, torch.clamp(irr, min=0.0))
    color = scene.q(albedo * irr)
    return {"image": TONEMAPS[cfg["tonemapper"]](color), "albedo": albedo, "color": color,
            "irradiance": irr, "depth": hit.t, "material": hit.mat}


def render_frame(scene, corners, cfg, frame, block_rows=None):
    """The whole frame in blocks of ``block_rows`` image rows (default one
    block), each output flat over the H * W pixels on the scene's device."""
    h = cfg["height"]
    step = block_rows or h
    parts = [render_block(scene, corners, cfg, frame, (r, min(r + step, h)))
             for r in range(0, h, step)]
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
