"""Analytic traceable primitives: spheres and capsules.

Counterpart of `voxel_tracer_tpu/ops/prims.py` (sphere.cpp, capsule.cpp):
batched quadratic-solve intersectors over stacked primitive tensors,
min-combined with the voxel hits in `ops/composite.py`.  The reference
uses capsules for the laser-beam segments (material 0xFF, albedo (50, 0,
0), capsule.cpp:56-70) and spheres for testing (normal-as-color albedo,
sphere.cpp:30-31).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from voxel_tracer_tpu_torch.ops.math3d import BIG_F32, dot

LASER_MAT = 0xFF                       # materials.cpp:30
LASER_ALBEDO = (50.0, 0.0, 0.0)        # capsule.cpp:68 (emissive red)


class PrimsData(NamedTuple):
    """Stacked analytic primitives on one device (zero-length = none)."""

    sph_origin: torch.Tensor   # (S, 3)
    sph_radius: torch.Tensor   # (S,)
    sph_mat: torch.Tensor      # (S,) int32
    sph_albedo: torch.Tensor   # (S, 3); NaN row = normal-as-color
    cap_a: torch.Tensor        # (C, 3)
    cap_b: torch.Tensor        # (C, 3)
    cap_radius: torch.Tensor   # (C,)
    cap_mat: torch.Tensor      # (C,) int32
    cap_albedo: torch.Tensor   # (C, 3)

    @staticmethod
    def empty(device="cuda") -> "PrimsData":
        z3 = torch.zeros((0, 3), dtype=torch.float32, device=device)
        z1 = torch.zeros((0,), dtype=torch.float32, device=device)
        zi = torch.zeros((0,), dtype=torch.int32, device=device)
        return PrimsData(z3, z1, zi, z3, z3, z3, z1, zi, z3)

    @property
    def count(self):
        return self.sph_origin.shape[0] + self.cap_a.shape[0]


def _miss(origins):
    n, dev = origins.shape[0], origins.device
    return (torch.full((n,), BIG_F32, dtype=torch.float32, device=dev),
            torch.zeros((n,), dtype=torch.int32, device=dev),
            torch.zeros((n, 3), dtype=torch.float32, device=dev),
            torch.zeros((n, 3), dtype=torch.float32, device=dev))


def intersect_spheres(prims: PrimsData, origins, dirs):
    """Nearest sphere hit per ray (Sphere::intersect, sphere.cpp:7-34).

    Returns (t, mat, normal, albedo) with t = BIG_F32 on a miss."""
    t_best, mat, normal, albedo = _miss(origins)
    for i in range(prims.sph_origin.shape[0]):
        c0, r = prims.sph_origin[i], prims.sph_radius[i]
        oc = origins - c0
        b = dot(oc, dirs)
        c = dot(oc, oc) - r ** 2
        h = b * b - c
        sq = torch.sqrt(torch.clamp(h, min=0.0))
        t = -b - sq
        t = torch.where((h >= 0.0) & (t > 1e-5), t, BIG_F32)
        better = t < t_best
        p = origins + dirs * t[:, None]
        nrm = (p - c0) / r
        # normal-as-color albedo (sphere.cpp:30-31) where the albedo is NaN
        alb_i = torch.where(torch.isnan(prims.sph_albedo[i, 0]),
                            nrm * 0.5 + 0.5, prims.sph_albedo[i])
        t_best = torch.where(better, t, t_best)
        mat = torch.where(better, prims.sph_mat[i], mat)
        normal = torch.where(better[:, None], nrm, normal)
        albedo = torch.where(better[:, None], alb_i, albedo)
    return t_best, mat, normal, albedo


def intersect_capsules(prims: PrimsData, origins, dirs):
    """Nearest capsule hit per ray (cap_intersect, capsule.cpp:13-47, Inigo
    Quilez's analytic capsule; normal per capsule.cpp:49-54)."""
    t_best, mat, normal, albedo = _miss(origins)
    for i in range(prims.cap_a.shape[0]):
        pa, pb = prims.cap_a[i], prims.cap_b[i]
        r = prims.cap_radius[i]
        ba = pb - pa
        oa = origins - pa
        baba = torch.sum(ba * ba)
        bard = dot(dirs, ba)
        baoa = dot(oa, ba)
        rdoa = dot(dirs, oa)
        oaoa = dot(oa, oa)
        a = baba - bard * bard
        b = baba * rdoa - baoa * bard
        c = baba * oaoa - baoa * baoa - r * r * baba
        h = b * b - a * c
        sq = torch.sqrt(torch.clamp(h, min=0.0))
        t_body = (-b - sq) / torch.where(torch.abs(a) < 1e-20, 1e-20, a)
        y = baoa + t_body * bard
        body_ok = (h >= 0.0) & (y > 0.0) & (y < baba) & (t_body > 1e-5)
        # caps
        oc = torch.where((y <= 0.0)[:, None], oa, origins - pb)
        b2 = dot(dirs, oc)
        c2 = dot(oc, oc) - r * r
        h2 = b2 * b2 - c2
        t_cap = -b2 - torch.sqrt(torch.clamp(h2, min=0.0))
        cap_ok = (h2 > 0.0) & (t_cap > 1e-5)
        t = torch.where(body_ok, t_body, torch.where(cap_ok, t_cap, BIG_F32))
        better = t < t_best
        p = origins + dirs * t[:, None]
        h01 = torch.clamp(dot(p - pa, ba) / baba, 0.0, 1.0)
        nrm = (p - pa - h01[:, None] * ba) / r
        t_best = torch.where(better, t, t_best)
        mat = torch.where(better, prims.cap_mat[i], mat)
        normal = torch.where(better[:, None], nrm, normal)
        albedo = torch.where(better[:, None], prims.cap_albedo[i], albedo)
    return t_best, mat, normal, albedo


def intersect_prims(prims: PrimsData, origins, dirs):
    """Nearest analytic-primitive hit (None if the scene has none)."""
    if prims.count == 0:
        return None
    t1, m1, n1, a1 = intersect_spheres(prims, origins, dirs)
    t2, m2, n2, a2 = intersect_capsules(prims, origins, dirs)
    take2 = t2 < t1
    return (torch.where(take2, t2, t1),
            torch.where(take2, m2, m1),
            torch.where(take2[:, None], n2, n1),
            torch.where(take2[:, None], a2, a1))


def build_prims(spheres=(), capsules=(), device="cuda") -> PrimsData:
    """Host-side packing onto ``device``.

    spheres: iterable of (origin, radius, mat, albedo-or-None);
    capsules: iterable of (a, b, radius, mat, albedo)."""
    if not spheres and not capsules:
        return PrimsData.empty(device)

    def t(xs, dtype, shape):
        arr = np.array(xs, dtype).reshape(shape)
        return torch.tensor(arr, device=device)

    sph = [(np.asarray(o, np.float32), float(r), int(m),
            np.full(3, np.nan, np.float32) if alb is None
            else np.asarray(alb, np.float32)) for (o, r, m, alb) in spheres]
    cap = [(np.asarray(a, np.float32), np.asarray(b, np.float32), float(r),
            int(m), np.asarray(alb, np.float32))
           for (a, b, r, m, alb) in capsules]
    ns, nc = len(sph), len(cap)
    return PrimsData(
        sph_origin=t([s[0] for s in sph], np.float32, (ns, 3)),
        sph_radius=t([s[1] for s in sph], np.float32, (ns,)),
        sph_mat=t([s[2] for s in sph], np.int32, (ns,)),
        sph_albedo=t([s[3] for s in sph], np.float32, (ns, 3)),
        cap_a=t([c[0] for c in cap], np.float32, (nc, 3)),
        cap_b=t([c[1] for c in cap], np.float32, (nc, 3)),
        cap_radius=t([c[2] for c in cap], np.float32, (nc,)),
        cap_mat=t([c[3] for c in cap], np.int32, (nc,)),
        cap_albedo=t([c[4] for c in cap], np.float32, (nc, 3)),
    )
