"""Scene composition: nearest hit across many voxel objects.

Counterpart of `voxel_tracer_tpu/ops/composite.py`, the replacement for
the reference's per-frame BVH rebuild and ordered stack traversal
(src/graphics/bvh.cpp:187-269): a slab-test prepass over all objects of a
group selects the K nearest candidate boxes per ray (a loop over objects,
so memory stays O(N * K)), then K masked DDA passes trace only those
candidates through the stacked grids.  `march_interior` and
`is_occluded` thread the glass and shadow modes of `ops/dda.py` through.
This module is the wavefront traversal backend of `ops/shading.py`;
`ops/cuda/whitted.MegaIntersector` is its sibling on the B1 / B2 kernels.

Every traversal goes through one DDA function, the keyword ``dda_fn``:
by default `ops/cuda/dda.intersect_volume_local`, which launches the D1
kernel for CUDA tensors and runs the plain loop of `ops/dda.py` for CPU
tensors.  `PLAIN` is this module's interface with ``dda_fn`` set to the
plain loop on any device: the plain wavefront frame is
`Renderer(config, isect=composite.PLAIN)`.

Spans (`utils/profiling.annotate`, off by default): each traversal is an
`intersect` span whose ``kind`` is primary, shadow, interior or scan (an
``ignore``d medium: glass scans and the continuation); the prepass is a
`topk` span, and each candidate slot of `intersect_group` a `candidate`
span that keeps the rows still in the race.
"""

from __future__ import annotations

from functools import partial
from types import SimpleNamespace
from typing import NamedTuple

import torch

from voxel_tracer_tpu_torch.ops import dda
from voxel_tracer_tpu_torch.ops.cuda import dda as dda_kernel
from voxel_tracer_tpu_torch.ops.math3d import BIG_F32, rigid_inverse_point, rigid_inverse_vec
from voxel_tracer_tpu_torch.utils import profiling


class HitResult(NamedTuple):
    """Wavefront hit record (HitInfo analog, src/graphics/rays/hit.h:4-13)."""

    t: torch.Tensor        # (N,) float32; BIG_F32 = miss
    mat: torch.Tensor      # (N,) int32 material id (0 = none)
    normal: torch.Tensor   # (N, 3) float32 world-space normal
    albedo: torch.Tensor   # (N, 3) float32 palette albedo
    steps: torch.Tensor    # (N,) int32 traversal cost
    obj: torch.Tensor      # (N,) int32 global object index (-1 miss, -2 prim)

    @staticmethod
    def miss(n, device="cuda"):
        return HitResult(
            t=torch.full((n,), BIG_F32, dtype=torch.float32, device=device),
            mat=torch.zeros((n,), dtype=torch.int32, device=device),
            normal=torch.zeros((n, 3), dtype=torch.float32, device=device),
            albedo=torch.zeros((n, 3), dtype=torch.float32, device=device),
            steps=torch.zeros((n,), dtype=torch.int32, device=device),
            obj=torch.full((n,), -1, dtype=torch.int32, device=device),
        )

    def nearer(self, other: "HitResult") -> "HitResult":
        """Per ray, the nearer of two records (``other`` on a strict
        win); steps add."""
        take = other.t < self.t
        return HitResult(
            t=torch.where(take, other.t, self.t),
            mat=torch.where(take, other.mat, self.mat),
            normal=torch.where(take[:, None], other.normal, self.normal),
            albedo=torch.where(take[:, None], other.albedo, self.albedo),
            steps=self.steps + other.steps,
            obj=torch.where(take, other.obj, self.obj),
        )


def _to_local(rot, pos, pivot, origins, dirs):
    """World -> volume-local rays (OBB::world_to_local, obb.cpp:128-134)."""
    return rigid_inverse_point(rot, pos, pivot, origins), rigid_inverse_vec(rot, dirs)


def _trace_one(group, oid_static: int, origins, dirs, max_steps,
               obj_base: int = 0, *, dda_fn=None, **dda_kw):
    """Trace all rays against one object of a group (no candidate select)."""
    rot = group.rot[oid_static]
    o_l, d_l = _to_local(rot, group.pos[oid_static], group.pivot[oid_static],
                         origins, dirs)
    res = (dda_fn or dda_kernel.intersect_volume_local)(
        group.grid[oid_static], group.brick_occ[oid_static], o_l, d_l,
        group.vpu[oid_static], max_steps=max_steps, **dda_kw)
    hit = res["t"] < BIG_F32
    normal = dda.normal_from_axis(res["axis"], res["step_sign"], rot)
    albedo = group.palette[oid_static][torch.clamp(res["mat"], 0, 255).long()]
    return HitResult(
        t=res["t"],
        mat=torch.where(hit, res["mat"], 0),
        normal=torch.where(hit[:, None], normal, 0.0),
        albedo=torch.where(hit[:, None], albedo, 0.0),
        steps=res["steps"],
        obj=torch.where(hit, obj_base + oid_static, -1).to(torch.int32),
    )


def _slab_prepass_topk(group, origins, dirs, k: int):
    """Per-ray K nearest candidate objects by slab entry t: a loop over the
    group's objects, each bubble-inserted into the sorted K-list (a strict
    `<`, so ties keep the earlier object)."""
    with profiling.annotate("topk", objects=group.grid.shape[0], k=k):
        return _topk(group, origins, dirs, k)


def _topk(group, origins, dirs, k):
    n, dev = origins.shape[0], origins.device
    gz, gy, gx = group.grid.shape[-3:]
    vsize = torch.tensor([gx, gy, gz], dtype=torch.float32, device=dev)
    tk = torch.full((n, k), BIG_F32, dtype=torch.float32, device=dev)
    idk = torch.zeros((n, k), dtype=torch.int32, device=dev)
    for oid in range(group.grid.shape[0]):
        o_l, d_l = _to_local(group.rot[oid], group.pos[oid], group.pivot[oid],
                             origins, dirs)
        tmin, _tmax, _ax, ok = dda.slab_test(o_l, d_l, vsize / group.vpu[oid])
        t = torch.where(ok, tmin, BIG_F32)
        o = torch.full((n,), oid, dtype=torch.int32, device=dev)
        for j in range(k):
            cur_t, cur_i = tk[:, j].clone(), idk[:, j].clone()
            take = t < cur_t
            tk[:, j] = torch.where(take, t, cur_t)
            idk[:, j] = torch.where(take, o, cur_i)
            t = torch.where(take, cur_t, t)
            o = torch.where(take, cur_i, o)
    return tk, idk


def _gather_objects(group, oid):
    return (group.rot[oid], group.pos[oid], group.pivot[oid], group.vpu[oid])


def intersect_group(group, origins, dirs, max_candidates: int = 4,
                    max_steps: int = dda.MAX_STEPS, obj_base: int = 0,
                    *, dda_fn=None, **dda_kw) -> HitResult:
    """Nearest hit against one shape-homogeneous group of volumes."""
    n = origins.shape[0]
    o_count = group.grid.shape[0]
    if o_count == 1:
        return _trace_one(group, 0, origins, dirs, max_steps, obj_base,
                          dda_fn=dda_fn, **dda_kw)

    k = min(max_candidates, o_count)
    cand_t, cand_id = _slab_prepass_topk(group, origins, dirs, k)

    best = HitResult.miss(n, origins.device)
    pal_flat = group.palette.reshape(-1, 3)
    for slot in range(k):
        oid = cand_id[:, slot].long()
        live = cand_t[:, slot] < BIG_F32
        # early out: a candidate can't beat an existing nearer hit
        live = live & (cand_t[:, slot] < best.t)
        with profiling.annotate("candidate", slot=slot, keep=live):
            rot, pos, pivot, vpu = _gather_objects(group, oid)
            o_l, d_l = _to_local(rot, pos, pivot, origins, dirs)
            res = (dda_fn or dda_kernel.intersect_volume_local)(
                group.grid, group.brick_occ, o_l, d_l, vpu, oid=oid,
                max_steps=max_steps, **dda_kw)
            hit = live & (res["t"] < BIG_F32)
            normal = dda.normal_from_axis(res["axis"], res["step_sign"], rot)
            albedo = pal_flat[oid * 256 + torch.clamp(res["mat"], 0, 255).long()]
            cand = HitResult(
                t=torch.where(hit, res["t"], BIG_F32),
                mat=torch.where(hit, res["mat"], 0),
                normal=torch.where(hit[:, None], normal, 0.0),
                albedo=torch.where(hit[:, None], albedo, 0.0),
                steps=torch.where(live, res["steps"], 0),
                obj=torch.where(hit, obj_base + oid.to(torch.int32), -1).to(torch.int32),
            )
            best = best.nearer(cand)
    return best


def _dda_kw(ignore, shadow_seed, shadow):
    kw = {}
    if ignore is not None:
        kw["ignore"] = ignore
    if shadow:
        kw["shadow"] = True
        kw["shadow_seed"] = shadow_seed
    return kw


def intersect_scene(scene, origins, dirs, max_candidates: int = 4,
                    max_steps: int = dda.MAX_STEPS,
                    ignore=None, shadow_seed=None,
                    shadow: bool = False, *, dda_fn=None) -> HitResult:
    """Nearest hit across all volume groups and analytic primitives
    (Scene::intersect analog, scene.cpp:49-54; the shader applies the sky
    on a miss).

    ``ignore`` (per-ray material id, 0 = off) threads the scan-ray
    pass-through and ``shadow_seed``/``shadow`` the stochastic shadow
    semantics down to every volume traversal (ray.h:40-42 flags);
    ``dda_fn`` is the DDA function of every traversal (default D1's
    wrapper)."""
    kind = "shadow" if shadow else "primary" if ignore is None else "scan"
    with profiling.annotate("intersect", kind=kind):
        return _intersect_scene(scene, origins, dirs, max_candidates, max_steps, ignore,
                                shadow_seed, shadow, dda_fn)


def _intersect_scene(scene, origins, dirs, max_candidates, max_steps, ignore, shadow_seed,
                     shadow, dda_fn):
    from voxel_tracer_tpu_torch.ops.prims import intersect_prims

    dda_kw = _dda_kw(ignore, shadow_seed, shadow)
    best = HitResult.miss(origins.shape[0], origins.device)
    obj_base = 0
    for group in scene.groups:
        best = best.nearer(
            intersect_group(group, origins, dirs, max_candidates, max_steps,
                            obj_base, dda_fn=dda_fn, **dda_kw))
        obj_base += group.grid.shape[0]
    prim = intersect_prims(scene.prims, origins, dirs)
    if prim is not None:
        t, mat, normal, albedo = prim
        best = best.nearer(HitResult(
            t=t, mat=mat, normal=normal, albedo=albedo,
            steps=torch.zeros_like(mat),
            obj=torch.where(t < BIG_F32, -2, -1).to(torch.int32)))
    return best


def march_interior(scene, obj, origins, dirs, medium,
                   max_steps: int = dda.MAX_STEPS, *, dda_fn=None) -> HitResult:
    """Interior exit march for rays inside a medium (glass).

    Traces each ray only against the object it refracted into (per-ray
    global index ``obj`` of a previous HitResult) with `medium` semantics,
    the analog of the reference marching an interior ray through
    `scene.intersect` (materials.cpp:133-135 -> vv.cpp:166-232), scoped to
    the entered object as the JAX function does.  Interior rays never
    miss: they exit at the first non-medium voxel, an empty brick, or the
    OBB exit plane.
    """
    with profiling.annotate("intersect", kind="interior"):
        return _march_interior(scene, obj, origins, dirs, medium, max_steps, dda_fn)


def _march_interior(scene, obj, origins, dirs, medium, max_steps, dda_fn):
    n = origins.shape[0]
    out = HitResult.miss(n, origins.device)
    obj_base = 0
    for group in scene.groups:
        o_count = group.grid.shape[0]
        oid = torch.clamp(obj - obj_base, 0, o_count - 1).long()
        in_group = (obj >= obj_base) & (obj < obj_base + o_count)
        rot, pos, pivot, vpu = _gather_objects(group, oid)
        o_l, d_l = _to_local(rot, pos, pivot, origins, dirs)
        res = (dda_fn or dda_kernel.intersect_volume_local)(
            group.grid, group.brick_occ, o_l, d_l, vpu,
            oid=oid if o_count > 1 else None,
            max_steps=max_steps, medium=medium)
        normal = dda.normal_from_axis(res["axis"], res["step_sign"], rot)
        pal_flat = group.palette.reshape(-1, 3)
        albedo = pal_flat[oid * 256 + torch.clamp(res["mat"], 0, 255).long()]
        sel = in_group
        out = HitResult(
            t=torch.where(sel, res["t"], out.t),
            mat=torch.where(sel, res["mat"], out.mat),
            normal=torch.where(sel[:, None], normal, out.normal),
            albedo=torch.where(sel[:, None], albedo, out.albedo),
            steps=torch.where(sel, res["steps"], out.steps),
            obj=torch.where(sel, obj.to(torch.int32), out.obj),
        )
        obj_base += o_count
    return out


def is_occluded(scene, origins, dirs, tmax, max_candidates: int = 4,
                max_steps: int = dda.MAX_STEPS, shadow_seed=None, *,
                dda_fn=None):
    """Shadow-ray test (Scene::is_occluded analog, scene.cpp:66-71).

    With ``shadow_seed`` (per-ray uint32 values in an integer tensor),
    volume traversals use shadow-ray semantics: ids > 16 occlude, glass
    and mirror rows occlude with p = 0.15 per voxel (vv.cpp:314-327).
    Without a seed every solid voxel occludes.  Returns (occluded, hit).
    """
    with profiling.annotate("intersect", kind="shadow"):
        hit = _intersect_scene(scene, origins, dirs, max_candidates, max_steps, None,
                               shadow_seed, shadow_seed is not None, dda_fn)
        return hit.t < tmax, hit


# the plain wavefront: every traversal on the plain loop of ops/dda.py
PLAIN = SimpleNamespace(**{f.__name__: partial(f, dda_fn=dda.intersect_volume_local)
                           for f in (intersect_scene, march_interior, is_occluded)})
