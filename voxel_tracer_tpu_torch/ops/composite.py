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

Around each D1 call, the glue carries the rays to the volume's local
space (`_local_rays`) and turns D1's outputs into the hit record merged
into the running best (`_record`), and a stacked group's prepass picks
each ray's candidates (`_topk`).  The three are the plain versions of the
kernels of `ops/cuda/composite.py` (`to_local`, `record`, `topk`), which a
traversal of CUDA tensors on D1 (``dda_fn`` None) launches in their place,
with the same float program; CPU tensors and any ``dda_fn`` take the glue.
There a stacked group's candidate slots and their merge (`_race_slots`)
are one launch of D1's race entry (`ops/cuda/dda.race`), which walks
only each ray's live candidates.
Its `KERNEL_LAUNCHES` counts the traversal calls of each and the kernels'
launches.

Spans (`utils/profiling.annotate`, off by default): each traversal is an
`intersect` span whose ``kind`` is primary, shadow, interior or scan (an
``ignore``d medium: glass scans and the continuation); the prepass is a
`topk` span (``fused``: on the kernel), and each candidate slot of
`intersect_group`'s plain race (`_race_slots`) a `candidate` span that
keeps the rows still in the race; on the kernels the race is one `d1`
span.
"""

from __future__ import annotations

from functools import partial
from types import SimpleNamespace
from typing import NamedTuple

import torch

from voxel_tracer_tpu_torch.ops import dda
from voxel_tracer_tpu_torch.ops.cuda import composite as kernels
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


def _objects(group, oid, obj, obj_base):
    """The object of each ray: ``oid`` (an int, or an (N,) int64 tensor),
    or clamp(obj - obj_base, 0, O - 1) of global indices ``obj``."""
    if obj is None:
        return oid
    return torch.clamp(obj - obj_base, 0, group.grid.shape[0] - 1).long()


def _local_rays(group, origins, dirs, oid=0, obj=None, obj_base: int = 0):
    """Rays into the local space of each one's object of ``group``: (o_l,
    d_l, vpu, oid), the plain version of `ops/cuda/composite.to_local`
    (``oid``: D1's per-ray object of a stacked group, for ``obj``)."""
    o = _objects(group, oid, obj, obj_base)
    o_l, d_l = _to_local(group.rot[o], group.pos[o], group.pivot[o], origins, dirs)
    return o_l, d_l, group.vpu[o], o if obj is not None and group.grid.shape[0] > 1 else None


def _albedo(group, o, mat):
    idx = torch.clamp(mat, 0, 255).long()
    if isinstance(o, int):
        return group.palette[o][idx]
    return group.palette.reshape(-1, 3)[o * 256 + idx]


def _record(group, res, best=None, oid=0, obj=None, obj_base: int = 0, live=None,
            select: bool = False) -> HitResult:
    """D1's outputs ``res`` against ``group`` merged into ``best`` (None:
    `HitResult.miss`), the plain version of `ops/cuda/composite.record`.

    Nearer: the traced object(s)' record (mat, normal and albedo zeroed on
    a miss, obj = obj_base + o or -1; with a candidate's ``live`` mask, t
    and steps masked too), then `HitResult.nearer`.  Select (the interior
    march): rows whose ``obj`` lies in the group take D1's raw outputs and
    their ``obj``."""
    if best is None:
        best = HitResult.miss(res["t"].shape[0], res["t"].device)
    o = _objects(group, oid, obj, obj_base)
    normal = dda.normal_from_axis(res["axis"], res["step_sign"], group.rot[o])
    albedo = _albedo(group, o, res["mat"])
    if select:
        sel = (obj >= obj_base) & (obj < obj_base + group.grid.shape[0])
        return HitResult(
            t=torch.where(sel, res["t"], best.t),
            mat=torch.where(sel, res["mat"], best.mat),
            normal=torch.where(sel[:, None], normal, best.normal),
            albedo=torch.where(sel[:, None], albedo, best.albedo),
            steps=torch.where(sel, res["steps"], best.steps),
            obj=torch.where(sel, obj.to(torch.int32), best.obj),
        )
    hit = res["t"] < BIG_F32
    if live is not None:
        hit = live & hit
    obj_id = obj_base + (o if isinstance(o, int) else o.to(torch.int32))
    return best.nearer(HitResult(
        t=res["t"] if live is None else torch.where(hit, res["t"], BIG_F32),
        mat=torch.where(hit, res["mat"], 0),
        normal=torch.where(hit[:, None], normal, 0.0),
        albedo=torch.where(hit[:, None], albedo, 0.0),
        steps=res["steps"] if live is None else torch.where(live, res["steps"], 0),
        obj=torch.where(hit, obj_id, -1).to(torch.int32),
    ))


def _stages(fused):
    """(to_local, record): the kernels or their plain versions."""
    return (kernels.to_local, kernels.record) if fused else (_local_rays, _record)


def _slab_prepass_topk(group, origins, dirs, k: int, fused: bool):
    """Per-ray K nearest candidate objects by slab entry t: `kernels.topk`
    where the traversal is ``fused`` (which refuses a K above its
    `TOPK_MAX`), else the plain `_topk`."""
    with profiling.annotate("topk", objects=group.grid.shape[0], k=k, fused=fused):
        return (kernels.topk if fused else _topk)(group, origins, dirs, k)


def _topk(group, origins, dirs, k):
    """The plain prepass: a loop over the group's objects, each one's slab
    entry t bubble-inserted into the sorted K-list (a strict `<`, so ties
    keep the earlier object)."""
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


def intersect_group(group, origins, dirs, max_candidates: int = 4,
                    max_steps: int = dda.MAX_STEPS, obj_base: int = 0,
                    *, dda_fn=None, **dda_kw) -> HitResult:
    """Nearest hit against one shape-homogeneous group of volumes (one
    volume: its record, no candidate select), merged into the miss record
    as a scene's first group is: a miss reads t = BIG_F32 even where D1
    gives a degenerate ray inf."""
    return _intersect_group(group, origins, dirs, max_candidates, max_steps, obj_base, None,
                            kernels.fused(origins, dda_fn), dda_fn, dda_kw)


def _intersect_group(group, origins, dirs, max_candidates, max_steps, obj_base, best,
                     fused, dda_fn, dda_kw) -> HitResult:
    """`intersect_group` merged into ``best`` (None: a miss record; the
    kernels merge in place).  A candidate race keeps its own record, since
    its early out compares with the group's best alone: on D1's race entry
    (one launch) where the traversal is ``fused``, else as K passes
    (`_race_slots`)."""
    to_local, record = _stages(fused)
    d1 = dda_fn or dda_kernel.intersect_volume_local
    o_count = group.grid.shape[0]
    if o_count == 1:
        o_l, d_l, vpu, _ = to_local(group, origins, dirs, oid=0)
        res = d1(group.grid[0], group.brick_occ[0], o_l, d_l, vpu, max_steps=max_steps,
                 **dda_kw)
        return record(group, res, best, oid=0, obj_base=obj_base)

    k = min(max_candidates, o_count)
    cand_t, cand_id = _slab_prepass_topk(group, origins, dirs, k, fused)
    if fused:
        return dda_kernel.race(group, origins, dirs, cand_t, cand_id, best, obj_base=obj_base,
                               max_steps=max_steps, **dda_kw)
    return _race_slots(group, origins, dirs, cand_t, cand_id, best, obj_base, max_steps,
                       to_local, record, d1, dda_kw)


def _race_slots(group, origins, dirs, cand_t, cand_id, best, obj_base, max_steps, to_local,
                record, d1, dda_kw) -> HitResult:
    """The candidate race as K passes, one a slot, each tracing every row
    and keeping the rows whose candidate can still win: the plain version
    of `ops/cuda/dda.race`, on the stages ``to_local`` / ``record`` and the
    DDA ``d1``.  Merged into ``best`` (None: a miss record)."""
    race = None
    for slot in range(cand_t.shape[1]):
        oid = cand_id[:, slot].long()
        live = cand_t[:, slot] < BIG_F32
        # early out: a candidate can't beat an existing nearer hit
        if race is not None:
            live = live & (cand_t[:, slot] < race.t)
        with profiling.annotate("candidate", slot=slot, keep=live):
            o_l, d_l, vpu, _ = to_local(group, origins, dirs, oid=oid)
            res = d1(group.grid, group.brick_occ, o_l, d_l, vpu, oid=oid,
                     max_steps=max_steps, **dda_kw)
            race = record(group, res, race, oid=oid, obj_base=obj_base, live=live)
    # the first group needs no merge: a race starts from the miss record and
    # takes only t < 1e30, so miss.nearer(race) is race itself
    return race if best is None else best.nearer(race)


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
    fused = kernels.fused(origins, dda_fn)
    best, obj_base = None, 0
    for group in scene.groups:
        best = _intersect_group(group, origins, dirs, max_candidates, max_steps, obj_base,
                                best, fused, dda_fn, dda_kw)
        obj_base += group.grid.shape[0]
    if best is None:
        best = HitResult.miss(origins.shape[0], origins.device)
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
    to_local, record = _stages(kernels.fused(origins, dda_fn))
    d1 = dda_fn or dda_kernel.intersect_volume_local
    obj = obj.to(torch.int32)
    out, obj_base = None, 0
    for group in scene.groups:
        o_count = group.grid.shape[0]
        o_l, d_l, vpu, oid = to_local(group, origins, dirs, obj=obj, obj_base=obj_base)
        res = d1(group.grid, group.brick_occ, o_l, d_l, vpu, oid=oid, max_steps=max_steps,
                 medium=medium)
        out = record(group, res, out, obj=obj, obj_base=obj_base, select=True)
        obj_base += o_count
    return HitResult.miss(origins.shape[0], origins.device) if out is None else out


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
                           for f in (intersect_scene, intersect_group, march_interior,
                                     is_occluded)})
