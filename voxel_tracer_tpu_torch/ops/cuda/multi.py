"""Many oriented volumes on the ray-list kernel: the reference's default scene.

Counterpart of `voxel_tracer_tpu/ops/pallas/multi.py`.  The reference moves
and rotates its four drone volumes every frame and traces rotated OBBs in
the hot loop (scene.cpp:40-43, obb.cpp:48-134, enemy.cpp:10-43).  Here each
volume keeps its own `MegaIntersector` and is traced in its own local frame
by B2 (`mega.trace_rays`); the per-volume world-space hits are
nearest-combined, the structure of the wavefront `composite.intersect_scene`.
A move or a rotation is a change of two small tensors (`with_transforms`),
a carved voxel an O(1) edit of the volume's tables (`MegaIntersector.
set_voxel`); nothing is re-baked.

The BVH's job -- trace a ray only against the volumes it can touch -- is a
slab test against each volume's local box: `masked_apply` gathers exactly
the rays that pass it (one host sync for their count) and the volume
traces that list.

Semantics per volume, as in the JAX class:
- stochastic shadows: each volume walks its own `_shadow_trace` rounds;
  the results nearest-combine;
- the interior march is scoped to the entered volume: a ray goes to the
  volume its hit record names (``obj``), so every per-volume hit carries
  obj = the volume's index;
- scan rays (``ignore``): volumes holding the medium id run the two-trace
  scan, the others a plain trace (every voxel there differs from it);
- analytic primitives (the laser capsules) are intersected once, after
  the volumes.

`make_drone_scene` builds the reference's default scene (scene.cpp:5-31):
the glass test box and four drones as five separate volumes.
"""

from __future__ import annotations

import copy
import os

import numpy as np
import torch

from voxel_tracer_tpu_torch.ops import dda
from voxel_tracer_tpu_torch.ops.compact import masked_apply
from voxel_tracer_tpu_torch.ops.composite import HitResult
from voxel_tracer_tpu_torch.ops.cuda.whitted import MegaIntersector
from voxel_tracer_tpu_torch.ops.math3d import BIG_F32


def _with_obj(h: HitResult, i: int) -> HitResult:
    """The hit record with obj = i where it hits, -1 elsewhere."""
    return h._replace(obj=torch.where(h.t < BIG_F32, i, -1).to(torch.int32))


class MultiMegaIntersector:
    """Composite-compatible kernel backend for N oriented volumes.

    vols: one `MegaIntersector` per volume (its tables, transform and
    launchers).  Each volume traces only the rays that pass its slab test
    (the JAX class's compaction, with exactly the live rays gathered).
    """

    def __init__(self, vols):
        self.vols = list(vols)

    # -- dynamic state --------------------------------------------------

    def with_transforms(self, transforms):
        """Shallow view with per-volume (rot, pos) replaced (None keeps a
        volume's own): per-frame motion is a parameter update
        (scene.cpp:40-43)."""
        return self.with_state(transforms=transforms)

    def with_state(self, transforms=None, tables=None):
        """Shallow view with per-volume transforms and/or table states
        (`MegaIntersector.table_state`) replaced: the per-frame dynamic
        state, motion and voxel edits."""
        out = copy.copy(self)
        out.vols = []
        for vi, v in enumerate(self.vols):
            v2 = v
            if tables is not None and tables[vi] is not None:
                v2 = v2.with_table_state(tables[vi])
            tr = None if transforms is None else transforms[vi]
            if tr is not None:
                if v2 is v:
                    v2 = copy.copy(v)
                rot, pos = tr
                v2.rot = torch.as_tensor(rot, dtype=torch.float32).to(v.device)
                v2.pos = torch.as_tensor(pos, dtype=torch.float32).to(v.device)
            out.vols.append(v2)
        return out

    def table_states(self):
        return [v.table_state() for v in self.vols]

    # -- per-volume masked trace -------------------------------------------

    def _slab_mask(self, v: MegaIntersector, origins, dirs):
        """Rays whose local-frame slab test can touch volume v."""
        o_l, d_l = v._to_local(origins, dirs)
        return dda.slab_test(o_l, d_l, v.vsize_l)[3]

    def _masked_volume(self, v, origins, dirs, fn, extras=()):
        """``fn(live, idx, o, d, *extras) -> tuple(HitResult)`` on the rays
        that pass v's slab test (a miss elsewhere); ``extras`` are per-ray
        tensors gathered with the rays (shadow seeds, ignore ids)."""
        miss = HitResult.miss(origins.shape[0], origins.device)
        return HitResult(*masked_apply(self._slab_mask(v, origins, dirs), fn,
                                       (origins, dirs) + tuple(extras), tuple(miss)))

    # -- composite-compatible API --------------------------------------------

    def intersect_scene(self, scene, origins, dirs, max_candidates=4,
                        max_steps=None, ignore=None, shadow_seed=None,
                        shadow=False) -> HitResult:
        from voxel_tracer_tpu_torch.ops.prims import intersect_prims

        n, dev = origins.shape[0], origins.device
        best = HitResult.miss(n, dev)
        extras = ()
        if shadow:
            extras = (torch.broadcast_to(torch.as_tensor(shadow_seed).to(dev, torch.int64),
                                         (n,)),)
        elif ignore is not None:
            extras = (ignore,)
        for i, v in enumerate(self.vols):
            def fn(_lv, _idx, o, d, *ex, v=v, i=i):
                if shadow:
                    return tuple(_with_obj(v._shadow_trace(o, d, ex[0]), i))
                o_l, d_l = v._to_local(o, d)
                h = v._volume_hit(v._trace(o_l, d_l, v.full_tables, fetch=True))
                for g in v.glass_ids if ignore is not None else ():
                    # scan rays of medium g take the two-trace result
                    h = HitResult(*masked_apply(
                        ex[0] == g,
                        lambda _l, _x, o_, d_, g=g: tuple(v._scan_trace(o_, d_, g)),
                        (o_l, d_l), tuple(h)))
                return tuple(_with_obj(h, i))

            best = best.nearer(self._masked_volume(v, origins, dirs, fn, extras))

        prim = intersect_prims(scene.prims, origins, dirs)
        if prim is not None:
            t, mat, normal, albedo = prim
            best = best.nearer(HitResult(
                t=t, mat=mat, normal=normal, albedo=albedo,
                steps=torch.zeros_like(mat),
                obj=torch.where(t < BIG_F32, -2, -1).to(torch.int32)))
        return best

    def march_interior(self, scene, obj, origins, dirs, medium,
                       max_steps=None) -> HitResult:
        """Interior march scoped to the entered volume (obj routing,
        composite.march_interior's semantics): rows whose obj names no
        volume holding glass stay a miss with obj -1."""
        out = HitResult.miss(origins.shape[0], origins.device)
        for i, v in enumerate(self.vols):
            if not v.glass_ids:
                continue

            def fn(_lv, _idx, o, d, ob, med, v=v):
                return tuple(v.march_interior(scene, ob, o, d, med, max_steps))

            out = HitResult(*masked_apply(obj == i, fn, (origins, dirs, obj, medium),
                                          tuple(out)))
        return out

    def is_occluded(self, scene, origins, dirs, tmax, max_candidates=4,
                    max_steps=None, shadow_seed=None):
        hit = self.intersect_scene(
            scene, origins, dirs, max_candidates, max_steps,
            shadow_seed=shadow_seed, shadow=shadow_seed is not None)
        return hit.t < tmax, hit


# ---------------------------------------------------------------------------
# The reference's default scene
# ---------------------------------------------------------------------------

def _asset(asset_dir, *names):
    """Path of the first of ``names`` under asset_dir (or the directory
    VOXEL_TRACER_ASSET_DIR names) that exists, else None."""
    d = asset_dir or os.environ.get("VOXEL_TRACER_ASSET_DIR")
    for name in names if d else ():
        path = os.path.join(d, name)
        if os.path.isfile(path):
            return path
    return None


def _stand_in_palette():
    return (np.random.RandomState(0).rand(256, 3) * 0.8 + 0.1).astype(np.float32)


# where the stand-in box sits by default: its floor under the drones at
# pos (i, 2, 0), the layout of the baked Whitted scene in chip_smoke.py
STAND_IN_BOX_POS = (0.8, 0.0, -1.7)


def glass_box(asset_dir=None, pos=None, glass=True):
    """The glass test box (testing/glass-box.vox) as a `VoxelVolume` at
    ``pos`` (default: the origin); with ``glass`` its ids 16 -> 4 (glass)
    and 62 -> 12 (mirror), as the reference's materials.h rows.  Without
    the asset a procedural stand-in of the same roles (default pos
    `STAND_IN_BOX_POS`): a 128^3 grid at vpu 20 with a floor slab (id 30),
    a hollow box of 2-voxel walls (id 16) around a pillar (id 40) and a
    plate (id 62)."""
    from voxel_tracer_tpu_torch.models.volume import VoxelVolume

    path = _asset(asset_dir, os.path.join("testing", "glass-box.vox"), "glass-box.vox")
    if path is not None:
        box = VoxelVolume.from_vox(path, pos=(0.0, 0.0, 0.0) if pos is None else pos)
    else:
        n = 128
        g = np.zeros((n, n, n), np.uint8)              # (z, y, x), y up
        g[:, 48:56, :] = 30                            # floor slab
        g[30:70, 56:96, 30:70] = 16                    # box
        g[32:68, 56:94, 32:68] = 0                     # hollow, open to the floor
        g[44:56, 56:84, 44:56] = 40                    # pillar inside
        g[20:70, 56:110, 90:94] = 62                   # plate
        box = VoxelVolume(g, palette=_stand_in_palette(),
                          pos=STAND_IN_BOX_POS if pos is None else pos, vpu=20.0)
    if glass:
        box.grid[box.grid == 16] = 4
        box.grid[box.grid == 62] = 12
    return box


def drone_model(asset_dir=None, i=0):
    """(grid, palette) of enemy-drone.vox; without the asset a 16^3
    ellipsoid of id 17 + 8 i."""
    from voxel_tracer_tpu_torch.models.vox import load_vox

    path = _asset(asset_dir, "enemy-drone.vox")
    if path is not None:
        m = load_vox(path)
        return m.grid, m.palette_f32
    z, y, x = np.meshgrid(*[np.arange(16)] * 3, indexing="ij")
    body = ((x - 7.5) ** 2 / 64 + (y - 7.5) ** 2 / 16 + (z - 7.5) ** 2 / 64) <= 1.0
    return np.where(body, 17 + 8 * i, 0).astype(np.uint8), _stand_in_palette()


def make_drone_scene(*, glass=True, asset_dir=None):
    """The reference's default scene (scene.cpp:5-31) as five separate
    volumes: the glass test box (`glass_box`) and four drones at
    pos (i, 2, 0), a procedural sky and one sphere light.  The `.vox`
    assets are read from ``asset_dir`` or the directory
    VOXEL_TRACER_ASSET_DIR names; without them the stand-ins of
    `glass_box` and `drone_model`.  Returns (volumes, host Scene)."""
    from voxel_tracer_tpu_torch.models.scene import Scene
    from voxel_tracer_tpu_torch.models.skydome import SkyDome
    from voxel_tracer_tpu_torch.models.volume import VoxelVolume

    vols = [glass_box(asset_dir, glass=glass)]
    for i in range(4):
        grid, pal = drone_model(asset_dir, i)
        vols.append(VoxelVolume(grid.copy(), pal, pos=(float(i), 2.0, 0.0), vpu=20.0))
    scene = Scene(volumes=vols, skydome=SkyDome.procedural(64, 32))
    scene.add_light((2.0, 3.5, -1.5), 0.15, (1.0, 0.9, 0.8), 40.0)
    return vols, scene


def render_whitted_multi(multi: MultiMegaIntersector, scene, camera, width,
                         height, frame, transforms=None, *, config=None):
    """Full-material frame over N moving volumes: primary rays on the
    intersector's device, then `renderer.render_rays` with every
    traversal on the multi-volume backend (no camera-kernel pass, as in
    the JAX function)."""
    from voxel_tracer_tpu_torch.models.camera import rays_for_image
    from voxel_tracer_tpu_torch.renderer import RenderConfig, render_rays

    if config is None:
        config = RenderConfig(width=width, height=height, shading="full")
    isect = multi if transforms is None else multi.with_transforms(transforms)
    origins, dirs = rays_for_image(camera, width, height, device=multi.vols[0].device)
    return render_rays(scene, origins, dirs, frame, config=config, isect=isect)
