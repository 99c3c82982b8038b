"""Kernel-backed full-material (Whitted) frame.

Counterpart of `voxel_tracer_tpu/ops/pallas/whitted.py`.  The reference's
default frame runs the complete material system -- mirror, glass (Beer +
Fresnel + internal reflections), sphere area lights, sun, ambient -- per
pixel (renderer.cpp:199-223 -> materials.cpp:15-48).  Here the same
wavefront shading as `ops/shading.shade_full` runs with every traversal
on the CUDA kernels of `csrc/mega.cu`:

- the primary pass  -> B1 (`mega.render_mega_tiles`, raw shading, no sky:
  t, material byte, axis and steps of every pixel);
- nearest hit        -> B2 (`mega.trace_rays`) on the volume's tables;
- glass interior march (medium semantics, vv.cpp:166-232) -> B2 on
  inverted tables of the glass id g (occupied = voxel != g, material
  bytes of the original grid): the first solid voxel is the exit; a miss
  is the grid exit, placed analytically at the OBB exit (slab tmax);
- scan rays (ignore_medium, vv.cpp:328-335) -> two B2 traces: inverted
  tables to the first non-g voxel; if it is air, the full tables from
  just inside it (after air any solid voxel hits, g included);
- stochastic glass shadows (vv.cpp:314-327) -> `shadow_rounds` B2 traces
  on the full tables: each round stops at the next solid voxel, rolls
  `dda.hash_shadow` at its cell and either occludes or steps past it --
  the wavefront DDA's roll sequence, truncated at `shadow_rounds` voxels.

`MegaIntersector` has composite's interface (`intersect_scene`,
`march_interior`, `is_occluded`), so `renderer.render_rays(...,
isect=MegaIntersector(...))` runs the full shader unchanged on the
kernels.  Materials come from the kernel's byte fetch, normals from its
axis word.

The kernels resolve every ray: a ray is unresolved only where the
256-step budget ran out.  With ``exact_fallback=True`` those rays, and
shadow walks still going after `shadow_rounds` voxels, continue on the
DDA of `ops/dda.py` (medium / shadow modes), compacted, as one D1 launch
(`ops/cuda/dda.py`) a fallback.

The plain version of the frame is the same code with the kernels' plain
versions passed in (``trace_fn=mega.trace_rays_plain``,
``tiles_fn=mega.render_mega_tiles_plain``,
``dda_fn=dda.intersect_volume_local``): an explicit argument, for
comparisons.  With the default launchers a CUDA tensor launches a kernel
or raises, and CPU tensors run the plain versions.

Options of the JAX class that only tune the TPU traversal are accepted
and ignored, so JAX call sites carry over: `tile_rows`, `fine_iters`,
`fine_unroll`, `max_bricks_per_tile`, `resolve_passes` (every ray
resolves in one pass), `list_tile_rows`, `block_hw` and `interpret`; and
`tile_rows` / `tile_w` of `primary_hit_mega` and `render_whitted_mega`.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from voxel_tracer_tpu_torch.models.camera import primary_rays
from voxel_tracer_tpu_torch.models.scene import SUN_DIR
from voxel_tracer_tpu_torch.ops import dda
from voxel_tracer_tpu_torch.ops.compact import masked_apply
from voxel_tracer_tpu_torch.ops.composite import HitResult, _to_local
from voxel_tracer_tpu_torch.ops.cuda import dda as dda_kernel
from voxel_tracer_tpu_torch.ops.cuda import mega
from voxel_tracer_tpu_torch.ops.math3d import BIG_F32


def _park(live, o, d):
    """Rows not in ``live`` trace from far away along +z: the slab test
    rejects them at once."""
    unit_z = torch.tensor([0.0, 0.0, 1.0], device=d.device)
    return (torch.where(live[:, None], o, 1e6),
            torch.where(live[:, None], d, unit_z))


class MegaIntersector:
    """Kernel traversal backend for the full-material wavefront.

    Holds the volume's tables (`mv.tables`) plus one inverted table set
    per glass material id present (ids 1..8, materials.h:8-10) for the
    medium and scan semantics.

    shadow_rounds: stochastic shadow voxels walked per shadow ray.
    compact: run the shadow rounds after the first on the rays still
      walking (those that passed a glass or mirror voxel).
    exact_fallback: continue budget-exhausted rays and truncated shadow
      walks on the DDA.
    trace_fn / tiles_fn / dda_fn: the ray-list and camera launchers and
      the fallback's DDA (default the kernels' wrappers, B2, B1 and D1;
      `mega.trace_rays_plain`, `mega.render_mega_tiles_plain` and
      `dda.intersect_volume_local` give the plain frame).
    """

    def __init__(self, mv: mega.MegaVolume, *, tile_rows=8, fine_iters=48,
                 fine_unroll=4, max_bricks_per_tile=64, shadow_rounds=4,
                 block_hw=None, resolve_passes=2, compact=False,
                 list_tile_rows=None, exact_fallback=False,
                 interpret=False, trace_fn=None, tiles_fn=None, dda_fn=None):
        self.mv = mv
        self.device = mv.device
        self.shadow_rounds = shadow_rounds
        self.compact = compact
        self.exact_fallback = exact_fallback
        self.trace_fn = mega.trace_rays if trace_fn is None else trace_fn
        self.tiles_fn = mega.render_mega_tiles if tiles_fn is None else tiles_fn
        self.dda_fn = dda_kernel.intersect_volume_local if dda_fn is None else dda_fn
        self.refresh_tables()

    # -- dynamic state ------------------------------------------------------

    def set_voxel(self, x, y, z, val):
        """O(1) dynamic edit (vv.cpp:377-432, laser carving; JAX
        `MegaIntersector.set_voxel`, whitted.py:180-193): the host volume,
        then the full tables, the DDA grid and the inverted tables of every
        glass id in place (`mega.set_voxel_tables`; for id g the voxel is
        occupied where val != g).  A glass id the volume did not hold gets
        its inverted tables packed."""
        self.mv.volume.set_voxel(x, y, z, val)
        self.mirror_voxel(x, y, z)

    def mirror_voxel(self, x, y, z):
        """Copy voxel (x, y, z) of the host volume, edited elsewhere, into
        every device table in place (the device half of `set_voxel`)."""
        vol = self.mv.volume
        val = int(vol.grid[z, y, x])
        mega.set_voxel_tables(self.full_tables, x, y, z, val)
        self.grid_dda[z, y, x] = val
        for g, tb in self.inv_tables.items():
            mega.set_voxel_tables(tb, x, y, z, val, occupied=val != g)
        if 1 <= val <= 8 and val not in self.inv_tables:
            self.glass_ids = sorted(self.glass_ids + [val])
            self.inv_tables[val] = mega.pack_tables(
                vol.grid, vol.palette, self.vpu, self.device, occupied=vol.grid != val)

    def refresh_tables(self):
        """Re-read every table after bulk edits of the volume and
        `mv.refresh()` (model reload, enemy.cpp:60-63)."""
        vol, dev = self.mv.volume, self.device
        self.full_tables = self.mv.tables
        self.pal = self.full_tables.pal
        self.vpu = float(vol.vpu)
        self.vpu_t = torch.tensor(self.vpu, dtype=torch.float32, device=dev)
        gz, gy, gx = vol.grid.shape
        self.vsize_l = torch.tensor(np.array([gx, gy, gz], np.float32) / self.vpu,
                                    device=dev)
        self.gsize = torch.tensor([gx, gy, gz], dtype=torch.int32, device=dev)
        self.rot, self.pos, self.pivot = (v.to(dev) for v in
                                          (self.mv.rot, self.mv.pos, self.mv.pivot))
        self.grid_dda = torch.tensor(vol.grid.astype(np.int32), device=dev)
        # the DDA's solid counts per brick are the full tables' own
        self.brick_occ = self.full_tables.brick_occ
        self.glass_ids = sorted(int(g) for g in np.unique(vol.grid) if 1 <= g <= 8)
        self.inv_tables = {
            g: mega.pack_tables(vol.grid, vol.palette, self.vpu, dev,
                                occupied=vol.grid != g)
            for g in self.glass_ids}

    def table_state(self):
        """The tables a frame reads: (full tables, inverted tables, DDA
        grid, DDA brick counts)."""
        return (self.full_tables, self.inv_tables, self.grid_dda, self.brick_occ)

    def with_table_state(self, st):
        v2 = copy.copy(self)
        v2.full_tables, v2.inv_tables, v2.grid_dda, v2.brick_occ = st
        v2.pal = v2.full_tables.pal
        return v2

    # -- low level ----------------------------------------------------------

    def _dda_fallback(self, need, o_l, d_l, medium=None, shadow_seed=None):
        """The DDA (``dda_fn``, vv.cpp:127-369 semantics) on the compacted
        ``need`` rows; ``medium`` (an int) runs the interior exit march on
        that id, ``shadow_seed`` the stochastic shadow walk.  Returns a
        full-size dict(ok, t, mat, ax, steps)."""
        n, dev = o_l.shape[0], o_l.device
        extra = () if shadow_seed is None else (shadow_seed,)

        def run(lv, _idx, o_g, d_g, *ex):
            kw = {}
            if medium is not None:
                kw["medium"] = torch.full((o_g.shape[0],), medium,
                                          dtype=torch.int32, device=dev)
            if shadow_seed is not None:
                kw["shadow"] = True
                kw["shadow_seed"] = ex[0]
            r = self.dda_fn(self.grid_dda, self.brick_occ, o_g, d_g, self.vpu, **kw)
            sgn_k = torch.gather(r["step_sign"], 1, r["axis"].long()[:, None])[:, 0]
            ax = r["axis"] * 2 + (sgn_k > 0).to(torch.int32)
            ok = lv & (r["t"] < BIG_F32)
            return (ok, torch.where(ok, r["t"], BIG_F32),
                    torch.where(ok, r["mat"], 0), ax, r["steps"])

        zi = torch.zeros((n,), dtype=torch.int32, device=dev)
        fill = (torch.zeros((n,), dtype=torch.bool, device=dev),
                torch.full((n,), BIG_F32, device=dev), zi, zi, zi)
        ok, t, mat, ax, steps = masked_apply(need, run, (o_l, d_l) + extra, fill)
        return dict(ok=ok, t=t, mat=mat, ax=ax, steps=steps)

    def _trace(self, o_l, d_l, tables, fetch=False, fallback_medium=None):
        """One ray-list trace: dict of t (BIG on a miss), mat, ax, steps,
        resolved.  With ``exact_fallback`` the budget-exhausted rays are
        re-traced by the wavefront DDA (interior exit march on
        ``fallback_medium`` for inverted tables) and marked resolved."""
        res = self.trace_fn(o_l, d_l, tables, fetch_mat=fetch)
        if not self.exact_fallback:
            return res
        need = ~res["resolved"]
        fb = self._dda_fallback(need, o_l, d_l, medium=fallback_medium)
        return dict(
            t=torch.where(need, torch.where(fb["ok"], fb["t"], mega.BIG), res["t"]),
            mat=torch.where(need, fb["mat"], res["mat"]),
            ax=torch.where(need, fb["ax"], res["ax"]),
            steps=res["steps"] + torch.where(need, fb["steps"], 0),
            resolved=res["resolved"] | need,
        )

    def _hit_cell(self, o_l, d_l, t, ax):
        """Voxel cell of a kernel hit from (t, axis, step sign).

        On the hit axis the intersection point sits on a voxel boundary:
        take the boundary voxel in the step direction.  Rays that start
        inside a solid voxel (t = 0 away from any boundary) fall back to
        floor."""
        p = (o_l + d_l * t[:, None]) * self.vpu
        k = (ax >> 1).long()
        s = torch.where((ax & 1) == 1, 1, -1)        # normal = -step sign
        base = torch.floor(p).to(torch.int32)
        bk = torch.gather(p, 1, k[:, None])[:, 0]
        nearest = torch.round(bk)                     # half to even, as jnp.round
        on_boundary = torch.abs(bk - nearest) < 1e-3
        idx_k = torch.where(on_boundary,
                            torch.where(s > 0, nearest, nearest - 1.0),
                            torch.floor(bk)).to(torch.int32)
        onehot = torch.nn.functional.one_hot(k, 3).bool()
        cell = torch.where(onehot, idx_k[:, None], base)
        return torch.minimum(torch.clamp(cell, min=0), self.gsize - 1), s

    def _normal(self, ax):
        """World normal of an axis word: -step sign on the axis, rotated."""
        sgn = torch.where((ax & 1) == 1, -1.0, 1.0)
        return self.rot.T[(ax >> 1).long()] * sgn[:, None]

    def _to_local(self, origins, dirs):
        return _to_local(self.rot, self.pos, self.pivot, origins, dirs)

    def _exit_slab(self, o_l, d_l):
        """Analytic OBB exit: per-axis exit t of the local box and the
        reference's tmax-ladder axis (vv.cpp:206-225, obb.cpp:82-106)."""
        tiny = torch.abs(d_l) < 1e-12
        safe_d = torch.where(tiny, torch.where(d_l < 0, -1e-12, 1e-12), d_l)
        hi = torch.where(d_l >= 0, self.vsize_l, 0.0)
        t3 = torch.where(tiny, BIG_F32, (hi - o_l) / safe_d)
        tx, ty, tz = t3.unbind(-1)
        use_x = (tx < ty) & (tx < tz)
        use_y = ~(tx < ty) & (ty < tz)
        axis = torch.where(use_x, 0, torch.where(use_y, 1, 2)).to(torch.int32)
        return torch.minimum(torch.minimum(tx, ty), tz), axis

    def _volume_hit(self, res, obj_val=0):
        """Kernel trace dict -> world-space HitResult."""
        ok = (res["t"] < mega.BIG) & res["resolved"]
        mat = torch.where(ok, res["mat"], 0)
        albedo = self.pal[torch.clamp(mat, 0, 255).long()]
        return HitResult(
            t=torch.where(ok, res["t"], BIG_F32),
            mat=mat,
            normal=torch.where(ok[:, None], self._normal(res["ax"]), 0.0),
            albedo=torch.where(ok[:, None], albedo, 0.0),
            steps=res["steps"],
            obj=torch.where(ok, obj_val, -1).to(torch.int32),
        )

    # -- composite-compatible API ------------------------------------------

    def intersect_scene(self, scene, origins, dirs, max_candidates=4,
                        max_steps=None, ignore=None, shadow_seed=None,
                        shadow=False) -> HitResult:
        from voxel_tracer_tpu_torch.ops.prims import intersect_prims

        if shadow:
            best = self._shadow_trace(origins, dirs, shadow_seed)
        else:
            o_l, d_l = self._to_local(origins, dirs)
            best = self._volume_hit(self._trace(o_l, d_l, self.full_tables,
                                                fetch=True))
            if ignore is not None:
                for g in self.glass_ids:
                    # scan rays of medium g take the two-trace result
                    best = HitResult(*masked_apply(
                        ignore == g,
                        lambda lv, idx, o, d, g=g: tuple(self._scan_trace(o, d, g)),
                        (o_l, d_l), tuple(best)))

        prim = intersect_prims(scene.prims, origins, dirs)
        if prim is not None:
            t, mat, normal, albedo = prim
            best = best.nearer(HitResult(
                t=t, mat=mat, normal=normal, albedo=albedo,
                steps=torch.zeros_like(mat),
                obj=torch.where(t < BIG_F32, -2, -1).to(torch.int32)))
        return best

    def _scan_trace(self, o_l, d_l, g) -> HitResult:
        """ignore_medium scan semantics for medium id ``g``
        (vv.cpp:328-335): pass g voxels up to the first non-g voxel; if
        that voxel is air the ray has exited and any solid voxel from there
        on hits (g included)."""
        res_b = self._trace(o_l, d_l, self.inv_tables[g], fetch=True,
                            fallback_medium=g)
        ok_b = (res_b["t"] < mega.BIG) & res_b["resolved"]
        v_b = res_b["mat"]
        solid_b = ok_b & (v_b > 0)
        air_at = ok_b & (v_b == 0)

        # continue from just inside the air voxel on the full tables; rays
        # that are done trace from far away
        eps = torch.tensor(1e-3 / self.vpu, dtype=torch.float32, device=o_l.device)
        o_c, d_c = _park(air_at, o_l + d_l * (res_b["t"] + eps)[:, None], d_l)
        res_c = self._trace(o_c, d_c, self.full_tables, fetch=True)
        ok_c = (res_c["t"] < mega.BIG) & res_c["resolved"]
        cont = air_at & ok_c

        hit = solid_b | cont
        t = torch.where(solid_b, res_b["t"],
                        torch.where(cont, res_b["t"] + eps + res_c["t"], BIG_F32))
        mat = torch.where(solid_b, v_b, torch.where(cont, res_c["mat"], 0))
        ax = torch.where(solid_b, res_b["ax"], res_c["ax"])
        albedo = self.pal[torch.clamp(mat, 0, 255).long()]
        return HitResult(
            t=t,
            mat=torch.where(hit, mat, 0),
            normal=torch.where(hit[:, None], self._normal(ax), 0.0),
            albedo=torch.where(hit[:, None], albedo, 0.0),
            steps=res_b["steps"] + res_c["steps"],
            obj=torch.where(hit, 0, -1).to(torch.int32),
        )

    def _shadow_trace(self, origins, dirs, shadow_seed) -> HitResult:
        """Stochastic shadow semantics (vv.cpp:314-327): ids > 16 occlude;
        glass and mirror voxels occlude with p = 0.15 per voxel.  Each
        round advances one solid voxel and rolls `hash_shadow` at its cell,
        the wavefront DDA's roll sequence truncated at `shadow_rounds`
        voxels (deeper walks count as transmitted unless
        ``exact_fallback``)."""
        o_l, d_l = self._to_local(origins, dirs)
        n, dev = o_l.shape[0], o_l.device
        seed = torch.broadcast_to(torch.as_tensor(shadow_seed).to(dev, torch.int64), (n,))
        zi = torch.zeros((n,), dtype=torch.int32, device=dev)
        state0 = (o_l, d_l, seed,
                  torch.ones((n,), dtype=torch.bool, device=dev),     # live
                  torch.zeros((n,), dtype=torch.float32, device=dev),  # t_base
                  torch.full((n,), BIG_F32, device=dev),               # hit_t
                  zi, zi, zi)                                          # mat, ax, steps

        if self.compact and self.shadow_rounds > 1:
            st = self._shadow_rounds(state0, 1)
            o_c, d_c, sd_c, live, t_base, hit_t, hit_mat, hit_ax, steps = st

            def tail(lv, _idx, o_g, d_g, sd_g, tb_g, ht_g, hm_g, ha_g, st_g):
                r = self._shadow_rounds((o_g, d_g, sd_g, lv, tb_g, ht_g, hm_g,
                                         ha_g, st_g), self.shadow_rounds - 1)
                return self._shadow_finish(r)

            hit_t, hit_mat, hit_ax, steps = masked_apply(
                live, tail, (o_c, d_c, sd_c, t_base, hit_t, hit_mat, hit_ax, steps),
                (hit_t, hit_mat, hit_ax, steps))
        else:
            st = self._shadow_rounds(state0, self.shadow_rounds)
            hit_t, hit_mat, hit_ax, steps = self._shadow_finish(st)

        ok_any = hit_t < BIG_F32
        # an occluder's albedo is never read by the shader
        return HitResult(
            t=hit_t,
            mat=torch.where(ok_any, hit_mat, 0),
            normal=torch.where(ok_any[:, None], self._normal(hit_ax), 0.0),
            albedo=torch.zeros((n, 3), dtype=torch.float32, device=dev),
            steps=steps,
            obj=torch.where(ok_any, 0, -1).to(torch.int32),
        )

    def _shadow_rounds(self, state, rounds):
        """Run ``rounds`` stochastic-shadow rounds from ``state``; each
        advances the live rays one solid voxel.  Rounds stop early once no
        ray is live (the rest would change nothing)."""
        o_cur, d_l, seed, live, t_base, hit_t, hit_mat, hit_ax, steps = state
        eps = torch.tensor(1e-3 / self.vpu, dtype=torch.float32, device=o_cur.device)
        tiny = torch.abs(d_l) < 1e-12
        safe_d = torch.where(tiny, 1e-12, d_l)
        for _ in range(rounds):
            if not bool(live.any()):
                break
            res = self._trace(o_cur, d_l, self.full_tables, fetch=True)
            ok = (res["t"] < mega.BIG) & res["resolved"]
            steps = steps + torch.where(live, res["steps"], 0)
            cell, _s = self._hit_cell(o_cur, d_l, res["t"], res["ax"])
            v = res["mat"]
            rnd = dda.hash_shadow(seed, cell)
            occl_now = live & ok & ((v > 16) | (rnd > 0.85))
            hit_t = torch.where(occl_now, t_base + res["t"], hit_t)
            hit_mat = torch.where(occl_now, v, hit_mat)
            hit_ax = torch.where(occl_now, res["ax"], hit_ax)

            # transmit: advance just past the far side of this voxel
            cont = live & ok & ~occl_now
            p = o_cur + d_l * res["t"][:, None]
            far = (cell + (d_l >= 0).to(torch.int32)).to(torch.float32) / self.vpu_t
            t3 = torch.where(tiny, BIG_F32, (far - p) / safe_d)
            dt = torch.clamp(torch.amin(t3, dim=-1), min=0.0) + eps
            o_cur = torch.where(cont[:, None], p + d_l * dt[:, None], 1e6)
            t_base = t_base + torch.where(cont, res["t"] + dt, 0.0)
            live = cont
        return (o_cur, d_l, seed, live, t_base, hit_t, hit_mat, hit_ax, steps)

    def _shadow_finish(self, st):
        """Close a shadow walk: rays still live after the last round count
        as transmitted, or with ``exact_fallback`` continue on the shadow
        DDA from where they stand (`hash_shadow` keys on the cell, so the
        rolls are the untruncated walk's)."""
        o_cur, d_l, seed, live, t_base, hit_t, hit_mat, hit_ax, steps = st
        if not self.exact_fallback:
            return hit_t, hit_mat, hit_ax, steps
        fb = self._dda_fallback(live, o_cur, d_l, shadow_seed=seed)
        occ = live & fb["ok"]
        return (torch.where(occ, t_base + fb["t"], hit_t),
                torch.where(occ, fb["mat"], hit_mat),
                torch.where(occ, fb["ax"], hit_ax),
                steps + torch.where(live, fb["steps"], 0))

    def march_interior(self, scene, obj, origins, dirs, medium,
                       max_steps=None) -> HitResult:
        """Interior exit march (medium semantics, vv.cpp:166-232): trace
        the inverted tables of each glass id -- their first occupied voxel
        is the first voxel that differs from the medium.  A miss is the
        grid exit: the OBB exit with material air; rays whose slab test
        misses exit at t = 0 (vv.cpp:228-232)."""
        o_l, d_l = self._to_local(origins, dirs)
        n, dev = o_l.shape[0], o_l.device
        t_exit, exit_axis = self._exit_slab(o_l, d_l)
        _tmin, _tmax, _eax, slab_ok = dda.slab_test(o_l, d_l, self.vsize_l)
        t = torch.where(slab_ok, torch.clamp(t_exit, min=0.0), 0.0)
        d_k = torch.gather(d_l, 1, exit_axis.long()[:, None])[:, 0]
        step_sign = torch.where(d_k >= 0, 1.0, -1.0)
        normal = self.rot.T[exit_axis.long()] * (-step_sign)[:, None]
        mat = torch.zeros((n,), dtype=torch.int32, device=dev)
        steps = torch.zeros((n,), dtype=torch.int32, device=dev)
        for g in self.glass_ids:
            def run(lv, _idx, o, d, g=g):
                r = self._trace(o, d, self.inv_tables[g], fetch=True,
                                fallback_medium=g)
                ok = (r["t"] < mega.BIG) & r["resolved"]
                return ok, r["t"], r["mat"], r["ax"], r["steps"]

            zi = torch.zeros((n,), dtype=torch.int32, device=dev)
            ok, t_g, v, ax, st = masked_apply(
                medium == g, run, (o_l, d_l),
                (torch.zeros((n,), dtype=torch.bool, device=dev), t, zi, zi, zi))
            t = torch.where(ok, t_g, t)
            mat = torch.where(ok, v, mat)
            normal = torch.where(ok[:, None], self._normal(ax), normal)
            steps = steps + st

        # the Beer absorption reads the entry surface's albedo, never the
        # exit's
        albedo = torch.zeros((n, 3), dtype=torch.float32, device=dev)
        return HitResult(t=t, mat=mat, normal=normal, albedo=albedo,
                         steps=steps, obj=obj)

    def is_occluded(self, scene, origins, dirs, tmax, max_candidates=4,
                    max_steps=None, shadow_seed=None):
        hit = self.intersect_scene(
            scene, origins, dirs, max_candidates, max_steps,
            shadow_seed=shadow_seed, shadow=shadow_seed is not None)
        return hit.t < tmax, hit


# ---------------------------------------------------------------------------
# Whole frame: the camera kernel's primary pass + kernel-backed shading
# ---------------------------------------------------------------------------

def primary_hit_mega(isect: MegaIntersector, camera, width, height, *,
                     tile_rows=8, tile_w=32):
    """Camera-kernel primary pass (raw shading, no sky) -> world-space
    HitResult and the matching wavefront rays (origins, dirs)."""
    mv = isect.mv
    cam_p = mega.mega_camera(mv, camera, SUN_DIR, width, height)
    _rgba, t, aux = isect.tiles_fn(cam_p, isect.full_tables, width=width,
                                   height=height, sky_mode="none", shading="raw")
    t, aux = t.reshape(-1), aux.reshape(-1)

    dev = mv.device
    ys, xs = torch.meshgrid(torch.arange(height, dtype=torch.float32, device=dev),
                            torch.arange(width, dtype=torch.float32, device=dev),
                            indexing="ij")
    origins, dirs = primary_rays(camera, xs, ys, width, height)
    origins, dirs = origins.reshape(-1, 3), dirs.reshape(-1, 3)

    ax = (aux >> mega.AUX_AX_SHIFT) & 7
    resolved = ((aux >> mega.AUX_RESOLVED_SHIFT) & 1) == 1
    ok = (t < mega.BIG) & resolved
    mat = torch.where(ok, aux & 255, 0)
    albedo = isect.pal[mat.long()]
    hit = HitResult(
        t=torch.where(ok, t, BIG_F32),
        mat=mat,
        normal=torch.where(ok[:, None], isect._normal(ax), 0.0),
        albedo=torch.where(ok[:, None], albedo, 0.0),
        steps=(aux >> mega.AUX_STEPS_SHIFT) & 0x7ffff,
        obj=torch.where(ok, 0, -1).to(torch.int32),
    )
    return hit, origins, dirs


class WhittedMegaRenderer:
    """Stateful wrapper (the kernel-backed sibling of
    `renderer.Renderer`): owns the frame counter and, with
    ``config.accumulate``, carries the temporal accumulator and the
    previous view pyramid across frames (renderer.cpp:240-244,
    camera.cpp:3-16)."""

    def __init__(self, isect: MegaIntersector, scene, config):
        self.isect = isect
        self.scene = scene
        self.config = config
        self.frame = 0
        self._accu = None
        self._prev_planes = None

    def reset_history(self):
        self._accu = None
        self._prev_planes = None

    def render(self, camera, depth_delta: float = 0.0):
        from voxel_tracer_tpu_torch.renderer import empty_accu

        cfg = self.config
        frame = self.frame
        self.frame = (self.frame + 1) % 120      # renderer.cpp:161-162
        if not cfg.accumulate:
            return render_whitted_mega(self.isect, self.scene, camera,
                                       cfg.width, cfg.height, frame, config=cfg)
        if self._accu is None:
            self._accu = empty_accu(cfg.width, cfg.height, self.isect.device)
            self._prev_planes = camera.planes
        out = render_whitted_mega(
            self.isect, self.scene, camera, cfg.width, cfg.height, frame,
            config=cfg, prev_accu=self._accu, prev_planes=self._prev_planes,
            depth_delta=depth_delta)
        self._accu = out["accu"]
        self._prev_planes = camera.planes        # Camera::tick save
        return out


def render_whitted_mega(isect: MegaIntersector, scene, camera, width,
                        height, frame, *, config=None, tile_rows=8,
                        tile_w=32, prev_accu=None, prev_planes=None,
                        depth_delta=0.0):
    """Full-material frame on the kernels (renderer.cpp:199-223 +
    materials.cpp:15-48).  Returns `renderer.render_rays`' dict (image and
    AOVs, plus accu with ``config.accumulate``)."""
    from voxel_tracer_tpu_torch.renderer import RenderConfig, render_rays

    if config is None:
        config = RenderConfig(width=width, height=height, shading="full")
    hit, origins, dirs = primary_hit_mega(isect, camera, width, height)
    return render_rays(scene, origins, dirs, frame, config=config,
                       isect=isect, primary_hit=hit, prev_accu=prev_accu,
                       prev_planes=prev_planes, depth_delta=depth_delta)
