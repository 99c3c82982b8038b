"""Parity: the port's kernel-backed Whitted frame (`ops/cuda/whitted.py`)
vs the JAX package, on the CPU.

On CPU tensors every trace of `MegaIntersector` and the primary pass of
`primary_hit_mega` run the plain versions of the kernels B1 / B2
(`mega.render_mega_tiles_plain`, `mega.trace_rays_plain`), the same
float32 program the kernels run on the card.  The scene is the material
scene of tests/test_whitted_mega.py:25-43 (tests/test_torch_renderer.py).
Tolerances:
- `render_whitted_mega` against the JAX `render_rays` (the XLA wavefront
  DDA): the pinned budgets of tests/test_whitted_mega.py:72-88, at most
  130 of 3072 pixels over 5 % relative colour error, mean relative error
  below 0.015, depth within 5e-3 where both hit, hit counts within 4;
- the compacted frame (`compact=True` on the config and the intersector)
  equals the uncompacted one, field for field;
- inverted-table traces against the DDA's `medium` mode: t, material
  and axis equal where the medium march exits at a voxel, and within
  1e-5 at the grid exit (placed analytically);
- `render_lambert_mega(prev_accu=...)`: a fixed point on hit pixels
  (rtol 1e-4, as tests/test_whitted_mega.py:146-174) and, against the JAX
  kernel in interpret mode with 32x32 tiles, hit mask equal and
  irradiance, accumulator and depth within 1e-5.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from voxel_tracer_tpu.models.camera import Camera as JCamera
from voxel_tracer_tpu.models.camera import rays_for_image as jrays_for_image
from voxel_tracer_tpu.models.volume import VoxelVolume as JVolume
from voxel_tracer_tpu.ops.math3d import BIG_F32 as JBIG
from voxel_tracer_tpu.ops.pallas import mega as jmega
from voxel_tracer_tpu.renderer import RenderConfig as JConfig
from voxel_tracer_tpu.renderer import render_rays as jrender_rays

from voxel_tracer_tpu_torch.convert import camera_from_jax, scene_from_jax, volume_from_jax
from voxel_tracer_tpu_torch.models.volume import VoxelVolume
from voxel_tracer_tpu_torch.ops import dda
from voxel_tracer_tpu_torch.ops.cuda import mega
from voxel_tracer_tpu_torch.ops.cuda.whitted import (MegaIntersector, WhittedMegaRenderer,
                                                     primary_hit_mega, render_whitted_mega)
from voxel_tracer_tpu_torch.renderer import RenderConfig, empty_accu

from test_torch_renderer import compare_frames, material_scene

torch.set_num_threads(1)

W, H = 64, 48
FRAME = 7


def _config(cls, **kw):
    return cls(width=W, height=H, shading="full", max_bounces=3, glass_reflections=2,
               **kw)


@pytest.fixture(scope="module")
def setup():
    jvol, scene = material_scene()
    jsd = scene.data()
    jcam = JCamera.create((1.1, 0.9, -1.5), (0.0, 0.3, 0.0), W / H)
    sd, cam = scene_from_jax(jsd, device="cpu"), camera_from_jax(jcam)
    mv = mega.MegaVolume(volume_from_jax(jvol), device="cpu")
    isect = MegaIntersector(mv, tile_rows=8, fine_iters=96, shadow_rounds=4,
                            interpret=True)
    o, d = jrays_for_image(jcam, W, H)
    ref = jrender_rays(jsd, o, d, jnp.int32(FRAME), config=_config(JConfig))
    out = render_whitted_mega(isect, sd, cam, W, H, FRAME, config=_config(RenderConfig))
    return dict(sd=sd, cam=cam, mv=mv, isect=isect, ref=ref, out=out)


def test_whitted_frame_matches_jax_render_rays(setup):
    compare_frames(setup["ref"], setup["out"], exact=False)
    assert isinstance(setup["isect"].glass_ids, list) and setup["isect"].glass_ids == [3]


def test_compacted_frame_equals_uncompacted(setup):
    isect = MegaIntersector(setup["mv"], shadow_rounds=4, compact=True)
    out = render_whitted_mega(isect, setup["sd"], setup["cam"], W, H, FRAME,
                              config=_config(RenderConfig, compact=True))
    for k, v in setup["out"].items():
        assert torch.equal(out[k], v), k


def test_glass_sees_pillar_through_wall(setup):
    """The diffuse pillar inside the glass box shows through the wall
    (medium march + scan continuation), as test_whitted_mega.py:177-188."""
    mats = setup["out"]["material"].reshape(-1)
    assert int((mats == 3).sum()) > 20          # glass front faces hit
    img = setup["out"]["color"].reshape(-1, 3)
    assert float(img[mats == 3].std()) > 0.01


def test_primary_hit_matches_wavefront(setup):
    """B1's plain primary pass and the wavefront intersect agree on the
    frame's primary rays (same DDA, one volume)."""
    from voxel_tracer_tpu_torch.ops import composite
    hit, o, d = primary_hit_mega(setup["isect"], setup["cam"], W, H)
    ref = composite.intersect_scene(setup["sd"], o, d)
    both = (hit.t < 1e30) & (ref.t < 1e30)
    assert int(both.sum()) > 500
    assert int(((hit.t < 1e30) != (ref.t < 1e30)).sum()) <= 4
    assert float((hit.t[both] - ref.t[both]).abs().max()) < 5e-3
    assert torch.equal(hit.mat[both], ref.mat[both])


def test_whitted_renderer_state_machine(setup):
    cfg = RenderConfig(width=32, height=24, shading="full", max_bounces=2,
                       glass_reflections=1, accumulate=True)
    isect = setup["isect"]
    from voxel_tracer_tpu_torch.models.camera import Camera
    cam = Camera.create((1.1, 0.9, -1.5), (0.0, 0.3, 0.0), cfg.aspect)
    r = WhittedMegaRenderer(isect, setup["sd"], cfg)
    out1 = r.render(cam)
    assert "accu" in out1 and r.frame == 1
    out2 = r.render(cam)
    assert bool(torch.isfinite(out2["image"]).all())
    assert not torch.equal(out1["accu"], out2["accu"])
    assert torch.equal(out2["accu"][..., :3], out2["irradiance"])
    r.reset_history()
    assert r._accu is None and r._prev_planes is None
    r2 = WhittedMegaRenderer(isect, setup["sd"], dataclasses.replace(cfg, accumulate=False))
    r2.frame = 119
    assert "accu" not in r2.render(cam) and r2.frame == 0


def test_intersector_tables_follow_edits(setup):
    """set_voxel edits the full and the inverted tables in place, so a
    table_state taken before the edit sees it; with_table_state swaps
    another state in on a copy."""
    def fresh():
        return mega.MegaVolume(VoxelVolume(setup["mv"].volume.grid.copy(),
                                           palette=setup["mv"].volume.palette), device="cpu")
    isect = MegaIntersector(fresh())
    state = isect.table_state()
    assert isect.glass_ids == [3]
    isect.set_voxel(20, 10, 5, 3)
    assert int(isect.full_tables.grid[5, 10, 20]) == 3
    assert int(isect.inv_tables[3].grid[5, 10, 20]) == 0           # glass: open
    assert int(isect.inv_tables[3].grid[5, 10, 21]) == 256          # air: stops
    assert state[0] is isect.full_tables and int(state[0].grid[5, 10, 20]) == 3
    old = isect.with_table_state(MegaIntersector(fresh()).table_state())
    assert int(old.full_tables.grid[5, 10, 20]) == 0 and old is not isect
    assert int(isect.full_tables.grid[5, 10, 20]) == 3


def _glass_grid():
    """36x20x28 (z, y, x) grid, sides not multiples of 8: a glass (id 4)
    slab touching the far faces, diffuse and mirror voxels inside it."""
    g = np.zeros((36, 20, 28), np.uint8)
    g[6:, 4:, 9:] = 4
    g[14:20, 8:12, 14:18] = 40
    g[24:30, 6:9, 20:24] = 12
    g[30:33, 15:18, 11:13] = 0
    return g


def test_inverted_tables_match_medium_march():
    g = _glass_grid()
    vpu = 20.0
    tb = mega.pack_tables(g, np.ones((256, 3), np.float32), vpu, "cpu", occupied=g != 4)
    assert tb.bsize == (4, 3, 5) and tb.gsize == (28, 20, 36)
    # the padding beyond the grid is open, the in-grid air solid; bricks
    # all of glass are empty
    assert int(tb.brick_occ.sum()) == int((g != 4).sum())
    assert 0 < int(tb.bocc.sum()) < tb.bocc.numel()
    rng = np.random.RandomState(3)
    n = 4096
    size = np.array([28, 20, 36], np.float32) / vpu
    lo = np.array([9, 4, 6], np.float32) / vpu
    o = (lo + rng.uniform(0.01, 0.99, (n, 3)) * (size - lo)).astype(np.float32)
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o_t, d_t = torch.from_numpy(o), torch.from_numpy(d)
    inv = mega.trace_rays_plain(o_t, d_t, tb, fetch_mat=True)
    ref = dda.intersect_volume_local(
        torch.from_numpy(g), torch.from_numpy(VoxelVolume(g, vpu=vpu).brick_occ), o_t, d_t,
        vpu, medium=torch.full((n,), 4, dtype=torch.int32))
    start_in = torch.from_numpy(g[tuple(np.floor(o * vpu).astype(int)[:, ::-1].T)] == 4)
    assert int(start_in.sum()) > n // 2
    hit = inv["t"] < mega.BIG
    assert bool(inv["resolved"].all()) and int(hit.sum()) > n // 4
    exits = ~hit & start_in
    assert int(exits.sum()) > 100                    # grid exits through far faces
    sel = hit & start_in
    assert torch.equal(inv["t"][sel], ref["t"][sel])
    assert torch.equal(inv["mat"][sel], ref["mat"][sel])
    sgn = torch.gather(ref["step_sign"], 1, ref["axis"].long()[:, None])[:, 0] > 0
    assert torch.equal(inv["ax"][sel], (ref["axis"] * 2 + sgn.to(torch.int32))[sel])
    # kernel misses are grid exits: the medium march ends at the slab tmax
    # (or, through a face inside a brick, at the padding voxel past it)
    assert bool((ref["mat"][exits] == 0).all())
    assert float((ref["slab_tmax"][exits] - ref["t"][exits]).abs().max()) < 1e-5
    # MegaIntersector's analytic exit lands there too
    mv = mega.MegaVolume(VoxelVolume(g, vpu=vpu), device="cpu")
    isect = MegaIntersector(mv)
    t_exit, _axis = isect._exit_slab(o_t, d_t)
    assert float((t_exit[exits] - ref["t"][exits]).abs().max()) < 1e-5


def _cube():
    n = 16
    g = np.zeros((n, n, n), np.uint8)
    g[4:12, 4:12, 4:12] = 30
    return g


def test_lambert_mega_prev_accu_fixed_point():
    """Identical deterministic frames: blending 95 % history is a fixed
    point on hit pixels (test_whitted_mega.py:146-174)."""
    from voxel_tracer_tpu_torch.models.camera import Camera
    mv = mega.MegaVolume(VoxelVolume(_cube(), vpu=20.0), device="cpu")
    w, h = 64, 32
    cam = Camera.create((1.2, 0.9, -1.4), (0, 0, 0), w / h)
    base = mega.render_lambert_mega(mv, cam, w, h)
    accu = empty_accu(w, h, "cpu")
    for _ in range(3):
        out = mega.render_lambert_mega(mv, cam, w, h, prev_accu=accu,
                                       prev_planes=cam.planes)
        accu = out["accu"]
    hit = base["depth"] < mega.BIG
    assert int(hit.sum()) > 50
    np.testing.assert_allclose(out["irradiance"][hit].numpy(),
                               base["irradiance"][hit].numpy(), rtol=1e-4, atol=1e-4)
    plain = mega.render_lambert_mega_plain(mv, cam, w, h, prev_accu=accu,
                                           prev_planes=cam.planes)
    assert torch.equal(plain["accu"][..., 3], base["depth"])


def test_lambert_mega_prev_accu_matches_jax():
    """Two accumulated frames from a moving camera, against the JAX kernel
    path in interpret mode with 32x32 tiles (ROADMAP C, hier3 caveat)."""
    w, h = 64, 32
    jvol = JVolume(_cube(), pos=(0, 0, 0), vpu=20.0)
    jmv = jmega.MegaVolume(jvol)
    mv = mega.MegaVolume(volume_from_jax(jvol), device="cpu")
    cams = [JCamera.create((1.2, 0.9, -1.4), (0, 0, 0), w / h),
            JCamera.create((1.22, 0.9, -1.39), (0, 0, 0), w / h)]
    jaccu = jnp.concatenate([jnp.zeros((h, w, 3), jnp.float32),
                             jnp.full((h, w, 1), JBIG, jnp.float32)], axis=-1)
    accu = empty_accu(w, h, "cpu")
    prev_j = prev_t = None
    for jc in cams:
        tc = camera_from_jax(jc)
        ref = jmega.render_lambert_mega(jmv, jc, w, h, interpret=True, tile_rows=8,
                                        tile_w=32, prev_accu=jaccu,
                                        prev_planes=jc.planes if prev_j is None else prev_j,
                                        depth_delta=0.01)
        out = mega.render_lambert_mega(mv, tc, w, h, prev_accu=accu,
                                       prev_planes=tc.planes if prev_t is None else prev_t,
                                       depth_delta=0.01)
        jaccu, accu = ref["accu"], out["accu"]
        prev_j, prev_t = jc.planes, tc.planes
        hit = np.asarray(ref["depth"]) < 1e30
        assert hit.sum() > 50
        np.testing.assert_array_equal(out["depth"].numpy() < 1e30, hit)
        np.testing.assert_allclose(out["depth"].numpy()[hit], np.asarray(ref["depth"])[hit],
                                   atol=1e-5, rtol=0)
        for k in ("irradiance", "accu"):
            np.testing.assert_allclose(out[k].numpy()[hit], np.asarray(ref[k])[hit],
                                       atol=1e-5, rtol=1e-6, err_msg=k)
    # the second frame took history on most hit pixels
    assert (np.abs(out["irradiance"].numpy() - 0.2) > 0).any()
