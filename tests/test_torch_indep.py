"""Parity: the port's independent-DDA frame and ray-list tracer
(`ops/cuda/indep.py`, B3 and B4) vs the JAX package, on CPU.

On CPU tensors the wrappers run their plain PyTorch versions; the JAX side
runs the Pallas kernel in interpret mode, as tests/test_indep.py does, on
that file's two-material sphere (built in code, carried across with
`convert`).

Tolerances, each against the JAX function named in the test, on the rays
the Pallas kernel resolved (a tile that meets more bricks than its vote
rounds leaves rays unresolved; the port resolves every ray):
- `indep.render_indep(interpret=True)`: hit mask, mat and steps equal,
  depth within 1e-5 (the port's raygen roots in float64 where the Pallas
  kernel takes rsqrt, so t may differ in the last bits), image within
  1 LSB.
- `indep.trace_rays_indep(interpret=True, track_steps=True)`: t, mat, ax,
  steps equal (observed bit-equal: the port fuses the multiply-adds XLA
  fuses); against `oracle.intersect_volume` on every 17th ray, hit equal
  and depth within 1e-4, as tests/test_indep.py checks, where the
  oracle's 256-step budget lets the ray finish (the indep walk has none).
  Also on the long sparse volume of `profiling.budget_scene`, at 256 and
  4096 bricks.
"""

import numpy as np
import pytest
import torch

from voxel_tracer_tpu.models.camera import Camera as JCamera
from voxel_tracer_tpu.models.volume import VoxelVolume as JVolume
from voxel_tracer_tpu.ops import oracle
from voxel_tracer_tpu.ops.pallas import indep as jindep
from voxel_tracer_tpu.ops.pallas import mega as jmega

from voxel_tracer_tpu_torch.convert import camera_from_jax, volume_from_jax
from voxel_tracer_tpu_torch.models.volume import VoxelVolume
from voxel_tracer_tpu_torch.ops.cuda import indep, mega
from voxel_tracer_tpu_torch.utils import profiling

torch.set_num_threads(1)


def _two_mat_sphere(n=16, r=0.42):
    z, y, x = np.meshgrid(*[np.arange(n)] * 3, indexing="ij")
    c = (n - 1) / 2
    d = np.sqrt((x - c) ** 2 + (y - c) ** 2 + (z - c) ** 2)
    return np.where(d < r * n, np.where(y > c, 140, 23), 0).astype(np.uint8)


@pytest.fixture(scope="module")
def jvol():
    palette = np.random.RandomState(3).rand(256, 3).astype(np.float32)
    return JVolume(_two_mat_sphere(), palette=palette, pos=(0.1, -0.05, 0.2),
                   vpu=20.0)


@pytest.fixture(scope="module")
def jmv(jvol):
    return jmega.MegaVolume(jvol)


@pytest.fixture(scope="module")
def mv(jvol):
    return mega.MegaVolume(volume_from_jax(jvol), device="cpu")


@pytest.mark.parametrize("grid", [(16, 16, 16), (40, 24, 64), (128, 128, 128)])
def test_pack_brickbits_matches_jax(grid):
    rng = np.random.RandomState(grid[0])
    g = np.where(rng.rand(*grid) < 0.002, 7, 0).astype(np.uint8)
    tb = mega.pack_tables(g, np.ones((256, 3), np.float32), 20.0, device="cpu")
    ref = np.asarray(jindep.occb_of(jmega.pack_mega(g, 20.0)))[0]
    np.testing.assert_array_equal(indep.occb_of(tb).numpy(), ref)


def test_more_than_4096_bricks_raise():
    vol = VoxelVolume(np.zeros((136, 136, 136), np.uint8))    # 17^3 bricks
    mv = mega.MegaVolume(vol, device="cpu")
    with pytest.raises(ValueError, match="4096"):
        indep.occb_of(mv.tables)
    with pytest.raises(ValueError, match="4096"):
        indep.render_indep(mv, camera_from_jax(
            JCamera.create((2.0, 1.0, -2.0), (0.0, 0.0, 0.0), 2.0)), 32, 16)
    o = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="4096"):
        indep.trace_rays_indep(o, o, torch.zeros(128, dtype=torch.int32),
                               mv.tables)


def _frames(jmv, mv, jcam, w, h, **kw):
    ref = {k: np.asarray(v) for k, v in
           jindep.render_indep(jmv, jcam, w, h, interpret=True, **kw).items()}
    out = {k: v.numpy() for k, v in
           indep.render_indep(mv, camera_from_jax(jcam), w, h, **kw).items()}
    return ref, out


def _compare(ref, out, min_hits):
    assert out["resolved"].all()
    res = ref["resolved"] == 1
    hr, ho = ref["depth"] < 1e30, out["depth"] < 1e30
    np.testing.assert_array_equal(ho[res], hr[res])
    both = res & hr
    assert both.sum() >= min_hits
    np.testing.assert_allclose(out["depth"][both], ref["depth"][both],
                               atol=1e-5, rtol=0)
    np.testing.assert_array_equal(out["mat"][res], ref["mat"][res])
    np.testing.assert_array_equal(out["steps"][res], ref["steps"][res])
    diff = np.abs(out["image"].astype(int) - ref["image"].astype(int))
    assert diff[res].max() <= 1


@pytest.mark.parametrize("shading", ["flat", "lambert"])
def test_render_indep_matches_pallas(jvol, jmv, mv, shading):
    w, h = 64, 32
    jcam = JCamera.create((1.2, 0.9, -1.4), jvol.pos, w / h)
    ref, out = _frames(jmv, mv, jcam, w, h, shading=shading)
    assert out["image"].shape == (h, w, 3) and out["image"].dtype == np.uint8
    _compare(ref, out, 60)


def test_render_indep_axis_hugging_camera(jvol, jmv, mv):
    """Camera nearly axis-aligned: every pixel resolves."""
    jcam = JCamera.create((1.4, 0.02, 0.21), jvol.pos, 1.0)
    ref, out = _frames(jmv, mv, jcam, 32, 32, shading="lambert")
    _compare(ref, out, 200)


def test_render_indep_camera_inside_volume(jvol, jmv, mv):
    """Camera inside the sphere's bounding box (the tmin = 0 path)."""
    jcam = JCamera.create(
        np.asarray(jvol.pos) + np.array([0.0, 0.0, -0.36], np.float32),
        jvol.pos, 1.0)
    ref, out = _frames(jmv, mv, jcam, 32, 32)
    _compare(ref, out, 500)


def _assert_trace_parity(jtb, tb, o_l, d, ov, o_world, min_resolved, min_hits,
                         min_checked):
    """`trace_rays_indep` of the port vs the Pallas kernel (interpret) on
    the rays Pallas resolved, and vs `oracle.intersect_volume` on every
    17th ray that the oracle's 256-step budget lets finish (the indep walk
    has no budget)."""
    n = o_l.shape[0]
    ref = {k: np.asarray(v) for k, v in jindep.trace_rays_indep(
        o_l, d, jindep.occb_of(jtb), jtb.occw, jtb.matw, bsize=jtb.bsize,
        vpu=jtb.vpu, tile_rows=min(8, n // 128), track_steps=True,
        interpret=True).items()}
    out = {k: v.numpy() for k, v in indep.trace_rays_indep(
        torch.from_numpy(o_l), torch.from_numpy(d), indep.occb_of(tb),
        tb).items()}
    assert out["resolved"].all()
    res = ref["resolved"]
    assert res.sum() >= min_resolved
    for k in ("t", "mat", "ax", "steps"):
        np.testing.assert_array_equal(out[k][res], ref[k][res], k)
    assert (out["t"] < 1e30).sum() >= min_hits

    checked = 0
    for i in range(0, n, 17):
        hh = oracle.intersect_volume(ov, o_world[i], d[i])
        if hh.steps >= oracle.MAX_STEPS:
            continue
        checked += 1
        assert hh.no_hit == (out["t"][i] >= 1e30), f"ray {i} hit mismatch"
        if not hh.no_hit:
            assert abs(hh.depth - out["t"][i]) < 1e-4, f"ray {i} depth mismatch"
    assert checked >= min_checked


def test_trace_rays_indep_matches_pallas_and_oracle(jvol, jmv, mv):
    rng = np.random.RandomState(42)
    n = 1024
    # random origins on a shell, dirs toward the jittered center
    o = rng.randn(n, 3).astype(np.float32)
    o = o / np.linalg.norm(o, axis=1, keepdims=True) * 1.5
    d = -o + rng.randn(n, 3).astype(np.float32) * 0.1
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    o_l = (o + np.asarray(jvol.pivot)).astype(np.float32)
    ov = oracle.OracleVolume(grid=jvol.grid, vpu=jvol.vpu, pos=jvol.pos)
    _assert_trace_parity(jmv.tables, mv.tables, o_l, d, ov,
                         o + np.asarray(jvol.pos), n, 901, len(range(0, n, 17)))


@pytest.mark.parametrize("length, n_rays", [(512, 256), (8192, 128)],
                         ids=["long_sparse", "4096_bricks"])
def test_trace_rays_indep_long_walks(length, n_rays):
    """`profiling.budget_scene`'s long sparse volume, whose rays walk
    dozens to hundreds of mostly empty bricks: (16, 16, 512) = 2x2x64
    bricks, and (16, 16, 8192) = 4096 bricks, a full 128-word bitmap."""
    g, o_l, d, vpu = profiling.budget_scene(length=length, n_rays=n_rays)
    jtb = jmega.pack_mega(g, vpu)
    tb = mega.pack_tables(g, np.ones((256, 3), np.float32), vpu, device="cpu")
    assert tb.bocc.numel() == length // 8 * 4
    ov = oracle.OracleVolume(grid=g, vpu=vpu, pos=np.zeros(3, np.float32),
                             pivot=np.zeros(3, np.float32))
    _assert_trace_parity(jtb, tb, o_l, d, ov, o_l, 1, 1, 2)
