"""Parity: the port's torch DDA vs `voxel_tracer_tpu.ops.dda`.

Same local-space rays (made with numpy from a seed) through
`voxel_tracer_tpu_torch.ops.dda.intersect_volume_local` and the JAX
`intersect_volume_local`, over the cases of `tests/test_dda_parity.py`.
Tolerances: hit, mat, axis and steps exactly equal; t within atol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from voxel_tracer_tpu.models.camera import Camera, rays_for_image
from voxel_tracer_tpu.models.volume import VoxelVolume
from voxel_tracer_tpu.ops import dda as jdda

from voxel_tracer_tpu_torch.ops import dda as tdda
from voxel_tracer_tpu_torch.ops import math3d as tmath3d
from voxel_tracer_tpu_torch.utils import profiling

torch.set_num_threads(1)

T_ATOL = 1e-5


def _rotation(axis, angle):
    """(3, 3) float32 rotation by ``angle`` about ``axis`` (numpy)."""
    return tmath3d.quat_to_mat3(tmath3d.quat_from_axis_angle(axis, angle, device="cpu")).numpy()


def _sphere_grid(n=64, r=0.4, material=5):
    z, y, x = np.meshgrid(*[np.arange(n)] * 3, indexing="ij")
    c = (n - 1) / 2.0
    d = np.sqrt((x - c) ** 2 + (y - c) ** 2 + (z - c) ** 2)
    return np.where(d < r * n, material, 0).astype(np.uint8)


def _camera_rays(pos, target, w=32, h=32):
    o, d = rays_for_image(Camera.create(pos, target, w / h), w, h)
    return np.asarray(o), np.asarray(d)


def _to_local(vol, origins, dirs):
    rt = vol.rot.T
    o_l = ((origins - vol.pos) @ rt.T + vol.pivot).astype(np.float32)
    d_l = (dirs @ rt.T).astype(np.float32)
    return o_l, d_l


def _random_rays(n=256, seed=42):
    rng = np.random.RandomState(seed)
    o = rng.randn(n, 3).astype(np.float32) * 2.0
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _axis_parallel():
    # +-0 components: reciprocal +-inf paths and the sign-bit step rule
    o = np.array([[0.11, 0.23, -3.0], [-3.0, 0.06, 0.13], [0.08, 3.0, 0.21],
                  [0.05, -3.0, 0.07], [0.3, 0.41, 3.0], [3.0, 0.52, 0.33],
                  [0.0, 0.3, -2.0], [0.2, 0.0, -2.0]], np.float32)
    d = np.array([[0, 0, 1], [1, 0, 0], [0, -1, 0], [0, 1, 0],
                  [-0.0, -0.0, -1], [-1, -0.0, 0], [0, 0, 1], [-0.0, 0, 1]],
                 np.float32)
    return o, d


def _case(name):
    if name == "axis_aligned":
        vol = VoxelVolume(_sphere_grid(), pos=(0, 0, 0), vpu=20.0)
        return vol, _camera_rays((0.013, 0.007, -4), (0, 0, 0))
    if name == "oblique":
        vol = VoxelVolume(_sphere_grid(), pos=(0.5, -0.2, 0.1), vpu=20.0)
        return vol, _camera_rays((2.5, 1.5, -2.5), (0.5, -0.2, 0.1))
    if name == "camera_inside":
        # (test_dda_parity looks straight down, where the camera basis is
        # NaN; here the target is nudged off the vertical)
        vol = VoxelVolume(_sphere_grid(64, r=0.3), vpu=20.0)
        return vol, _camera_rays((0.0, 1.2, 0.0), (0.05, 0.0, 0.1))
    if name == "rotated":
        rot = _rotation((0, 1, 0), 0.7)
        vol = VoxelVolume(_sphere_grid(), rot=rot, vpu=20.0)
        return vol, _camera_rays((0, 0.5, -4), (0, 0, 0))
    if name == "noise":
        vol = VoxelVolume.noise_filled((64, 64, 64))
        return vol, _camera_rays((-2, 2, -4), (0, 0, 0))
    if name == "non_multiple_of_brick":
        vol = VoxelVolume(_sphere_grid(64)[:50, :44, :60], vpu=20.0)
        return vol, _camera_rays((0.4, 0.6, -3), (0, 0, 0))
    if name == "random_directions":
        return VoxelVolume.noise_filled((32, 32, 32)), _random_rays()
    if name == "axis_parallel":
        return VoxelVolume(_sphere_grid(32), vpu=20.0), _axis_parallel()
    if name == "step_budget":
        # a tiny budget forces exhaustion on most rays
        vol = VoxelVolume.noise_filled((64, 64, 64))
        return vol, _camera_rays((0, 0, -4), (0, 0, 0), 16, 16)
    if name == "long_sparse":
        # the default budget runs out on most rays: a 288-brick cut of the
        # card tests' long sparse volume (profiling.budget_scene)
        g, o_l, d_l, vpu = profiling.budget_scene(length=2304, n_rays=512)
        vol = VoxelVolume(g, vpu=vpu)
        return vol, (o_l - np.asarray(vol.pivot), d_l)
    raise ValueError(name)


CASES = ["axis_aligned", "oblique", "camera_inside", "rotated", "noise",
         "non_multiple_of_brick", "random_directions", "axis_parallel",
         "step_budget", "long_sparse"]


@pytest.mark.parametrize("name", CASES)
def test_dda_matches_jax(name):
    vol, (o, d) = _case(name)
    max_steps = 12 if name == "step_budget" else tdda.MAX_STEPS
    o_l, d_l = _to_local(vol, o, d)
    data = vol.data()
    ref = jdda.intersect_volume_local(
        data.grid, data.brick_occ, jnp.asarray(o_l), jnp.asarray(d_l),
        data.vpu, max_steps=max_steps)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    out = tdda.intersect_volume_local(
        torch.from_numpy(vol.grid), torch.from_numpy(vol.brick_occ),
        torch.from_numpy(o_l), torch.from_numpy(d_l), vol.vpu,
        max_steps=max_steps)
    out = {k: v.numpy() for k, v in out.items()}

    hit_ref = ref["t"] < 1e30
    hit = out["t"] < 1e30
    np.testing.assert_array_equal(hit, hit_ref)
    np.testing.assert_allclose(out["t"][hit], ref["t"][hit], atol=T_ATOL,
                               rtol=0)
    np.testing.assert_array_equal(out["mat"], ref["mat"])
    np.testing.assert_array_equal(out["axis"], ref["axis"])
    np.testing.assert_array_equal(out["steps"], ref["steps"])
    np.testing.assert_array_equal(out["step_sign"], ref["step_sign"])
    np.testing.assert_array_equal(out["valid"], ref["valid"])
    assert (out["steps"] <= max_steps).all()
    # an unresolved ray spent the whole budget and is a miss: the reference
    # loop's cap of 2 * max_steps iterations never stopped a walk earlier
    # (the kernels, which walk without that cap, rely on it)
    unresolved = ~out["resolved"]
    assert (out["valid"] & ~hit & (out["steps"] >= max_steps))[unresolved].all()
    if name == "step_budget":
        assert unresolved.any()
    else:
        assert hit.any()
    if name == "long_sparse":
        assert unresolved.sum() > len(unresolved) // 2


# ---------------------------------------------------------------------------
# The glass and shadow modes (medium, ignore, shadow), stacked grids (oid)
# and per-ray vpu.  Tolerance: t bit-equal, every integer field equal.
# ---------------------------------------------------------------------------

def _inside_rays(vol, n, seed):
    """n rays with origins inside the volume (volume-local), random
    directions, 1/16 of them axis-parallel."""
    rng = np.random.RandomState(seed)
    size = np.asarray(vol.size, np.float32)
    o = (rng.uniform(0.02, 0.98, (n, 3)) * size).astype(np.float32)
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    k = n // 16
    ax = rng.randint(0, 3, k)
    d[:k] = 0.0
    d[np.arange(k), ax] = np.where(rng.rand(k) < 0.5, -1.0, 1.0)
    return o, d


def _mode_scene(name):
    """(volume, local origins, local dirs) for the mode tests: the scenes of
    tests/test_dda_parity.py, plus rays that start inside the volume."""
    if name == "sphere_inside":
        # glass sphere (id 5), rays from inside the volume, many inside it
        vol = VoxelVolume(_sphere_grid(), vpu=20.0)
        return (vol,) + _inside_rays(vol, 512, 1)
    if name == "cut_sphere":
        # 50x44x60: glass touches the far faces, bricks are cut
        vol = VoxelVolume(_sphere_grid(64)[:50, :44, :60], vpu=20.0)
        return (vol,) + _inside_rays(vol, 512, 2)
    if name == "noise":
        # id 16 (the mirror row: stochastic shadows, ignore passes)
        vol = VoxelVolume.noise_filled((32, 32, 32))
        return (vol,) + _inside_rays(vol, 512, 3)
    vol, (o, d) = _case(name)
    return (vol,) + _to_local(vol, o, d)


MODE_SCENES = ["sphere_inside", "cut_sphere", "noise", "oblique",
               "camera_inside", "axis_parallel", "random_directions"]


def _mode_kwargs(mode, vol, n, seed):
    """Per-mode keyword arguments as numpy arrays."""
    rng = np.random.RandomState(seed)
    ids = np.unique(vol.grid[vol.grid > 0])
    g = int(ids[0])
    if mode == "medium":
        # half the rays inside medium g, the rest plain
        return dict(medium=np.where(rng.rand(n) < 0.5, g, 0).astype(np.int32))
    if mode == "ignore":
        return dict(ignore=np.where(rng.rand(n) < 0.75, g, 0).astype(np.int32))
    if mode == "shadow":
        seed_u32 = rng.randint(0, 2 ** 32, n, dtype=np.uint64)
        seed_u32[:n // 4] |= np.uint64(1 << 31)       # seeds >= 2**31
        return dict(shadow_seed=seed_u32.astype(np.uint32), shadow=True)
    raise ValueError(mode)


def _run_both(grid, bocc, o_l, d_l, vpu, kw, max_steps=tdda.MAX_STEPS):
    jkw, tkw = {}, {}
    for k, v in kw.items():
        if isinstance(v, np.ndarray):
            jkw[k] = jnp.asarray(v)
            tkw[k] = torch.from_numpy(v.astype(np.int64) if v.dtype == np.uint32 else v)
        else:
            jkw[k] = tkw[k] = v
    jvpu = jnp.asarray(vpu) if isinstance(vpu, np.ndarray) else vpu
    tvpu = torch.from_numpy(vpu) if isinstance(vpu, np.ndarray) else vpu
    ref = jdda.intersect_volume_local(
        jnp.asarray(grid.astype(np.int32)), jnp.asarray(bocc), jnp.asarray(o_l),
        jnp.asarray(d_l), jvpu, max_steps=max_steps, **jkw)
    out = tdda.intersect_volume_local(
        torch.from_numpy(grid), torch.from_numpy(bocc), torch.from_numpy(o_l),
        torch.from_numpy(d_l), tvpu, max_steps=max_steps, **tkw)
    return ({k: np.asarray(v) for k, v in ref.items()},
            {k: v.numpy() for k, v in out.items()})


def _assert_bit_equal(ref, out):
    np.testing.assert_array_equal(out["t"].view(np.int32), ref["t"].view(np.int32))
    for f in ("mat", "axis", "steps", "step_sign", "valid"):
        np.testing.assert_array_equal(out[f], ref[f], err_msg=f)


@pytest.mark.parametrize("mode", ["medium", "ignore", "shadow"])
@pytest.mark.parametrize("name", MODE_SCENES)
def test_dda_modes_match_jax(mode, name):
    vol, o_l, d_l = _mode_scene(name)
    kw = _mode_kwargs(mode, vol, o_l.shape[0], 17)
    ref, out = _run_both(vol.grid, vol.brick_occ, o_l, d_l, vol.vpu, kw)
    _assert_bit_equal(ref, out)
    hit = out["t"] < 1e30
    assert hit.any()
    if mode == "medium":
        # interior rays never miss
        assert hit[kw["medium"] > 0].all()
        assert (out["mat"][kw["medium"] > 0] != kw["medium"][kw["medium"] > 0]).all()


def test_dda_medium_step_budget_exit():
    """Interior rays that run out of the budget exit at the slab tmax with
    the tmax-ladder axis (vv.cpp:206-225)."""
    vol, o_l, d_l = _mode_scene("noise")
    kw = _mode_kwargs("medium", vol, o_l.shape[0], 5)
    ref, out = _run_both(vol.grid, vol.brick_occ, o_l, d_l, vol.vpu, kw, max_steps=6)
    _assert_bit_equal(ref, out)
    # (a ray still walking when the last in-budget ray finished stays a
    # miss, as in the JAX loop)
    exhausted = (kw["medium"] > 0) & (out["steps"] >= 6) & (out["t"] < 1e30)
    assert exhausted.sum() > 10
    np.testing.assert_array_equal(out["t"][exhausted], out["slab_tmax"][exhausted])


@pytest.mark.parametrize("mode", [None, "medium", "shadow"])
def test_dda_stacked_grids_and_per_ray_vpu(mode):
    """oid over stacked (O, Z, Y, X) grids with a per-ray vpu, as scene
    composition traces them."""
    grids = [_sphere_grid(32), VoxelVolume.noise_filled((32, 32, 32)).grid,
             _sphere_grid(32, r=0.3, material=40)]
    grid = np.stack(grids)
    bocc = np.stack([VoxelVolume(g).brick_occ for g in grids])
    vpus = np.array([20.0, 16.0, 25.0], np.float32)
    rng = np.random.RandomState(23)
    n = 768
    oid = rng.randint(0, 3, n).astype(np.int32)
    vpu = vpus[oid]
    size = 32.0 / vpu[:, None]
    o_l = (rng.uniform(-0.3, 1.3, (n, 3)) * size).astype(np.float32)
    d_l = rng.randn(n, 3).astype(np.float32)
    d_l /= np.linalg.norm(d_l, axis=1, keepdims=True)
    kw = dict(oid=oid)
    if mode is not None:
        kw.update(_mode_kwargs(mode, VoxelVolume(grids[0]), n, 29))
    ref, out = _run_both(grid, bocc, o_l, d_l, vpu, kw)
    _assert_bit_equal(ref, out)
    for k in range(3):
        assert (out["t"][oid == k] < 1e30).any()


def test_hash_shadow_bit_equal():
    """4096 random (seed, cell) pairs, a quarter of the seeds >= 2**31 and
    some cells negative or beyond 2**16."""
    rng = np.random.RandomState(31)
    n = 4096
    seed = rng.randint(0, 2 ** 32, n, dtype=np.uint64)
    seed[:n // 4] |= np.uint64(1 << 31)
    cell = rng.randint(-70000, 70000, (n, 3)).astype(np.int32)
    cell[n // 2:] = rng.randint(0, 512, (n // 2, 3))
    ref = np.asarray(jdda.hash_shadow(jnp.asarray(seed.astype(np.uint32)),
                                      jnp.asarray(cell)))
    out = tdda.hash_shadow(torch.from_numpy(seed.astype(np.int64)),
                           torch.from_numpy(cell)).numpy()
    assert out.dtype == np.float32 and (seed >= 2 ** 31).sum() >= n // 4
    np.testing.assert_array_equal(out.view(np.int32), ref.view(np.int32))
    assert 0.0 <= out.min() and out.max() < 1.0
