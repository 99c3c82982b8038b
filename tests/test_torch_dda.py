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
from voxel_tracer_tpu.ops.math3d import quat_from_axis_angle, quat_to_mat3

from voxel_tracer_tpu_torch.ops import dda as tdda
from voxel_tracer_tpu_torch.utils import profiling

torch.set_num_threads(1)

T_ATOL = 1e-5


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
        rot = np.asarray(quat_to_mat3(quat_from_axis_angle((0, 1, 0), 0.7)))
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
