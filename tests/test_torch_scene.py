"""Parity: the port's scene model, camera extras and noise vs the JAX package.

Same scenes and inputs, made in code with numpy from seeds, through
`voxel_tracer_tpu_torch` (on the CPU) and `voxel_tracer_tpu`.
Tolerances, each against the JAX function named in the test:
- `Scene.data()`: every array equal (the light's `aoe_sqr` within 1 ulp,
  a float32 division);
- `VoxelVolume` edits, `to_grid`, `get_aabb`: equal; `Camera.look_at`
  and `pyramid_project`: within 1e-6;
- `noise._noise_texture`: array-equal; `sample_2d` / `sample_3d`: 1e-6.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from voxel_tracer_tpu.models.camera import Camera as JCamera
from voxel_tracer_tpu.models.camera import pyramid_project as jproject
from voxel_tracer_tpu.models.scene import Scene as JScene
from voxel_tracer_tpu.models.skydome import SkyDome as JSky
from voxel_tracer_tpu.models.volume import VoxelVolume as JVolume
from voxel_tracer_tpu.ops import noise as jnoise

from voxel_tracer_tpu_torch.convert import (camera_from_jax, scene_from_jax,
                                            volume_from_jax)
from voxel_tracer_tpu_torch.models.camera import Camera, pyramid_project
from voxel_tracer_tpu_torch.models.scene import Scene
from voxel_tracer_tpu_torch.models.skydome import SkyDome
from voxel_tracer_tpu_torch.models.volume import VoxelVolume
from voxel_tracer_tpu_torch.ops import noise

torch.set_num_threads(1)


def _grids(rng):
    """Two volumes of one shape and one of another: two groups."""
    a = (rng.rand(16, 16, 16) < 0.2).astype(np.uint8) * 30
    b = (rng.rand(16, 16, 16) < 0.1).astype(np.uint8) * 3
    c = (rng.rand(20, 12, 28) < 0.15).astype(np.uint8) * 12
    return a, b, c


def _both_scenes():
    rng = np.random.RandomState(5)
    a, b, c = _grids(rng)
    pal = rng.rand(256, 3).astype(np.float32)
    placed = [(a, (0.0, 0.2, 0.0)), (b, (0.9, 0.0, -0.3)), (c, (-1.0, 0.1, 0.5))]
    scenes = []
    for Vol, Sc, Sky in ((JVolume, JScene, JSky), (VoxelVolume, Scene, SkyDome)):
        sc = Sc(volumes=[Vol(g, palette=pal, pos=p, vpu=20.0) for g, p in placed],
                skydome=Sky.procedural(16, 8))
        sc.add_light((0.5, 1.2, -0.6), 0.08, (1.0, 0.9, 0.8), 6.0)
        sc.add_light((-0.4, 0.9, 0.3), 0.05, (0.3, 0.4, 1.0), 2.5)
        sc.add_sphere((0.2, 0.5, 0.1), 0.15, mat=17)
        sc.add_sphere((0.6, 0.4, -0.2), 0.1, mat=20, albedo=(0.2, 0.7, 0.3))
        sc.add_capsule((0.0, 0.0, 0.0), (0.3, 0.6, 0.1), 0.02)
        sc.set_laser([(0.0, 0.1, 0.0), (0.5, 0.1, 0.0), (0.5, 0.5, 0.2)])
        scenes.append(sc)
    return scenes


def _flat(x, prefix=""):
    """Nested NamedTuples of arrays -> {path: numpy array}."""
    if hasattr(x, "_fields"):
        out = {}
        for f in x._fields:
            out.update(_flat(getattr(x, f), f"{prefix}{f}."))
        return out
    if isinstance(x, tuple):
        out = {}
        for i, v in enumerate(x):
            out.update(_flat(v, f"{prefix}{i}."))
        return out
    return {prefix[:-1]: np.asarray(x)}


def _assert_scene_data_equal(ref, out):
    ref, out = _flat(ref), _flat(out)
    assert ref.keys() == out.keys()
    for k in ref:
        assert out[k].shape == ref[k].shape, k
        if k == "lights.aoe_sqr":
            np.testing.assert_allclose(out[k], ref[k], rtol=2e-7, err_msg=k)
        else:
            np.testing.assert_array_equal(out[k], ref[k], err_msg=k)


def test_scene_data_groups_lights_prims():
    jsc, sc = _both_scenes()
    ref, out = jsc.data(), sc.data(device="cpu")
    assert len(out.groups) == 2
    assert [g.grid.shape[0] for g in out.groups] == [2, 1]
    assert out.lights.origin.shape == (2, 3)
    # the laser chain replaced the first capsule: 2 segments
    assert out.prims.cap_a.shape[0] == 2 and out.prims.sph_origin.shape[0] == 2
    assert out.groups[0].grid.dtype == torch.int32
    assert out.groups[0].vpu.shape == (2,)
    _assert_scene_data_equal(ref, out)


def test_scene_data_without_lights_or_prims():
    g = np.zeros((8, 8, 8), np.uint8)
    g[2:5, 2:5, 2:5] = 40
    ref = JScene(volumes=[JVolume(g)]).data()
    out = Scene(volumes=[VoxelVolume(g)]).data(device="cpu")
    assert out.lights.origin.shape == (0, 3) and out.prims.count == 0
    _assert_scene_data_equal(ref, out)


def test_scene_from_jax():
    jsc, sc = _both_scenes()
    ref = jsc.data()
    out = scene_from_jax(ref, device="cpu")
    _assert_scene_data_equal(ref, out)
    assert out.groups[0].grid.dtype == torch.int32
    assert out.prims.sph_mat.dtype == torch.int32
    assert out.lights.aoe_sqr.dtype == torch.float32
    # the port's own upload gives the same record
    _assert_scene_data_equal(out, sc.data(device="cpu"))


def test_volume_edits_and_transforms():
    rng = np.random.RandomState(9)
    g = (rng.rand(20, 12, 28) < 0.3).astype(np.uint8) * 7
    rot = np.array([[0.0, 0.0, 1.0], [0.0, 1.0, 0.0], [-1.0, 0.0, 0.0]], np.float32)
    jv = JVolume(g, pos=(0.3, -0.1, 0.2), vpu=16.0)
    tv = volume_from_jax(jv)
    for v in (jv, tv):
        v.set_voxel(3, 4, 5, 0)
        v.set_voxel(27, 11, 19, 9)
        v.set_voxel(0, 0, 0, 200)
        v.set_position((0.5, 0.25, -0.75))
        v.set_rotation(rot)
    np.testing.assert_array_equal(tv.grid, jv.grid)
    np.testing.assert_array_equal(tv.brick_occ, jv.brick_occ)
    for xyz in ((3, 4, 5), (27, 11, 19), (0, 0, 0), (10, 6, 2)):
        assert tv.get_voxel(*xyz) == jv.get_voxel(*xyz)
    pts = rng.uniform(-1.5, 1.5, (64, 3)).astype(np.float32)
    for p in pts:
        np.testing.assert_array_equal(tv.to_grid(p), jv.to_grid(p))
    for a, b in zip(tv.get_aabb(), jv.get_aabb()):
        np.testing.assert_array_equal(a, b)
    ref, out = jv.data(), tv.data(device="cpu")
    assert out.grid.dtype == torch.int32 and out.vpu.shape == ()
    for f in ref._fields:
        np.testing.assert_array_equal(getattr(out, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    with pytest.raises(IndexError):
        tv.set_voxel(28, 0, 0, 1)


def test_camera_look_at_and_pyramid_project():
    rng = np.random.RandomState(11)
    for _ in range(4):
        pos = rng.uniform(-3, 3, 3).astype(np.float32)
        target = rng.uniform(-1, 1, 3).astype(np.float32)
        aspect = float(rng.uniform(0.5, 2.5))
        jc = JCamera.create((0, 0, -1), (0, 0, 0)).look_at(pos, target, aspect)
        tc = Camera.create((0, 0, -1), (0, 0, 0)).look_at(pos, target, aspect)
        for f in jc._fields:
            np.testing.assert_allclose(getattr(tc, f).numpy(),
                                       np.asarray(getattr(jc, f)), atol=1e-6,
                                       err_msg=f)
        pts = (target + rng.uniform(-1, 1, (256, 3))).astype(np.float32)
        ref = np.asarray(jproject(jc.planes, jnp.asarray(pts)))
        out = pyramid_project(camera_from_jax(jc).planes, torch.from_numpy(pts))
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-6, rtol=1e-6)
        inside = (ref > 0) & (ref < 1)
        assert inside.all(axis=1).sum() > 10


@pytest.mark.parametrize("channels", [2, 3])
def test_noise_texture_is_the_jax_array(channels):
    ref = jnoise._noise_texture(channels)
    out = noise._noise_texture(channels)
    assert out.shape == (128, 128, channels) and out.dtype == np.float32
    np.testing.assert_array_equal(out, ref)


def test_noise_samples():
    rng = np.random.RandomState(13)
    xs = rng.randint(0, 1280, 4096).astype(np.int32)
    ys = rng.randint(0, 768, 4096).astype(np.int32)
    for frame in (0, 7, 119):
        for offset in (0.0, 0.5):
            for fn, jfn in ((noise.sample_2d, jnoise.sample_2d),
                            (noise.sample_3d, jnoise.sample_3d)):
                ref = np.asarray(jfn(jnp.asarray(xs), jnp.asarray(ys),
                                     jnp.int32(frame), offset))
                out = fn(torch.from_numpy(xs), torch.from_numpy(ys), frame, offset)
                np.testing.assert_allclose(out.numpy(), ref, atol=1e-6, rtol=0)
    ref = np.asarray(jnoise.sampler_3d(3000, jnp.int32(5), width=64))
    out = noise.sampler_3d(3000, 5, width=64, device="cpu")
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6, rtol=0)
    ref = np.asarray(jnoise.sampler_2d(3000, jnp.int32(5)))
    out = noise.sampler_2d(3000, 5, device="cpu")
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6, rtol=0)
