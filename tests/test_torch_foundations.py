"""Parity of the port's foundation modules with the JAX package, on CPU.

Inputs are made with numpy from a seed and go through the JAX function
and its port.  Tolerances: camera fields, rays and kernel camera
parameters allclose at atol 1e-6; grids, brick occupancy, .vox grids and
palettes exactly equal; sky and tonemap within 1 LSB after RGB8.
"""

import struct

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from voxel_tracer_tpu.models import camera as jcamera
from voxel_tracer_tpu.models import volume as jvolume
from voxel_tracer_tpu.models import vox as jvox
from voxel_tracer_tpu.ops import composite as jcomposite
from voxel_tracer_tpu.ops import tonemap as jtonemap
from voxel_tracer_tpu.ops.math3d import quat_from_axis_angle, quat_to_mat3
from voxel_tracer_tpu.ops.pallas import mega as jmega

from voxel_tracer_tpu_torch.convert import camera_from_jax, volume_from_jax
from voxel_tracer_tpu_torch.models import camera as tcamera
from voxel_tracer_tpu_torch.models import volume as tvolume
from voxel_tracer_tpu_torch.models import vox as tvox
from voxel_tracer_tpu_torch.ops import composite as tcomposite
from voxel_tracer_tpu_torch.ops import math3d as tmath3d
from voxel_tracer_tpu_torch.ops import tonemap as ttonemap
from voxel_tracer_tpu_torch.ops.cuda import mega as tmega

torch.set_num_threads(1)

ATOL = 1e-6
SUN = np.array([-0.619501, 0.465931, -0.631765], np.float32)


def _rgb8(v):
    return np.clip(np.asarray(v, np.float32) * 255.0 + 0.5, 0, 255).astype(np.int64)


@pytest.mark.parametrize("pos,target,aspect", [
    ((1.2, 0.9, -1.4), (0.1, -0.05, 0.2), 2.0),
    ((2.0, 1.4, -2.4), (0.0, 0.0, 0.0), 1920 / 1088),
    ((-3.0, 0.2, 0.5), (0.4, 0.1, -0.3), 1.0),
])
def test_camera_and_rays(pos, target, aspect):
    jc = jcamera.Camera.create(pos, target, aspect)
    tc = tcamera.Camera.create(pos, target, aspect)
    for name in jc._fields:
        np.testing.assert_allclose(getattr(tc, name).numpy(),
                                   np.asarray(getattr(jc, name)), atol=ATOL,
                                   err_msg=name)
    w, h = 24, 16
    jitter = np.random.RandomState(5).rand(h, w, 2).astype(np.float32)
    for jit in (None, jitter):
        jo, jd = jcamera.rays_for_image(
            jc, w, h, None if jit is None else jnp.asarray(jit))
        to, td = tcamera.rays_for_image(tc, w, h, jit, device="cpu")
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=ATOL)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=ATOL)
    xs = np.random.RandomState(6).rand(50).astype(np.float32) * w
    ys = np.random.RandomState(7).rand(50).astype(np.float32) * h
    jo, jd = jcamera.primary_rays(jc, jnp.asarray(xs), jnp.asarray(ys), w, h)
    to, td = tcamera.primary_rays(tc, torch.from_numpy(xs),
                                  torch.from_numpy(ys), w, h)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=ATOL)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=ATOL)
    # converted camera carries the same fields
    for a, b in zip(camera_from_jax(jc), jc):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_noise_volume_and_brick_occ():
    jv = jvolume.VoxelVolume.noise_filled((32, 32, 32))
    tv = tvolume.VoxelVolume.noise_filled((32, 32, 32))
    np.testing.assert_array_equal(tv.grid, jv.grid)
    np.testing.assert_array_equal(tv.brick_occ, jv.brick_occ)
    assert tv.grid.any() and not tv.grid.all()
    g = np.random.RandomState(2).randint(0, 3, (21, 13, 17)).astype(np.uint8)
    np.testing.assert_array_equal(tvolume.compute_brick_occ(g),
                                  jvolume.compute_brick_occ(g))
    # edits keep the counts in step (set_voxel, vv.cpp:377-432)
    rng = np.random.RandomState(11)
    for x, y, z, v in zip(rng.randint(0, 32, 20), rng.randint(0, 32, 20),
                          rng.randint(0, 32, 20), rng.randint(0, 3, 20)):
        jv.set_voxel(int(x), int(y), int(z), int(v))
        tv.set_voxel(int(x), int(y), int(z), int(v))
    np.testing.assert_array_equal(tv.grid, jv.grid)
    np.testing.assert_array_equal(tv.brick_occ, jv.brick_occ)
    np.testing.assert_array_equal(tv.brick_occ, tvolume.compute_brick_occ(tv.grid))
    with pytest.raises(IndexError):
        tv.set_voxel(32, 0, 0, 1)


def test_volume_from_jax():
    rot = np.asarray(quat_to_mat3(quat_from_axis_angle((0, 1, 0), 0.7)))
    g = np.random.RandomState(4).randint(0, 5, (20, 12, 9)).astype(np.uint8)
    pal = np.random.RandomState(3).rand(256, 3).astype(np.float32)
    jv = jvolume.VoxelVolume(g, pal, pos=(0.1, -0.2, 0.3), rot=rot, vpu=16.0)
    tv = volume_from_jax(jv)
    for name in ("grid", "palette", "pos", "rot", "pivot", "size",
                 "brick_occ"):
        np.testing.assert_array_equal(getattr(tv, name), getattr(jv, name),
                                      err_msg=name)
    assert tv.vpu == jv.vpu and tv.grid_size == jv.grid_size


def _vox_bytes(size, voxels, rgba=None):
    def chunk(cid, content, children=b""):
        return cid + struct.pack("<ii", len(content), len(children)) + content + children

    body = chunk(b"SIZE", struct.pack("<iii", *size))
    body += chunk(b"XYZI", struct.pack("<i", len(voxels))
                  + np.asarray(voxels, np.uint8).tobytes())
    if rgba is not None:
        body += chunk(b"RGBA", rgba.tobytes())
    return b"VOX " + struct.pack("<i", 150) + chunk(b"MAIN", b"", body)


@pytest.mark.parametrize("with_palette", [False, True])
def test_parse_vox(with_palette, tmp_path):
    rng = np.random.RandomState(9)
    size = (5, 7, 3)
    xyz = np.stack([rng.randint(0, s, 30) for s in size], axis=1)
    voxels = np.concatenate([xyz, rng.randint(1, 256, (30, 1))], axis=1)
    rgba = rng.randint(0, 256, (256, 4)).astype(np.uint8) if with_palette else None
    data = _vox_bytes(size, voxels, rgba)
    (jm,) = jvox.parse_vox(data)
    (tm,) = tvox.parse_vox(data)
    np.testing.assert_array_equal(tm.grid, jm.grid)
    np.testing.assert_array_equal(tm.palette, jm.palette)
    np.testing.assert_array_equal(tm.palette_f32, jm.palette_f32)
    assert tm.size == jm.size == (size[1], size[2], size[0])
    np.testing.assert_array_equal(tvox._default_palette(), jvox._default_palette())
    path = tmp_path / "model.vox"
    path.write_bytes(data)
    tv = tvolume.VoxelVolume.from_vox(str(path), pos=(0.1, 0.2, 0.3), vpu=16.0)
    jv = jvolume.VoxelVolume.from_vox(str(path), pos=(0.1, 0.2, 0.3), vpu=16.0)
    for name in ("grid", "palette", "pos", "size", "pivot", "brick_occ"):
        np.testing.assert_array_equal(getattr(tv, name), getattr(jv, name),
                                      err_msg=name)
    with pytest.raises(ValueError):
        tvox.parse_vox(b"NOPE" + data[4:])


def test_math_tonemap_and_local_transform():
    rng = np.random.RandomState(8)
    v = rng.randn(64, 3).astype(np.float32)
    v[:4] = [[0.0, -0.0, 1.0], [-0.0, 0.0, -1.0], [0.5, -0.0, 0.0], [-2.0, 0.0, 3.0]]
    np.testing.assert_array_equal(tmath3d.sign_dir(torch.from_numpy(v)).numpy(),
                                  np.where(np.signbit(v), -1.0, 1.0))
    assert tmath3d.sign_dir(torch.tensor([-0.0])).item() == -1.0
    np.testing.assert_allclose(tmath3d.normalize(torch.from_numpy(v)).numpy(),
                               v / np.linalg.norm(v, axis=-1, keepdims=True),
                               atol=ATOL)
    x = (rng.rand(4096, 3) * 3.0).astype(np.float32)
    np.testing.assert_allclose(ttonemap.aces_approx(torch.from_numpy(x)).numpy(),
                               np.asarray(jtonemap.aces_approx(jnp.asarray(x))),
                               atol=ATOL)
    y = rng.rand(4096, 3).astype(np.float32)
    assert np.abs(ttonemap.to_rgb8(torch.from_numpy(y)).numpy().astype(int)
                  - np.asarray(jtonemap.to_rgb8(jnp.asarray(y))).astype(int)).max() <= 1
    rot = np.array(quat_to_mat3(quat_from_axis_angle((0.3, 1, 0.2), 0.9)))
    pos = np.array([0.1, -0.2, 0.3], np.float32)
    piv = np.array([0.5, 0.4, 0.6], np.float32)
    o, d = rng.randn(32, 3).astype(np.float32), rng.randn(32, 3).astype(np.float32)
    jo, jd = jcomposite._to_local(jnp.asarray(rot), jnp.asarray(pos),
                                  jnp.asarray(piv), jnp.asarray(o), jnp.asarray(d))
    to, td = tcomposite._to_local(*(torch.from_numpy(a) for a in (rot, pos, piv, o, d)))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=ATOL)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=ATOL)


def test_camera_params_and_mega_camera():
    rot = np.asarray(quat_to_mat3(quat_from_axis_angle((0, 1, 0), 0.4)))
    g = np.random.RandomState(1).randint(0, 2, (16, 16, 16)).astype(np.uint8)
    jv = jvolume.VoxelVolume(g, pos=(0.1, -0.05, 0.2), rot=rot, vpu=20.0)
    jc = jcamera.Camera.create((1.2, 0.9, -1.4), (0.1, -0.05, 0.2), 2.0)
    ref = np.asarray(jmega.mega_camera(jmega.MegaVolume(jv), jc, jnp.asarray(SUN),
                                       64, 32, 0.7, (0.1, 0.2, 0.3)))
    out = tmega.mega_camera(tmega.MegaVolume(volume_from_jax(jv), device="cpu"),
                            camera_from_jax(jc), SUN, 64, 32, 0.7,
                            (0.1, 0.2, 0.3))
    assert out.shape == (29,) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)
    cl = [np.asarray(jnp.asarray(v)) for v in (jc.pos, jc.tl, jc.tr, jc.bl)]
    np.testing.assert_allclose(
        tmega.camera_params(cl, rot, SUN, 1.0, (0, 0, 0), 40, 24).numpy(),
        np.asarray(jmega.camera_params(tuple(jnp.asarray(c) for c in cl),
                                       jnp.asarray(rot), SUN, 1.0, (0, 0, 0),
                                       40, 24)), atol=ATOL)


def test_analytic_sky_and_aces_rgb8():
    rng = np.random.RandomState(12)
    d = rng.randn(8192, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    sun = SUN / np.linalg.norm(SUN)
    d[:16] = sun + rng.randn(16, 3).astype(np.float32) * 1e-3  # the sun disk
    d[:16] /= np.linalg.norm(d[:16], axis=1, keepdims=True)
    ref = np.stack([np.asarray(c) for c in jmega._analytic_sky(
        tuple(jnp.asarray(d[:, i]) for i in range(3)), tuple(sun))], -1)
    out = torch.stack(tmega._analytic_sky(
        torch.from_numpy(d).unbind(-1), tuple(float(s) for s in sun)), -1).numpy()
    assert np.abs(_rgb8(out) - _rgb8(ref)).max() <= 1
    aref = np.asarray(jmega._aces(jnp.asarray(ref)))
    aout = tmega._aces(torch.from_numpy(out)).numpy()
    assert np.abs(_rgb8(aout) - _rgb8(aref)).max() <= 1


def test_packed_tables_decode_to_grid():
    """The kernel's tables hold exactly the grid (layout of pack_mega)."""
    g = np.random.RandomState(13).randint(0, 4, (21, 13, 17)).astype(np.uint8)
    g[g == 1] = 200
    tb = tmega.pack_tables(g, np.ones((256, 3), np.float32), 20.0, device="cpu")
    bx, by, bz = tb.bsize
    assert (bx, by, bz) == (3, 2, 3) and tb.gsize == (17, 13, 21)
    pad = np.zeros((bz * 8, by * 8, bx * 8), np.uint8)
    pad[:21, :13, :17] = g
    matb = tb.matb.numpy().reshape(bz, by, bx, 8, 8, 8)
    np.testing.assert_array_equal(matb.transpose(0, 3, 1, 4, 2, 5).reshape(pad.shape), pad)
    bits = np.unpackbits(tb.occw.numpy().view(np.uint8), axis=1, bitorder="little")
    np.testing.assert_array_equal(bits.astype(bool), tb.matb.numpy() != 0)
    np.testing.assert_array_equal(tb.bocc.numpy(),
                                  (tvolume.compute_brick_occ(g) > 0).reshape(-1))
    np.testing.assert_array_equal(tb.brick_occ.numpy(), tvolume.compute_brick_occ(g))
    np.testing.assert_array_equal(tb.grid.numpy(), g)
    # the JAX packer's 8^3 material table holds the same bytes
    jt = jmega.pack_mega(g, 20.0)
    np.testing.assert_array_equal(
        np.asarray(jt.matw).view(np.uint8).reshape(-1, 512), tb.matb.numpy())
