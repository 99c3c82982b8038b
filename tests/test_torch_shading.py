"""Parity: the port's shading terms and temporal reprojection vs JAX.

Same numpy-seeded inputs through `voxel_tracer_tpu_torch.ops.shading` /
`ops.reproject` and their JAX counterparts, on a small scene of a floor,
a glass box with a pillar inside and a mirror slab, with a sphere light
and a procedural sky.  Tolerance 1e-5 absolute on every returned value
(the light terms' shadow rays are traced by both packages' DDAs on
identical rays, so their occlusion masks are equal).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from voxel_tracer_tpu.models.camera import Camera as JCamera
from voxel_tracer_tpu.models.scene import Scene as JScene
from voxel_tracer_tpu.models.skydome import SkyDome as JSky
from voxel_tracer_tpu.models.volume import VoxelVolume as JVolume
from voxel_tracer_tpu.ops import composite as jcomp
from voxel_tracer_tpu.ops import reproject as jreproject
from voxel_tracer_tpu.ops import shading as jshading

from voxel_tracer_tpu_torch.convert import scene_from_jax
from voxel_tracer_tpu_torch.ops import reproject, shading

torch.set_num_threads(1)

ATOL = 1e-5
N = 2048


def _unit(rng, n):
    v = rng.randn(n, 3).astype(np.float32)
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def scene_and_points():
    """The material scene and hit points/normals of rays into it."""
    n = 32
    g = np.zeros((n, n, n), np.uint8)
    g[:, 0:3, :] = 30
    g[10:24, 3:17, 4:16] = 3
    g[12:22, 5:15, 6:14] = 0
    g[14:20, 3:11, 8:12] = 40
    g[:, 3:20, 26:28] = 12
    pal = np.random.RandomState(7).rand(256, 3).astype(np.float32) * 0.8 + 0.1
    sc = JScene(volumes=[JVolume(g, palette=pal, vpu=20.0)],
                skydome=JSky.procedural(32, 16))
    sc.add_light((0.5, 1.2, -0.6), 0.08, (1.0, 0.9, 0.8), 6.0)
    sc.add_light((-0.3, 0.2, 0.3), 0.05, (0.4, 0.5, 1.0), 0.9)
    jsd = sc.data()
    rng = np.random.RandomState(1)
    o = np.broadcast_to(np.float32([1.1, 0.9, -1.5]), (N, 3)).copy()
    tgt = rng.uniform(-0.8, 0.8, (N, 3)).astype(np.float32)
    d = tgt - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    hit = jcomp.intersect_scene(jsd, jnp.asarray(o), jnp.asarray(d))
    p = np.asarray(jshading.hit_point(jnp.asarray(o), jnp.asarray(d), hit.t, hit.normal))
    nrm = np.asarray(hit.normal)
    ok = np.asarray(hit.t) < 1e30
    assert ok.mean() > 0.5
    return jsd, scene_from_jax(jsd, device="cpu"), p[ok], nrm[ok]


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_fresnel_and_refract():
    rng = np.random.RandomState(2)
    n, i = _unit(rng, N), _unit(rng, N)
    i = np.where((np.sum(n * i, 1) > 0)[:, None], -i, i).astype(np.float32)
    for n1, n2 in ((1.0, 1.5), (1.5, 1.0), (1.0, 1.0)):
        ref = np.asarray(jshading.fresnel_reflect_prob(n1, n2, jnp.asarray(n),
                                                       jnp.asarray(i)))
        out = shading.fresnel_reflect_prob(n1, n2, _t(n), _t(i)).numpy()
        np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
    # the glass loop's argument order (direction first, normal second)
    ref = np.asarray(jshading.fresnel_reflect_prob(1.5, 1.0, jnp.asarray(i), jnp.asarray(n)))
    out = shading.fresnel_reflect_prob(1.5, 1.0, _t(i), _t(n)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
    assert (out == 1.0).any() and (out < 1.0).any()            # TIR and not
    for eta in (1.0 / 1.5, 1.5):
        ref = np.asarray(jshading.refract(jnp.asarray(n), jnp.asarray(i), eta))
        out = shading.refract(_t(n), _t(i), eta).numpy()
        np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
    assert (np.abs(out).sum(1) == 0).any()                      # TIR rows are 0


def test_cos_diffuse_reflect_and_material_row():
    rng = np.random.RandomState(3)
    n = _unit(rng, N)
    n[:64] = np.eye(3, dtype=np.float32)[rng.randint(0, 3, 64)]   # axis normals
    r1, r2 = rng.rand(N).astype(np.float32), rng.rand(N).astype(np.float32)
    ref = np.asarray(jshading.cos_diffuse_reflect(jnp.asarray(n), jnp.asarray(r1),
                                                  jnp.asarray(r2)))
    out = shading.cos_diffuse_reflect(_t(n), _t(r1), _t(r2)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
    assert (np.sum(out * n, 1) >= -1e-6).all()
    mats = np.arange(0, 256, dtype=np.int32)
    np.testing.assert_array_equal(shading.material_row(_t(mats)).numpy(),
                                  np.asarray(jshading.material_row(jnp.asarray(mats))))


def test_sun_light(scene_and_points):
    jsd, sd, p, nrm = scene_and_points
    rng = np.random.RandomState(4)
    jit3 = rng.rand(p.shape[0], 3).astype(np.float32)
    seed = rng.randint(0, 2 ** 32, p.shape[0], dtype=np.uint64)
    for jitter, sseed in ((None, None), (jit3, seed)):
        ref = np.asarray(jshading.sun_light(
            jsd, jnp.asarray(p), jnp.asarray(nrm),
            None if jitter is None else jnp.asarray(jitter),
            shadow_seed=None if sseed is None else jnp.asarray(sseed.astype(np.uint32))))
        out = shading.sun_light(
            sd, _t(p), _t(nrm), None if jitter is None else _t(jitter),
            shadow_seed=None if sseed is None else _t(sseed.astype(np.int64))).numpy()
        np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
        lit = out[:, 0] > 0
        assert 0 < lit.sum() < lit.size


def test_ambient_light(scene_and_points):
    jsd, sd, p, nrm = scene_and_points
    rng = np.random.RandomState(5)
    r2 = rng.rand(p.shape[0], 2).astype(np.float32)
    seed = rng.randint(0, 2 ** 32, p.shape[0], dtype=np.uint64)
    ref = np.asarray(jshading.ambient_light(jsd, jnp.asarray(p), jnp.asarray(nrm),
                                            jnp.asarray(r2),
                                            shadow_seed=jnp.asarray(seed.astype(np.uint32))))
    out = shading.ambient_light(sd, _t(p), _t(nrm), _t(r2),
                                shadow_seed=_t(seed.astype(np.int64))).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=1e-6)
    occluded = out.sum(1) == 0
    assert 0 < occluded.sum() < occluded.size


def test_sphere_lights(scene_and_points):
    jsd, sd, p, nrm = scene_and_points
    rng = np.random.RandomState(6)
    s3 = rng.rand(p.shape[0], 3).astype(np.float32)
    seed = rng.randint(0, 2 ** 32, p.shape[0], dtype=np.uint64)
    live = rng.rand(p.shape[0]) < 0.8
    for lv in (None, live):
        ref = np.asarray(jshading.sphere_lights(
            jsd, jnp.asarray(p), jnp.asarray(nrm), jnp.asarray(s3),
            shadow_seed=jnp.asarray(seed.astype(np.uint32)),
            live=None if lv is None else jnp.asarray(lv)))
        out = shading.sphere_lights(
            sd, _t(p), _t(nrm), _t(s3), shadow_seed=_t(seed.astype(np.int64)),
            live=None if lv is None else _t(lv)).numpy()
        np.testing.assert_allclose(out, ref, atol=ATOL, rtol=1e-6)
        assert (out.sum(1) > 0).sum() > 10


def test_reproject_accumulate():
    rng = np.random.RandomState(8)
    w, h = 48, 32
    n = w * h
    prev = JCamera.create((0.05, 0.5, -3.02), (0.0, 0.0, 0.0), w / h)
    pts = np.stack([rng.uniform(-1.2, 1.2, n), rng.uniform(-0.7, 1.0, n),
                    rng.uniform(-1.0, 1.0, n)], axis=1).astype(np.float32)
    depth = np.linalg.norm(pts - np.float32([0.0, 0.5, -3.0]), axis=1).astype(np.float32)
    irr = rng.uniform(0, 2, (n, 3)).astype(np.float32)
    accu = rng.uniform(0, 2, (h, w, 4)).astype(np.float32)
    # history depths near the current ones, so both branches run
    accu[..., 3] = np.where(rng.rand(h, w) < 0.6,
                            depth.reshape(h, w) + rng.uniform(-0.05, 0.05, (h, w)),
                            accu[..., 3]).astype(np.float32)
    mask = rng.rand(n) < 0.9
    for delta in (0.0, 0.02):
        ref = jreproject.reproject_accumulate(
            jnp.asarray(irr), jnp.asarray(depth), jnp.asarray(pts), jnp.asarray(accu),
            prev.planes, w, h, depth_delta=delta, reproject_mask=jnp.asarray(mask))
        out = reproject.reproject_accumulate(
            _t(irr), _t(depth), _t(pts), _t(accu), _t(np.array(prev.planes)),
            w, h, depth_delta=delta, reproject_mask=_t(mask))
        for r, o in zip(ref, out):
            np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=ATOL, rtol=0)
        assert (out[0].numpy() != irr).any(axis=1).sum() > 50     # history taken


def test_reproject_full_frame_edges_match_jax():
    """A static camera at the bench frame's 1920x1088: reprojecting a
    frame onto itself moves only pixels next to an irradiance edge, and
    JAX moves them alike.  Where uv * W lands a few ulps below a pixel
    coordinate, the fractional-area weights leak a few 1e-4 onto the
    neighbours; where a tap's base + 1 rounds up across a power of two
    (x = 512, 1024), the whole sample lands one pixel over.  Pixels whose
    projected uv is bit-equal in both packages (JAX projects with a
    matmul, the port with a fixed-order sum) blend bit for bit; no pixel
    inside an evenly lit region moves by more than 1e-4 in either."""
    from voxel_tracer_tpu.models.camera import pyramid_project as jproject
    from voxel_tracer_tpu_torch.convert import camera_from_jax
    from voxel_tracer_tpu_torch.models.camera import primary_rays, pyramid_project
    w, h = 1920, 1088
    jc = JCamera.create((2.0, 1.4, -2.4), (0.0, 0.0, 0.0), w / h)
    cam = camera_from_jax(jc)
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32),
                            torch.arange(w, dtype=torch.float32), indexing="ij")
    o, d = (v.reshape(-1, 3) for v in primary_rays(cam, xs, ys, w, h))
    # a floor at y = 0 out to 6 units, in 0.2-unit cells of three irradiances
    t = -o[:, 1] / d[:, 1]
    hit = (d[:, 1] < 0) & (t < 6.0)
    depth = torch.where(hit, t, 1e30)
    p = o + d * torch.clamp(depth, max=1e30)[:, None]
    cell = (torch.floor(p[:, 0] / 0.2) + 2 * torch.floor(p[:, 2] / 0.2)).long() % 3
    irr = torch.tensor([[0.2] * 3, [0.77] * 3, [0.55] * 3])[cell]
    accu = torch.cat([irr, depth[:, None]], -1).reshape(h, w, 4)
    out, _ = reproject.reproject_accumulate(irr, depth, p, accu, cam.planes, w, h,
                                            reproject_mask=hit)
    ref, _ = jreproject.reproject_accumulate(
        jnp.asarray(irr.numpy()), jnp.asarray(depth.numpy()), jnp.asarray(p.numpy()),
        jnp.asarray(accu.numpy()), jc.planes, w, h, reproject_mask=jnp.asarray(hit.numpy()))
    out, ref, irr_n, hit_n = out.numpy(), np.asarray(ref), irr.numpy(), hit.numpy()

    same_uv = (np.asarray(jproject(jc.planes, jnp.asarray(p.numpy())))
               == pyramid_project(cam.planes, p).numpy()).all(-1) & hit_n
    assert same_uv.sum() > hit_n.sum() // 4
    np.testing.assert_array_equal(out[same_uv], ref[same_uv])

    hm, im = hit_n.reshape(h, w), irr_n.reshape(h, w, 3)
    flat = hm.copy()
    flat[0, :] = flat[-1, :] = flat[:, 0] = flat[:, -1] = False
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            flat &= (np.roll(hm, (dy, dx), (0, 1))
                     & (np.roll(im, (dy, dx), (0, 1)) == im).all(-1))
    flat = flat.reshape(-1)
    move_t, move_j = np.abs(out - irr_n).max(-1), np.abs(ref - irr_n).max(-1)
    assert move_t[flat].max() <= 1e-4 and move_j[flat].max() <= 1e-4
    moved_t, moved_j = (move_t > 1e-4) & hit_n, (move_j > 1e-4) & hit_n
    assert moved_j.sum() > 100                     # the reference's own edge moves
    np.testing.assert_array_equal(moved_t[same_uv], moved_j[same_uv])
    assert abs(int(moved_t.sum()) - int(moved_j.sum())) <= 0.05 * moved_j.sum()
    np.testing.assert_allclose(move_t[hit_n].max(), move_j[hit_n].max(), atol=1e-6)


def test_tonemaps():
    """The renderer's tonemappers and the ambient term's clamp."""
    from voxel_tracer_tpu.ops import tonemap as jtonemap
    from voxel_tracer_tpu_torch.ops import tonemap
    v = np.random.RandomState(9).uniform(0, 12, (N, 3)).astype(np.float32)
    for name in ("aces_approx", "reinhard", "uncharted2"):
        ref = np.asarray(getattr(jtonemap, name)(jnp.asarray(v)))
        out = getattr(tonemap, name)(_t(v)).numpy()
        np.testing.assert_allclose(out, ref, atol=ATOL, rtol=1e-6, err_msg=name)
    ref = np.asarray(jtonemap.clamp_color(jnp.asarray(v), 8.0))
    out = tonemap.clamp_color(_t(v), 8.0).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=1e-6)
    assert (np.linalg.norm(out, axis=1) <= 8.0 + 1e-4).all()
