"""Parity: the port's post-processing (denoise filters, FXAA), debug-draw
overlay and freecam against the JAX package's, on tests/test_post.py's
cases and on seed-made images.

Tolerances: the filters are the same separable convolutions, summed in
another order (depthwise `conv2d` against XLA's), so 1e-6; FXAA is the
same elementwise program, 1e-6; overlays rasterize the same projected
points, so their pixels are equal; freecam poses within 1e-6.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from voxel_tracer_tpu.models import camera as jcamera
from voxel_tracer_tpu.ops import denoise as jdenoise
from voxel_tracer_tpu.utils.debug_draw import DebugOverlay as JOverlay
from voxel_tracer_tpu_torch.models import camera as tcamera
from voxel_tracer_tpu_torch.ops import denoise
from voxel_tracer_tpu_torch.utils.debug_draw import DebugOverlay

FILTER_ATOL = 1e-6


def _img(seed, h=19, w=27, c=3):
    return np.random.RandomState(seed).rand(h, w, c).astype(np.float32)


@pytest.mark.parametrize("radius,passes", [(1, 1), (1, 2), (2, 3)])
def test_box_blur_matches_jax(radius, passes):
    img = _img(radius * 10 + passes)
    got = denoise.box_blur(img, radius=radius, passes=passes).numpy()
    ref = np.asarray(jdenoise.box_blur(img, radius=radius, passes=passes))
    np.testing.assert_allclose(got, ref, atol=FILTER_ATOL)


def test_box_blur_edge_replicated_reference():
    """test_post.py's scalar reference: a 3x3 mean with edge replication;
    constants pass through."""
    img = _img(42, 12, 20)
    pad = np.pad(img, ((1, 1), (1, 1), (0, 0)), mode="edge")
    ref = sum(pad[dy:dy + 12, dx:dx + 20] for dy in range(3) for dx in range(3)) / 9.0
    np.testing.assert_allclose(denoise.box_blur(img, 1, 1).numpy(), ref, atol=1e-5)
    flat = np.full((16, 24, 3), 0.37, np.float32)
    np.testing.assert_allclose(denoise.box_blur(flat).numpy(), flat, atol=1e-6)
    v1, v2 = (denoise.box_blur(img, passes=p).numpy().var() for p in (1, 2))
    assert v2 < v1 < img.var()


@pytest.mark.parametrize("sigma,radius", [(1.0, None), (1.5, 2), (0.7, 3)])
def test_gaussian_blur_matches_jax(sigma, radius):
    k = denoise.gaussian_kernel_1d(sigma, radius)
    np.testing.assert_array_equal(k, jdenoise.gaussian_kernel_1d(sigma, radius))
    assert abs(k.sum() - 1.0) < 1e-6 and k.argmax() == len(k) // 2
    img = _img(7, 32, 32)
    got = denoise.gaussian_blur(img, sigma=sigma, radius=radius).numpy()
    np.testing.assert_allclose(got, np.asarray(jdenoise.gaussian_blur(img, sigma, radius)),
                               atol=FILTER_ATOL)
    assert got.shape == img.shape and got.var() < img.var()


def test_fxaa_matches_jax():
    """A noisy image, an aliased diagonal edge and a flat image."""
    h = w = 32
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    edge = np.repeat(np.where((yy > xx)[..., None], 1.0, 0.0).astype(np.float32), 3, -1)
    for img in (_img(3, 24, 40), edge, np.full((16, 16, 3), 0.4, np.float32)):
        got = denoise.fxaa(img).numpy()
        np.testing.assert_allclose(got, np.asarray(jdenoise.fxaa(jnp.asarray(img))),
                                   atol=FILTER_ATOL)
    out = denoise.fxaa(edge).numpy()
    assert np.abs(out - edge)[np.abs(yy - xx) <= 1].max() > 0.05
    np.testing.assert_allclose(out[np.abs(yy - xx) > 3], edge[np.abs(yy - xx) > 3], atol=1e-6)


def _cams():
    return (tcamera.Camera.create((0.0, 0.0, -3.0), (0.0, 0.0, 0.0), 1.0),
            jcamera.Camera.create((0.0, 0.0, -3.0), (0.0, 0.0, 0.0), 1.0))


def test_debug_overlay_matches_jax():
    """Lines, normals, an AABB and an OBB drawn by both overlays give the
    same pixels; the projection of the centre is the image centre; a line
    behind the camera draws nothing; the composite touches only drawn
    pixels."""
    tc, jc = _cams()
    ovs = (DebugOverlay(64, 48), JOverlay(64, 48))
    rot = tcamera.m3.normalize(torch.tensor([0.3, 1.0, 0.2])).numpy()
    for ov, cam in zip(ovs, (tc, jc)):
        ov.draw_line(cam, (-0.5, 0.0, 0.0), (0.5, 0.2, 0.1))
        ov.draw_line(cam, (0.0, 0.0, -5.0), (0.2, 0.0, -6.0))
        ov.draw_normal(cam, (0.1, -0.1, 0.0), rot, scale=0.5)
        ov.draw_aabb(cam, (-0.5, -0.5, -0.5), (0.5, 0.5, 0.5))
        ov.draw_obb(cam, np.eye(3), (0.2, 0.1, 0.0), (0.25, 0.25, 0.25), (0.5, 0.5, 0.5))
    np.testing.assert_array_equal(ovs[0].surface.pixels, ovs[1].surface.pixels)
    assert ovs[0].surface.pixels.any()
    xy, ok = ovs[0]._project(tc, np.array([[0.0, 0.0, 0.0], [0.0, 0.0, -5.0]]))
    assert ok[0] and not ok[1]
    assert abs(xy[0, 0] - 32.0) < 1.5 and abs(xy[0, 1] - 24.0) < 1.5
    frame = np.full((48, 64, 3), 7, np.uint8)
    out = ovs[0].composite(frame)
    drawn = ovs[0].surface.pixels.any(axis=-1)
    assert (out[~drawn] == 7).all() and (out[drawn] != 7).any()
    np.testing.assert_array_equal(out, ovs[1].composite(frame))
    ovs[0].clear()
    assert not ovs[0].surface.pixels.any()


@pytest.mark.parametrize("boost", [False, True])
def test_freecam_update_matches_jax(boost):
    """A walk of freecam steps from seeded inputs: the pose, the view
    pyramid and the depth delta follow JAX's within 1e-6."""
    rng = np.random.RandomState(5 + boost)
    tc = tcamera.Camera.create((0.3, 1.0, -2.0), (0.0, 0.2, 0.0))
    jc = jcamera.Camera.create((0.3, 1.0, -2.0), (0.0, 0.2, 0.0))
    for _ in range(12):
        move = rng.randint(-1, 2, 3).astype(np.float32)
        look = (rng.randn(2) * 20).astype(np.float32)
        tc, td = tcamera.freecam_update(tc, move, look, 1 / 60, boost)
        jc, jd = jcamera.freecam_update(jc, jnp.asarray(move), jnp.asarray(look), 1 / 60, boost)
        assert abs(float(td) - float(jd)) < 1e-6
    for f in tc._fields:
        np.testing.assert_allclose(getattr(tc, f).numpy(), np.asarray(getattr(jc, f)),
                                   atol=1e-6, err_msg=f)
