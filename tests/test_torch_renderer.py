"""Parity: the port's wavefront `Renderer` vs the JAX `Renderer`.

The material scene of tests/test_whitted_mega.py:25-43 (a 32^3 volume with
a diffuse floor, a hollow glass box around a diffuse pillar, a mirror
slab, a sphere light and a procedural sky), carried into the port with
`convert.scene_from_jax`, rendered at 64x48 by both packages' `Renderer`
on the CPU.  Tolerances:
- flat and lambert: color within 1e-5, depth within 5e-3 and material
  equal, primary hit counts within 4;
- full: the pinned colour budget of tests/test_whitted_mega.py:72-79, at
  most 130 of 3072 pixels over 5 % relative error and a mean relative
  error below 0.015 (stochastic shadows roll `hash_shadow` on the hit
  cell, and the JAX renderer's jitted glue is contracted into FMAs where
  the port's eager glue is not, so a one-ulp difference can flip a
  shadow), with the same depth, material and hit-count checks;
- the port with `compact=True` equals itself with `compact=False`, field
  for field: on the material frame, on its lower half as one block of
  rays with a ray offset (as `parallel.sharding.sharded_render` hands a
  shard to `render_rays`), and on the scene with its glass made diffuse,
  where the glass stage is skipped at every bounce.
"""

import dataclasses

import numpy as np
import pytest
import torch

from voxel_tracer_tpu.models.camera import Camera as JCamera
from voxel_tracer_tpu.models.scene import Scene as JScene
from voxel_tracer_tpu.models.skydome import SkyDome as JSky
from voxel_tracer_tpu.models.volume import VoxelVolume as JVolume
from voxel_tracer_tpu.renderer import RenderConfig as JConfig
from voxel_tracer_tpu.renderer import Renderer as JRenderer

from voxel_tracer_tpu_torch import RenderConfig, Renderer
from voxel_tracer_tpu_torch.convert import camera_from_jax, scene_from_jax
from voxel_tracer_tpu_torch.models.camera import rays_for_image
from voxel_tracer_tpu_torch.renderer import render_rays

torch.set_num_threads(1)

W, H = 64, 48
FRAME = 7
COLOR_MISMATCH_BUDGET = 130    # of W * H pixels over 5 % relative error
MEAN_REL_ERR = 0.015
DEPTH_ATOL = 5e-3
HIT_COUNT_BUDGET = 4


def material_scene(box_mat=3):
    """tests/test_whitted_mega.py's scene, as (JAX volume, JAX scene);
    ``box_mat`` is the hollow box's material (3: glass)."""
    n = 32
    g = np.zeros((n, n, n), np.uint8)
    g[:, 0:3, :] = 30                      # diffuse floor (z, y, x); y up
    g[10:24, 3:17, 4:16] = box_mat         # hollow glass box, walls 2 voxels
    g[12:22, 5:15, 6:14] = 0
    g[14:20, 3:11, 8:12] = 40              # diffuse pillar inside the glass
    g[:, 3:20, 26:28] = 12                 # mirror slab (row 1) at +x side
    pal = np.random.RandomState(7).rand(256, 3).astype(np.float32) * 0.8 + 0.1
    vol = JVolume(g, palette=pal, pos=(0.0, 0.0, 0.0), vpu=20.0)
    scene = JScene(volumes=[vol], skydome=JSky.procedural(32, 16))
    scene.add_light((0.5, 1.2, -0.6), 0.08, (1.0, 0.9, 0.8), 6.0)
    return vol, scene


def compare_frames(ref, out, exact):
    """ref: a JAX output dict, out: the port's; ``exact`` holds colour to
    1e-5, else to the pinned budget."""
    rc = np.asarray(ref["color"]).reshape(-1, 3)
    oc = out["color"].numpy().reshape(-1, 3)
    if exact:
        np.testing.assert_allclose(oc, rc, atol=1e-5, rtol=1e-5)
    else:
        rel = np.abs(rc - oc).max(axis=-1) / np.maximum(1.0, np.abs(rc).max(axis=-1))
        mism = int((rel > 0.05).sum())
        assert mism <= COLOR_MISMATCH_BUDGET, f"{mism} colour mismatches of {len(rc)}"
        assert float(rel.mean()) < MEAN_REL_ERR, f"mean relative error {rel.mean():.4f}"
    rt = np.asarray(ref["depth"]).reshape(-1)
    ot = out["depth"].numpy().reshape(-1)
    both = (rt < 1e30) & (ot < 1e30)
    assert both.sum() > 500
    assert np.abs(rt[both] - ot[both]).max() < DEPTH_ATOL
    assert abs(int((rt < 1e30).sum()) - int((ot < 1e30).sum())) <= HIT_COUNT_BUDGET
    rm = np.asarray(ref["material"]).reshape(-1)
    np.testing.assert_array_equal(out["material"].numpy().reshape(-1)[both], rm[both])
    assert out["image"].shape == (H, W, 3)
    assert bool(torch.isfinite(out["image"]).all())


@pytest.fixture(scope="module")
def setup():
    _vol, scene = material_scene()
    jsd = scene.data()
    jcam = JCamera.create((1.1, 0.9, -1.5), (0.0, 0.3, 0.0), W / H)
    return jsd, jcam, scene_from_jax(jsd, device="cpu"), camera_from_jax(jcam)


def _config(shading, cls, **kw):
    return cls(width=W, height=H, shading=shading, max_bounces=3,
               glass_reflections=2, **kw)


@pytest.fixture(scope="module")
def full_frames(setup):
    jsd, jcam, sd, cam = setup
    ref = JRenderer(_config("full", JConfig)).render(jsd, jcam, frame=FRAME)
    out = Renderer(_config("full", RenderConfig), device="cpu").render(sd, cam,
                                                                       frame=FRAME)
    return ref, out


@pytest.mark.parametrize("shading", ["flat", "lambert"])
def test_render_matches_jax(setup, shading):
    jsd, jcam, sd, cam = setup
    ref = JRenderer(_config(shading, JConfig)).render(jsd, jcam, frame=FRAME)
    out = Renderer(_config(shading, RenderConfig), device="cpu").render(sd, cam,
                                                                        frame=FRAME)
    compare_frames(ref, out, exact=True)


def test_render_full_matches_jax(full_frames):
    ref, out = full_frames
    compare_frames(ref, out, exact=False)
    mats = out["material"].numpy().reshape(-1)
    rows = set(np.floor((mats[mats > 0] - 1) / 8).astype(int))
    assert {0, 1} <= rows, f"glass and mirror not both visible: {rows}"
    assert set(out) >= {"image", "albedo", "irradiance", "color", "depth", "normal",
                        "steps", "material"}


@pytest.fixture(scope="module")
def no_glass_scene():
    """The material scene with its glass box made diffuse: no row hits
    glass at any bounce."""
    vol, scene = material_scene(box_mat=20)
    rows = (vol.grid[vol.grid > 0].astype(int) - 1) // 8
    assert not (rows == 0).any()
    return scene_from_jax(scene.data(), device="cpu")


@pytest.mark.parametrize("case", ["materials", "ray_block", "no_glass"])
def test_compact_equals_uncompacted(setup, full_frames, no_glass_scene, case):
    _jsd, _jcam, sd, cam = setup
    if case == "no_glass":
        sd = no_glass_scene

    def render(compact):
        cfg = _config("full", RenderConfig, compact=compact)
        if case != "ray_block":
            return Renderer(cfg, device="cpu").render(sd, cam, frame=FRAME)
        # the frame's lower half, as a ray shard of `sharded_render`
        rows = H // 2
        offset = rows * W
        o, d = rays_for_image(cam, W, H, device="cpu")
        return render_rays(sd, o[offset:], d[offset:], FRAME,
                           config=dataclasses.replace(cfg, height=rows),
                           ray_offset=offset)

    out = full_frames[1] if case == "materials" else render(False)
    comp = render(True)
    assert comp.keys() == out.keys()
    for k in out:
        assert torch.equal(comp[k], out[k]), k


def test_accumulated_frames_carry_accu(setup):
    """Three frames with temporal reprojection: the renderer carries the
    accumulator and the view pyramid, the frame counter advances, and a
    still camera keeps the history (renderer.cpp:273-329)."""
    _jsd, _jcam, sd, cam = setup
    cfg = RenderConfig(width=32, height=24, shading="full", max_bounces=2,
                       glass_reflections=1, accumulate=True)
    r = Renderer(cfg, device="cpu")
    cam = r.camera((1.1, 0.9, -1.5), (0.0, 0.3, 0.0))
    outs = [r.render(sd, cam) for _ in range(3)]
    assert r.frame == 3
    for out in outs:
        assert out["accu"].shape == (24, 32, 4)
        assert bool(torch.isfinite(out["image"]).all())
    hit = outs[0]["depth"] < 1e30
    assert bool(torch.equal(outs[2]["accu"][..., 3], outs[2]["depth"]))
    # frame 0 took no history; later frames blend it on hit pixels
    assert bool(torch.equal(outs[0]["accu"][..., :3], outs[0]["irradiance"]))
    # frame 1 blended toward frame 0: closer to it than frame 1 alone
    raw1 = Renderer(dataclasses.replace(cfg, accumulate=False),
                    device="cpu").render(sd, cam, frame=1)["irradiance"]
    d_acc = (outs[1]["irradiance"] - outs[0]["irradiance"]).abs()[hit].mean()
    d_raw = (raw1 - outs[0]["irradiance"]).abs()[hit].mean()
    assert float(d_acc) < 0.8 * float(d_raw), (float(d_acc), float(d_raw))
    r.reset_history()
    assert r._accu is None and r._prev_planes is None
    r.frame = 119
    r.render(sd, cam)
    assert r.frame == 0                  # the counter wraps at 120
