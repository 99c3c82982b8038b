"""Parity: the port's `render_whitted_multi` (`ops/cuda/multi.py`, B2's
plain version on the CPU) against the JAX XLA wavefront `render_rays`, on
tests/test_multi.py's `_dyn_scene` at 64x48 (floor + a cube rotated 0.35
rad about y, a mirror core), compacted and not.

Tolerances (tests/test_multi.py:75-90): hit agreement > 0.99, depth
rtol 1e-3 / atol 2e-3 where both hit, at most 40 pixels over 5 %
relative colour error, mean relative error below 0.01.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from voxel_tracer_tpu.models.camera import rays_for_image as jrays_for_image
from voxel_tracer_tpu.renderer import RenderConfig as JConfig
from voxel_tracer_tpu.renderer import render_rays as jrender_rays

from voxel_tracer_tpu_torch.convert import camera_from_jax, scene_from_jax
from voxel_tracer_tpu_torch.ops.cuda import multi
from voxel_tracer_tpu_torch.renderer import RenderConfig

from test_torch_multi import H, W, _camera, _check_vs_jax, _dyn_scene, _multi

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def dyn():
    jvols, scene = _dyn_scene()
    jsd = scene.data()
    o, d = jrays_for_image(_camera(), W, H)
    config = JConfig(width=W, height=H, shading="full", max_bounces=2, glass_reflections=1)
    return dict(jvols=jvols, sd=scene_from_jax(jsd, device="cpu"),
                ref=jrender_rays(jsd, o, d, jnp.int32(5), config=config))


@pytest.mark.parametrize("compact", [True, False])
def test_render_whitted_multi_matches_jax(dyn, compact):
    cfg = RenderConfig(width=W, height=H, shading="full", max_bounces=2,
                       glass_reflections=1, compact=compact)
    out = multi.render_whitted_multi(_multi(dyn["jvols"], compact), dyn["sd"],
                                     camera_from_jax(_camera()), W, H, 5, config=cfg)
    _check_vs_jax(out["depth"], dyn["ref"]["depth"])
    ref_c = np.asarray(dyn["ref"]["color"]).reshape(-1, 3)
    out_c = out["color"].numpy().reshape(-1, 3)
    rel = np.abs(ref_c - out_c).max(-1) / np.maximum(1.0, np.abs(ref_c).max(-1))
    assert int((rel > 0.05).sum()) <= 40, f"{int((rel > 0.05).sum())} colour mismatches"
    assert float(rel.mean()) < 0.01
