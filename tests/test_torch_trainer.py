"""Parity: the port's trainer vs `voxel_tracer_tpu.trainer` on CPU.

The wavefront backend takes the same batches as the JAX trainer's
``"xla"`` backend (same host sampler, `np.random.RandomState(0)`) from the
target views of `tests/test_trainer.py`.  The JAX trainer runs on the
8-device virtual mesh of `tests/conftest.py` (per-shard losses and
gradients averaged), the port on one device, so sums are taken in other
orders, and XLA's exp and PyTorch's differ in the last bit.  Tolerances:
losses within rtol 1e-4, sigma and albedo within atol 1e-5, at Adam lr
1e-2, the rate of the 128^3 benchmark configuration (`bench_suite.py`
`inverse_128_32views`).  Adam's step lr * g / (|g| + 1e-8) turns a
last-bit difference in the gradient of a voxel with |g| near 1e-8 into a
difference proportional to lr: at lr 0.25 the JAX trainer's own jitted
and eager gradients give steps up to 4e-5 apart.  The JAX ``"pallas"``
backend compiles for the TPU only (`interpret=False`), so the kernel
backend is held to the JAX package at the function level
(`tests/test_torch_diffint.py`) and here only to convergence: its loss
halves within 40 steps.
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from voxel_tracer_tpu.models.camera import Camera as JCamera
from voxel_tracer_tpu.models.camera import rays_for_image as j_rays_for_image
from voxel_tracer_tpu.ops import diff as jdiff
from voxel_tracer_tpu.trainer import TrainConfig as JTrainConfig
from voxel_tracer_tpu.trainer import Trainer as JTrainer

from voxel_tracer_tpu_torch.convert import adam_state_from_jax, params_from_jax
from voxel_tracer_tpu_torch.models.camera import Camera
from voxel_tracer_tpu_torch.ops import diff as tdiff
from voxel_tracer_tpu_torch.trainer import (TrainConfig, Trainer, init_params,
                                            make_dataset)
from voxel_tracer_tpu_torch.utils.checkpoint import load_camera, save_camera

torch.set_num_threads(1)

LOSS_RTOL = 1e-4
PARAM_ATOL = 1e-5


def _target_views(grid_n=12, n_views=6, img=24, vpu=12.0):
    """tests/test_trainer.py:13-31."""
    z, y, x = np.meshgrid(*[np.arange(grid_n)] * 3, indexing="ij")
    c = (grid_n - 1) / 2
    r = np.sqrt((x - c) ** 2 + (y - c) ** 2 + (z - c) ** 2)
    sigma = jnp.asarray(np.where(r < grid_n * 0.33, 10.0, 0.0), jnp.float32)
    albedo = jnp.asarray(
        np.stack([x / grid_n, y / grid_n, z / grid_n], -1), jnp.float32)
    pivot = np.full(3, grid_n / (2 * vpu), np.float32)
    O, D, C = [], [], []
    for vi in range(n_views):
        a = 2 * np.pi * vi / n_views
        cam = JCamera.create(
            (1.5 * np.cos(a), 0.4, 1.5 * np.sin(a)), (0, 0, 0), 1.0)
        o, d = j_rays_for_image(cam, img, img)
        out = jdiff.render_density(sigma, albedo, o + pivot, d, vpu, 40)
        O.append(np.asarray(o) + pivot)
        D.append(np.asarray(d))
        C.append(np.asarray(out["color"]))
    return (np.concatenate(O), np.concatenate(D), np.concatenate(C))


@pytest.fixture(scope="module")
def views():
    return _target_views()


def _configs(steps):
    kw = dict(grid_size=(12, 12, 12), vpu=12.0, lr=1e-2, steps=steps,
              rays_per_batch=1024, march_steps=40)
    return JTrainConfig(backend="xla", **kw), TrainConfig(backend="wavefront",
                                                          **kw)


def _assert_params_close(jparams, tparams):
    for k in ("sigma", "albedo"):
        np.testing.assert_allclose(tparams[k].detach().numpy(),
                                   np.asarray(jparams[k]), atol=PARAM_ATOL,
                                   rtol=0, err_msg=k)


def test_wavefront_trainer_matches_jax(views):
    o, d, c = views
    jcfg, tcfg = _configs(5)
    jt = JTrainer(jcfg)
    jl = jt.fit(o, d, c, log_every=1, log_fn=lambda s: None)
    tt = Trainer(tcfg, device="cpu")
    tl = tt.fit(o, d, c, log_every=1, log_fn=lambda s: None)
    assert len(tl) == len(jl) == 5 and tt.step == 5
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    assert tl[-1] < tl[0]
    _assert_params_close(jt.params, tt.params)


def test_resume_from_jax_state(views):
    """JAX takes 3 steps; its parameters and Adam moments move into the
    port, which takes 2 more; the JAX trainer takes the same 2 (its `fit`
    restarts the sampler, as after a restore) and the two agree."""
    o, d, c = views
    jcfg, tcfg = _configs(3)
    jt = JTrainer(jcfg)
    jt.fit(o, d, c, log_every=1, log_fn=lambda s: None)
    tt = Trainer(tcfg, device="cpu")
    tt.load_state(jt.step, {
        "params": params_from_jax(jt.params, device="cpu"),
        "opt_state": adam_state_from_jax(jt.opt_state, tt.params)})
    st = tt.optimizer.state[tt.params["sigma"]]
    assert float(st["step"]) == 3.0
    np.testing.assert_array_equal(st["exp_avg"].numpy(),
                                  np.asarray(jt.opt_state[0].mu["sigma"]))
    jt.cfg.steps = tt.cfg.steps = 5
    jl = jt.fit(o, d, c, log_every=1, log_fn=lambda s: None)
    tl = tt.fit(o, d, c, log_every=1, log_fn=lambda s: None)
    assert tt.step == jt.step == 5 and len(tl) == len(jl) == 2
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
    _assert_params_close(jt.params, tt.params)


def test_kernel_backend_halves_the_loss():
    """backend="kernel" on a 16^3 grid (the integrate kernels' plain
    versions on CPU tensors), tile-ordered views, 40 steps."""
    g, vpu, img = 16, 16.0, 32
    z, y, x = np.meshgrid(*[np.arange(g)] * 3, indexing="ij")
    r = np.sqrt(sum((a - (g - 1) / 2) ** 2 for a in (x, y, z)))
    sigma = torch.tensor(np.where(r < g * 0.35, 12.0, 0.0), dtype=torch.float32)
    albedo = torch.tensor(np.stack([x / g, y / g, 1.0 - z / g], -1),
                          dtype=torch.float32)
    cams = [Camera.create((1.5 * np.cos(a), 0.4, 1.5 * np.sin(a)), (0, 0, 0),
                          1.0) for a in np.arange(6) * (2 * np.pi / 6)]
    o, d, _ = make_dataset([(cam, np.zeros((img, img, 3))) for cam in cams],
                           img, img, vpu, (g, g, g), tile_order=True)
    c = tdiff.render_density(sigma, albedo, torch.from_numpy(o),
                             torch.from_numpy(d), vpu, 64)["color"].numpy()
    cfg = TrainConfig(grid_size=(g, g, g), vpu=vpu, lr=0.25, steps=40,
                      rays_per_batch=2048, backend="kernel")
    tr = Trainer(cfg, device="cpu")
    losses = tr.fit(o, d, c, log_every=10, log_fn=lambda s: None)
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert losses[-1] < 0.5 * losses[0], losses


@pytest.mark.parametrize("jax_name,port_name", [("xla", "wavefront"),
                                                ("pallas", "kernel")])
def test_jax_backend_names_train_like_the_port_names(views, jax_name, port_name):
    """A config carried over from the JAX package (backend "xla" or
    "pallas") trains exactly as the port's name for the same backend (the
    kernel backend on a 16^3 grid over the same [0, 1]^3: its bricks are
    whole)."""
    o, d, c = views
    losses, params = [], []
    for name in (jax_name, port_name):
        _, cfg = _configs(3)
        cfg.backend = name
        if port_name == "kernel":
            cfg.grid_size, cfg.vpu = (16, 16, 16), 16.0
        tr = Trainer(cfg, device="cpu")
        assert tr.cfg.backend == port_name
        losses.append(tr.fit(o, d, c, log_every=1, log_fn=lambda s: None))
        params.append(tr.params)
    assert len(losses[0]) == 3 and losses[0] == losses[1]
    for k in ("sigma", "albedo"):
        assert torch.equal(params[0][k], params[1][k]), k
    with pytest.raises(ValueError):
        Trainer(TrainConfig(backend="triton"), device="cpu")


def test_make_dataset_matches_jax():
    from voxel_tracer_tpu.trainer import make_dataset as j_make_dataset
    rng = np.random.RandomState(3)
    img = rng.rand(32, 64, 3).astype(np.float32)
    pos, tgt = (1.2, 0.5, -1.4), (0.0, 0.1, 0.0)
    for tile in (False, True):
        ref = j_make_dataset([(JCamera.create(pos, tgt, 2.0), img)], 64, 32,
                             16.0, (16, 16, 16), tile_order=tile)
        out = make_dataset([(Camera.create(pos, tgt, 2.0), img)], 64, 32,
                           16.0, (16, 16, 16), tile_order=tile)
        for a, b in zip(out, ref):
            np.testing.assert_allclose(a, np.asarray(b), atol=1e-6)


def test_checkpoint_round_trip(views, tmp_path):
    o, d, c = views
    _, cfg = _configs(4)
    cfg.checkpoint_dir = str(tmp_path / "ck")
    cfg.checkpoint_every = 2
    cfg.metrics_path = str(tmp_path / "m.jsonl")
    tr = Trainer(cfg, device="cpu")
    tr.fit(o, d, c, log_every=2, log_fn=lambda s: None)
    tr.metrics.close()
    names = sorted(p.name for p in (tmp_path / "ck").iterdir())
    assert names == ["ckpt_00000002.pkl", "ckpt_00000004.pkl"]
    recs = [json.loads(s) for s in open(cfg.metrics_path)]
    assert [r["step"] for r in recs] == [2, 4] and recs[0]["rays"] == 1024

    cfg2 = TrainConfig(**{**cfg.__dict__, "metrics_path": None})
    tr2 = Trainer(cfg2, device="cpu")
    assert tr2.maybe_restore() and tr2.step == 4
    for k in ("sigma", "albedo"):
        assert torch.equal(tr2.params[k], tr.params[k])
        s1 = tr.optimizer.state[tr.params[k]]
        s2 = tr2.optimizer.state[tr2.params[k]]
        assert float(s1["step"]) == float(s2["step"]) == 4.0
        assert torch.equal(s1["exp_avg"], s2["exp_avg"])
        assert torch.equal(s1["exp_avg_sq"], s2["exp_avg_sq"])
    # both take the same next step
    tr.cfg.steps = tr2.cfg.steps = 5
    tr.fit(o, d, c, log_fn=lambda s: None)
    tr2.fit(o, d, c, log_fn=lambda s: None)
    for k in ("sigma", "albedo"):
        assert torch.equal(tr2.params[k], tr.params[k])
    assert init_params(cfg, device="cpu")["sigma"].device.type == "cpu"
    cam = Camera.create((1.2, 0.5, -1.4), (0.0, 0.1, 0.0), 2.0)
    save_camera(str(tmp_path / "camera.npz"), cam)
    back = load_camera(str(tmp_path / "camera.npz"), 2.0)
    for a, b in zip(back, cam):
        assert torch.equal(a, b)
    assert load_camera(str(tmp_path / "missing.npz")) is None
