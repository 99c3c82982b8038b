"""Parity: the port's `ops/diff.render_density` (wavefront march with a
replay backward) vs `voxel_tracer_tpu.ops.diff.render_density` on CPU.

Inputs from numpy seeds: the 16^3 field and the fan of
`tests/test_diffint.py:14-35`.  Tolerances: color, trans and depth within
atol 1e-5; the grads of the loss of `tests/test_diffint.py:75-79` within
1e-4 x max|g| (float32 sums taken in other orders; XLA's exp and
PyTorch's differ in the last bit).
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from voxel_tracer_tpu.ops import diff as jdiff

from voxel_tracer_tpu_torch.ops import diff as tdiff

torch.set_num_threads(1)


def _fan_rays(n_side):
    yy, zz = np.meshgrid(np.linspace(0.2, 1.4, n_side),
                         np.linspace(0.2, 1.4, n_side))
    tgt = np.stack([np.full(yy.size, 1.6), yy.ravel(), zz.ravel()], -1)
    o = np.tile(np.array([-0.9, 0.8, 0.8]), (tgt.shape[0], 1))
    d = tgt - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _scene():
    rng = np.random.default_rng(0)
    sigma = rng.uniform(0, 8.0, (16, 16, 16)).astype(np.float32)
    albedo = rng.uniform(0, 1, (16, 16, 16, 3)).astype(np.float32)
    o, d = _fan_rays(16)
    # plus axis-parallel rays with +-0 components and two misses
    o = np.concatenate([o, [[0.55, 0.85, -0.5], [-0.5, 0.3, 0.7],
                            [3.0, 3.0, 3.0], [-1.0, -1.0, -1.0]]]).astype(np.float32)
    d = np.concatenate([d, [[-0.0, 0.0, 1.0], [1.0, -0.0, 0.0],
                            [1.0, 0.0, 0.0], [0.0, 0.0, -1.0]]]).astype(np.float32)
    target = np.random.default_rng(1).uniform(0, 1, (o.shape[0], 3)).astype(np.float32)
    return sigma, albedo, o, d, target


def test_forward_matches_jax():
    sigma, albedo, o, d, _ = _scene()
    ref = jdiff.render_density(jnp.asarray(sigma), jnp.asarray(albedo),
                               jnp.asarray(o), jnp.asarray(d), 10.0, 192)
    out = tdiff.render_density(*(torch.from_numpy(a) for a in (sigma, albedo, o, d)),
                               10.0, 192)
    for k in ("color", "trans", "depth"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   atol=1e-5, rtol=0, err_msg=k)
    assert float(out["trans"][-1]) == 1.0 and float(out["color"][-1].abs().sum()) == 0.0


def test_grads_match_jax():
    sigma, albedo, o, d, target = _scene()

    def jloss(s, a):
        out = jdiff.render_density(s, a, jnp.asarray(o), jnp.asarray(d), 10.0, 192)
        return (jnp.mean((out["color"] - target) ** 2)
                + 0.1 * jnp.mean(out["trans"]) + 0.01 * jnp.mean(out["depth"]))

    gr = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(sigma), jnp.asarray(albedo))
    s = torch.tensor(sigma, requires_grad=True)
    a = torch.tensor(albedo, requires_grad=True)
    out = tdiff.render_density(s, a, torch.from_numpy(o), torch.from_numpy(d),
                               10.0, 192)
    loss = (((out["color"] - torch.from_numpy(target)) ** 2).mean()
            + 0.1 * out["trans"].mean() + 0.01 * out["depth"].mean())
    loss.backward()
    for mine, ref in zip((s.grad, a.grad), gr):
        ref = np.asarray(ref)
        assert np.abs(mine.numpy() - ref).max() <= 1e-4 * np.abs(ref).max()


def test_transmittance_matches_integral():
    """A single fully dense column: T = exp(-sigma * path length)
    (tests/test_diff.py:29-40)."""
    sigma = torch.full((8, 8, 8), 2.0)
    albedo = torch.ones((8, 8, 8, 3))
    out = tdiff.render_density(sigma, albedo, torch.tensor([[0.5, 0.5, -1.0]]),
                               torch.tensor([[0.0, 0.0, 1.0]]), 8.0, 64)
    np.testing.assert_allclose(float(out["trans"][0]), np.exp(-2.0), rtol=1e-4)
