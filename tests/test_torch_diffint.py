"""Parity: the port's integrate path (`ops/cuda/diffint.py`, plain versions
on CPU tensors) vs `voxel_tracer_tpu.ops.pallas.diffint` (interpret mode)
and `voxel_tracer_tpu.ops.diff`.

Inputs are made with numpy from seeds (the fields and the fan of
`tests/test_diffint.py`).  Tolerances, stated where used:
- packing, occupancy words and tile order: equal bit for bit;
- vs the Pallas kernel on the rays it does not flag as k-fighters: color
  and trans within rtol 2e-4 / atol 2e-4, masked-loss grads within rtol
  5e-3 / atol 5e-5 (its brick-clipped segments and the voxel march differ
  by rounding), grads into empty bricks exactly 0;
- vs `diff.render_density` on all rays (the port integrates the rays the
  Pallas kernel flags): forward within 5e-5, grads within 5e-3 x max|g|;
- `render_density_slabs` vs `render_density_mega`: forward within 5e-5,
  grads within 5e-3 x max|g|.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from voxel_tracer_tpu.ops import diff as jdiff
from voxel_tracer_tpu.ops.pallas import diffint as jdi

from voxel_tracer_tpu_torch.ops.cuda import diffint

torch.set_num_threads(1)


def _fan_rays(n_side):
    """tests/test_diffint.py:14-26: a fan from one origin, all four (du, dv)
    sign quadrants."""
    yy, zz = np.meshgrid(np.linspace(0.2, 1.4, n_side),
                         np.linspace(0.2, 1.4, n_side))
    tgt = np.stack([np.full(yy.size, 1.6), yy.ravel(), zz.ravel()], -1)
    o = np.tile(np.array([-0.9, 0.8, 0.8]), (tgt.shape[0], 1))
    d = tgt - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


@pytest.fixture(scope="module")
def field():
    """tests/test_diffint.py:29-35: dense random 16^3 field."""
    rng = np.random.default_rng(0)
    sigma = rng.uniform(0, 8.0, (16, 16, 16)).astype(np.float32)
    albedo = rng.uniform(0, 1, (16, 16, 16, 3)).astype(np.float32)
    return sigma, albedo


def _t(*arrays, grad=False):
    return [torch.tensor(a, requires_grad=grad) for a in arrays]


def _loss(out, target):
    """tests/test_diffint.py:75-79."""
    return ((out["color"] - target) ** 2).mean() + 0.1 * out["trans"].mean() \
        + 0.01 * out["depth"].mean()


def test_packing_matches_jax(field):
    sigma, _ = field
    sp = sigma.copy()
    sp[:8, :, 8:] = 0.0                      # two empty bricks of eight
    rows = diffint.pack_rows(torch.from_numpy(sp))
    np.testing.assert_array_equal(rows.numpy(),
                                  np.asarray(jdi.pack_rows(jnp.asarray(sp))))
    np.testing.assert_array_equal(diffint.unpack_rows(rows, sp.shape).numpy(), sp)
    occ = diffint.occ_words(rows)
    assert occ.dtype == torch.int32
    np.testing.assert_array_equal(occ.numpy(),
                                  np.asarray(jdi.occ_words(jdi.pack_rows(jnp.asarray(sp)))))
    # 40 bricks (two occupancy words), five of them empty
    g40 = np.random.RandomState(1).rand(8, 8, 8 * 40).astype(np.float32)
    g40.reshape(8, 8, 40, 8)[:, :, ::9] = 0.0
    rows40 = diffint.pack_rows(torch.from_numpy(g40))
    np.testing.assert_array_equal(
        diffint.occ_words(rows40).numpy(),
        np.asarray(jdi.occ_words(jdi.pack_rows(jnp.asarray(g40)))))
    x = np.arange(64 * 128 * 3, dtype=np.float32).reshape(64 * 128, 3)
    for arr in (x, torch.from_numpy(x)):
        t = diffint.tile_raster(arr, 64, 128)
        np.testing.assert_array_equal(np.asarray(t),
                                      np.asarray(jdi.tile_raster(jnp.asarray(x), 64, 128)))
        np.testing.assert_array_equal(np.asarray(diffint.untile_raster(t, 64, 128)), x)


@pytest.fixture(scope="module")
def blob():
    """tests/test_diffint.py:168-213: sparse 32^3 blob (empty and occupied
    bricks), a coherent +z bundle of 2048 rays and random targets, through
    the Pallas kernel in interpret mode (one forward and one backward) and
    through `diff.render_density`."""
    G = 32
    rng = np.random.RandomState(11)
    zz, yy, xx = np.meshgrid(*[np.linspace(0, 1, G)] * 3, indexing="ij")
    r2 = (xx - 0.5) ** 2 + (yy - 0.5) ** 2 + (zz - 0.5) ** 2
    blob = 30.0 * np.exp(-r2 * 60.0)
    sigma = np.where(blob > 0.05, rng.rand(G, G, G) * blob * 0.3,
                     0.0).astype(np.float32)
    albedo = rng.rand(G, G, G, 3).astype(np.float32)
    n = 2048
    o = np.stack([rng.rand(n), rng.rand(n), np.full(n, -0.5)], 1).astype(np.float32)
    d = np.array([0.1, 0.05, 1.0], np.float32) \
        + rng.randn(n, 3).astype(np.float32) * 0.08
    d[:, 2] = np.abs(d[:, 2]) + 0.5
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tgt = rng.rand(n, 3).astype(np.float32)
    js, ja, jo, jd = (jnp.asarray(a) for a in (sigma, albedo, o, d))

    out, vjp = jax.vjp(lambda s, a: jdi.render_density_mega(
        s, a, jo, jd, float(G), 8, 0.0, True), js, ja)
    ok = np.asarray(out["flags"]) == 0
    m = jnp.asarray(ok)[:, None]
    # cotangent of mean(where(ok, (color - tgt)^2, 0)), fed through the
    # kernel's own vjp
    g_color = jnp.where(m, 2.0 * (out["color"] - tgt), 0.0) / (n * 3)
    zeros = jnp.zeros((n,), jnp.float32)
    gk = vjp({"color": g_color, "trans": zeros, "depth": zeros,
              "flags": np.zeros((n,), jax.dtypes.float0)})

    def loss_ref(s, a):
        r = jdiff.render_density(s, a, jo, jd, float(G), 256)
        return jnp.mean((r["color"] - tgt) ** 2) + 0.1 * jnp.mean(r["trans"])

    ref = jdiff.render_density(js, ja, jo, jd, float(G), 256)
    gr = jax.grad(loss_ref, argnums=(0, 1))(js, ja)
    return dict(sigma=sigma, albedo=albedo, o=o, d=d, tgt=tgt, G=G, ok=ok,
                kern={k: np.asarray(v) for k, v in out.items()},
                kern_grads=[np.asarray(g) for g in gk],
                ref={k: np.asarray(v) for k, v in ref.items()},
                ref_grads=[np.asarray(g) for g in gr])


def test_forward_matches_pallas_kernel(blob):
    ok = blob["ok"]
    assert ok.mean() > 0.9
    out = diffint.render_density_mega(*_t(blob["sigma"], blob["albedo"],
                                          blob["o"], blob["d"]), float(blob["G"]))
    assert not out["flags"].any()
    for k, atol in (("color", 2e-4), ("trans", 2e-4)):
        np.testing.assert_allclose(out[k].numpy()[ok], blob["kern"][k][ok],
                                   rtol=2e-4, atol=atol, err_msg=k)


def test_grads_match_pallas_kernel(blob):
    s, a = _t(blob["sigma"], blob["albedo"], grad=True)
    o, d = _t(blob["o"], blob["d"])
    out = diffint.render_density_mega(s, a, o, d, float(blob["G"]))
    m = torch.from_numpy(blob["ok"])[:, None]
    loss = torch.where(m, (out["color"] - torch.from_numpy(blob["tgt"])) ** 2,
                       0.0).mean()
    loss.backward()
    for mine, ref in zip((s.grad, a.grad), blob["kern_grads"]):
        np.testing.assert_allclose(mine.numpy(), ref, rtol=5e-3, atol=5e-5)
    empty = blob["sigma"] == 0.0
    assert float(s.grad[torch.from_numpy(empty)].abs().max()) == 0.0
    assert np.abs(blob["kern_grads"][0][empty]).max() == 0.0


def test_all_rays_match_wavefront_reference(blob):
    """Every ray, including those the Pallas kernel flags, against the
    XLA voxel march."""
    s, a = _t(blob["sigma"], blob["albedo"], grad=True)
    o, d = _t(blob["o"], blob["d"])
    out = diffint.render_density_mega(s, a, o, d, float(blob["G"]))
    for k in ("color", "trans", "depth"):
        assert np.abs(out[k].detach().numpy() - blob["ref"][k]).max() < 5e-5, k
    loss = ((out["color"] - torch.from_numpy(blob["tgt"])) ** 2).mean() \
        + 0.1 * out["trans"].mean()
    loss.backward()
    for mine, ref in zip((s.grad, a.grad), blob["ref_grads"]):
        assert np.abs(mine.numpy() - ref).max() < 5e-3 * np.abs(ref).max()


def test_fan_matches_wavefront_reference(field):
    sigma, albedo = field
    o, d = _fan_rays(16)
    target = np.random.default_rng(1).uniform(0, 1, (o.shape[0], 3)).astype(np.float32)
    js, ja = jnp.asarray(sigma), jnp.asarray(albedo)
    ref = jdiff.render_density(js, ja, jnp.asarray(o), jnp.asarray(d), 10.0, 192)
    gr = jax.grad(lambda s, a: _loss(jdiff.render_density(
        s, a, jnp.asarray(o), jnp.asarray(d), 10.0, 192), target),
        argnums=(0, 1))(js, ja)
    s, a = _t(sigma, albedo, grad=True)
    out = diffint.render_density_mega(s, a, *_t(o, d), 10.0)
    for k in ("color", "trans", "depth"):
        assert np.abs(out[k].detach().numpy() - np.asarray(ref[k])).max() < 5e-5, k
    _loss(out, torch.from_numpy(target)).backward()
    for mine, ref_g in zip((s.grad, a.grad), gr):
        ref_g = np.asarray(ref_g)
        assert np.abs(mine.numpy() - ref_g).max() < 5e-3 * np.abs(ref_g).max()


def test_t_eps_early_termination(field):
    """t_eps > 0 changes color by less than the transmittance floor allows."""
    rays = _t(*_fan_rays(8))
    sa = _t(*field)
    a = diffint.render_density_mega(*sa, *rays, 10.0, 8, 0.0)
    b = diffint.render_density_mega(*sa, *rays, 10.0, 8, 1e-3)
    assert float((a["color"] - b["color"]).abs().max()) < 2e-3


def test_misses_keep_background(field):
    o, d = _t(np.array([[3.0, 3.0, 3.0], [-1.0, -1.0, -1.0]], np.float32),
              np.array([[1.0, 0.0, 0.0], [0.0, 0.0, -1.0]], np.float32))
    out = diffint.render_density_mega(*_t(*field), o, d, 10.0)
    assert torch.equal(out["color"], torch.zeros(2, 3))
    assert torch.equal(out["trans"], torch.ones(2))


def test_slab_sequencer_matches_mega(field):
    """Two z-slabs (each a kernel call per dz class, the carry chained)
    equal one call; the fan has rays of both dz signs."""
    o, d = _fan_rays(12)
    target = torch.from_numpy(np.random.default_rng(3).uniform(
        0, 1, (o.shape[0], 3)).astype(np.float32))
    outs, grads = [], []
    for fn, args in ((diffint.render_density_mega, ()),
                     (diffint.render_density_slabs, (2,))):
        s, a = _t(*field, grad=True)
        out = fn(s, a, *_t(o, d), 10.0, *args)
        _loss(out, target).backward()
        outs.append(out)
        grads.append((s.grad, a.grad))
    assert bool((torch.from_numpy(d[:, 2]) < 0).any())
    for k in ("color", "trans", "depth"):
        assert float((outs[0][k] - outs[1][k]).detach().abs().max()) < 5e-5, k
    for gm, gs in zip(*grads):
        assert float((gm - gs).abs().max()) < 5e-3 * float(gm.abs().max())


def test_quad_and_carry_interface(field):
    """quad = +-1 marches only its dz class and leaves the others at their
    carry; a carry (T, C, D) passes through as the march's prefix."""
    sigma, albedo = field
    tables = diffint._pack_tables(*_t(sigma, albedo))
    occ = diffint.occ_words(tables[0])
    o, d = _t(*_fan_rays(8))
    d[::2, 2] *= -1.0
    n = o.shape[0]
    carry = tuple(torch.full((n,), v) for v in (0.5, 0.1, 0.2, 0.3, 0.4))
    kw = dict(bsize=(2, 2, 2), vpu=10.0)
    full = diffint.integrate_fwd_tiles(0, occ, o, d, diffint._init_carry(n, "cpu"),
                                       *tables, **kw)
    pos = d[:, 2] >= 0
    for quad in (1, -1):
        cr, cg, cb, tr, dp, fl = diffint.integrate_fwd_tiles(
            quad, occ, o, d, carry, *tables, **kw)
        mine = pos if quad > 0 else ~pos
        assert torch.equal(fl[~mine], torch.zeros_like(fl[~mine]))
        assert bool((fl[mine] == 2).any())
        assert torch.equal(tr[~mine], carry[0][~mine])
        assert torch.equal(cr[~mine], carry[1][~mine])
        # T multiplies, C and D add: T = T_in * T_0, C = C_in + T_in * C_0
        torch.testing.assert_close(tr[mine], 0.5 * full[3][mine], atol=1e-6, rtol=1e-5)
        torch.testing.assert_close(cg[mine], 0.2 + 0.5 * full[1][mine],
                                   atol=1e-6, rtol=1e-5)


def test_finite_difference(field):
    """Central difference at the highest-|d/d sigma| voxel of sum(color)
    (tests/test_diffint.py:95-112): within 5 %."""
    sigma, albedo = field
    o, d = _t(*_fan_rays(8))
    a = torch.from_numpy(albedo)

    def loss(s):
        return diffint.render_density_mega(s, a, o, d, 10.0)["color"].double().sum()

    s = torch.tensor(sigma, requires_grad=True)
    loss(s).backward()
    g = s.grad.numpy()
    idx = np.unravel_index(np.abs(g).argmax(), g.shape)
    eps = 1e-2
    sp, sm = sigma.copy(), sigma.copy()
    sp[idx] += eps
    sm[idx] -= eps
    fd = (float(loss(torch.from_numpy(sp))) - float(loss(torch.from_numpy(sm)))) / (2 * eps)
    assert abs(fd - g[idx]) < 0.05 * max(abs(fd), abs(g[idx]), 1e-6)
