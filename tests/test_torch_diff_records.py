"""The float4 record of D2 and D3 (`ops/cuda/diff.py`), on the CPU: both
kernels read one (sigma, albedo r, g, b) float4 record a voxel
(`pack_record`), D3 adds one float4 a valid segment into a zeroed
gradient record, which `unpack_grads` splits into d sigma (Z, Y, X) and
d albedo (Z, Y, X, 3).

- pack and unpack round-trip, on grids that are not cubes; on CPU
  tensors `pack_record` is torch's copy (`pack_record_plain`), the pack
  kernel's plain version;
- the plain forward (`ops/diff._render_fwd_only`) rerun with each
  segment's sigma and albedo taken from the record, the next cell's
  record gathered before the segment's arithmetic and kept at the grid's
  edge (what D2<true> reads), equals the plain forward bit for bit, on
  rays with NaN direction components too;
- the plain replay backward (`ops/diff._render_bwd`), run with its
  per-segment gradients gathered into (N, 4) rows and added into one
  (Z * Y * X, 4) record (what D3's float4 reductions compute), unpacks to
  the plain backward's two grids bit for bit, NaN entries included;
- the launchers keep the plain halves on CPU tensors (no record there);
  the rule that picks D2's template (`uses_record`).
"""

import numpy as np
import pytest
import torch

from voxel_tracer_tpu_torch.ops import diff
from voxel_tracer_tpu_torch.ops.cuda import diff as diff_kernel

torch.set_num_threads(1)

VPU = 10.0
STEPS = 96


def _field(shape, seed):
    rng = np.random.RandomState(seed)
    sigma = rng.uniform(0, 5.0, shape).astype(np.float32)
    sigma[rng.rand(*shape) < 0.3] = 0.0
    sigma[rng.rand(*shape) < 0.05] = -1.0
    albedo = rng.uniform(-0.3, 1.0, (*shape, 3)).astype(np.float32)
    return torch.from_numpy(sigma), torch.from_numpy(albedo)


def _rays(shape, n, seed, nan_dirs=False):
    """n rays from around and inside the grid, one in eight axis-parallel;
    with ``nan_dirs`` one in four of the rest has one, two or three NaN
    direction components."""
    rng = np.random.RandomState(seed)
    size = np.array(shape[::-1], np.float32) / VPU
    o = (rng.uniform(-0.3, 1.3, (n, 3)) * size).astype(np.float32)
    d = rng.randn(n, 3).astype(np.float32)
    d[: n // 8] = np.eye(3, dtype=np.float32)[rng.randint(0, 3, n // 8)] \
        * np.where(rng.rand(n // 8, 1) < 0.5, -1.0, 1.0).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    if nan_dirs:
        rows = np.arange(n // 8, n, 4)
        d[rows] = np.where(rng.rand(len(rows), 3) < 0.5, np.nan, d[rows])
        d[rows[::3], rng.randint(0, 3, len(rows[::3]))] = np.nan
    return torch.from_numpy(o), torch.from_numpy(d)


SHAPES = [(16, 16, 16), (7, 12, 20), (1, 5, 9)]


@pytest.mark.parametrize("shape", SHAPES, ids=[f"{z}x{y}x{x}" for z, y, x in SHAPES])
def test_record_pack_unpack_round_trip(shape):
    sigma, albedo = _field(shape, 1)
    rec = diff_kernel.pack_record(sigma, albedo)
    assert rec.shape == (sigma.numel(), 4) and rec.is_contiguous()
    assert torch.equal(rec, diff_kernel.pack_record_plain(sigma, albedo))
    np.testing.assert_array_equal(rec[:, 0].numpy(), sigma.reshape(-1).numpy())
    np.testing.assert_array_equal(rec[:, 1:].numpy(), albedo.reshape(-1, 3).numpy())
    s2, a2 = diff_kernel.unpack_grads(rec, sigma.shape)
    assert s2.is_contiguous() and a2.is_contiguous()
    assert torch.equal(s2, sigma) and torch.equal(a2, albedo)


def _bwd_into_record(sigma, albedo, o, d, color, trans, depth, gC, gT, gD):
    """ops/diff._render_bwd with each step's (d sigma, d albedo) rows added
    into one (Z * Y * X, 4) record, as D3's float4 reductions add them."""
    size3_i, (st, stepi, delta, _, t_exit) = diff._setup(sigma, o, d, VPU)
    n = o.shape[0]
    sig_flat, alb_flat = sigma.reshape(-1), albedo.reshape(-1, 3)
    grec = torch.zeros((sigma.numel(), 4))
    T = torch.ones(n)
    Cpre, Dpre = torch.zeros((n, 3)), torch.zeros(n)
    for _ in range(STEPS):
        if not bool(st.alive.any()):
            break
        st2, cell, dl, valid = diff._step(st, stepi, delta, size3_i, t_exit)
        idx = diff._flat_idx(cell, size3_i)
        sg, al = sig_flat[idx], alb_flat[idx]
        e = torch.exp(-torch.clamp(sg, min=0.0) * dl)
        alpha = 1.0 - e
        w = torch.where(valid, T * alpha, 0.0)
        seg_d = st.t + 0.5 * dl
        Cpre = Cpre + w[:, None] * al
        Dpre = Dpre + w * seg_d
        gsig = (torch.sum(gC * (T * e)[:, None] * al - gC * (color - Cpre), dim=-1)
                + gD * ((T * e) * seg_d - (depth - Dpre)) - gT * trans) * dl
        rows = torch.cat([torch.where(valid & (sg > 0.0), gsig, 0.0)[:, None],
                          torch.where(valid[:, None], gC * w[:, None], 0.0)], dim=-1)
        grec.index_add_(0, idx, rows)
        T = torch.where(valid, T * (1.0 - alpha), T)
        st = st2
    return grec


@pytest.mark.parametrize("shape", SHAPES[:2], ids=["16^3", "7x12x20"])
def test_gradient_record_unpacks_to_the_plain_backward(shape):
    sigma, albedo = _field(shape, 2)
    o, d = _rays(shape, 96, 3)
    color, trans, depth = diff._render_fwd_only(sigma, albedo, o, d, VPU, STEPS)
    rng = np.random.RandomState(4)
    cts = [torch.from_numpy(rng.randn(*s).astype(np.float32)) for s in ((96, 3), (96,), (96,))]
    ref = diff._render_bwd(sigma, albedo, o, d, VPU, STEPS, color, trans, depth, *cts)
    assert ref[0].abs().max() > 0 and ref[1].abs().max() > 0
    grec = _bwd_into_record(sigma, albedo, o, d, color, trans, depth, *cts)
    got = diff_kernel.unpack_grads(grec, sigma.shape)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_array_equal(g.numpy(), r.numpy())
    assert (got[0][sigma <= 0] == 0).all()                 # d sigma 0 where sigma <= 0


def test_gradient_record_unpacks_to_the_plain_backward_on_nan_directions():
    """As above, on rays with NaN direction components: their saved depth
    is NaN, and so is d sigma of their first segment where sigma > 0."""
    shape = (16, 16, 16)
    sigma, albedo = _field(shape, 2)
    o, d = _rays(shape, 96, 3, nan_dirs=True)
    color, trans, depth = diff._render_fwd_only(sigma, albedo, o, d, VPU, STEPS)
    assert torch.isnan(depth).sum() >= 10
    cts = [torch.from_numpy(np.random.RandomState(4).randn(*s).astype(np.float32))
           for s in ((96, 3), (96,), (96,))]
    ref = diff._render_bwd(sigma, albedo, o, d, VPU, STEPS, color, trans, depth, *cts)
    assert bool(torch.isnan(ref[0]).any())
    got = diff_kernel.unpack_grads(_bwd_into_record(sigma, albedo, o, d, color, trans, depth,
                                                    *cts), sigma.shape)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), r.numpy())
    assert (got[0][sigma <= 0] == 0).all()


def _fwd_from_record(rec, sigma, o, d):
    """ops/diff._render_fwd_only with each segment's sigma and albedo read
    from the record, the next cell's record gathered ahead of the
    segment's arithmetic and the current one kept where the step leaves
    the grid, as D2<true> reads them."""
    size3_i, (st, stepi, delta, _, t_exit) = diff._setup(sigma, o, d, VPU)
    nan_depth = diff._nan_depth(st, delta, t_exit, STEPS)
    n = o.shape[0]
    T, C, D = torch.ones(n), torch.zeros((n, 3)), torch.zeros(n)
    r = rec[diff._flat_idx(st.cell, size3_i)]
    for _ in range(STEPS):
        if not bool(st.alive.any()):
            break
        st2, _cell, dl, valid = diff._step(st, stepi, delta, size3_i, t_exit)
        oob = ((st2.cell < 0) | (st2.cell >= size3_i)).any(dim=-1)
        rn = torch.where(oob[:, None], r, rec[diff._flat_idx(st2.cell, size3_i)])
        sg, al = r[:, 0], r[:, 1:]
        alpha = 1.0 - torch.exp(-torch.clamp(sg, min=0.0) * dl)
        w = torch.where(valid, T * alpha, 0.0)
        C = C + w[:, None] * al
        D = D + w * (st.t + 0.5 * dl)
        T = torch.where(valid, T * (1.0 - alpha), T)
        st, r = st2, rn
    return C, T, torch.where(nan_depth, float("nan"), D)


@pytest.mark.parametrize("nan_dirs", [False, True], ids=["finite", "nan_dirs"])
@pytest.mark.parametrize("shape", SHAPES, ids=[f"{z}x{y}x{x}" for z, y, x in SHAPES])
def test_record_march_equals_the_plain_forward(shape, nan_dirs):
    sigma, albedo = _field(shape, 6)
    o, d = _rays(shape, 128, 7, nan_dirs)
    ref = diff._render_fwd_only(sigma, albedo, o, d, VPU, STEPS)
    got = _fwd_from_record(diff_kernel.pack_record(sigma, albedo), sigma, o, d)
    assert (ref[1] < 1).any()
    nan_ray = torch.isnan(d).any(dim=1)
    assert bool(nan_ray.any()) == nan_dirs and bool(torch.isnan(ref[2][nan_ray]).all())
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), r.numpy())


def test_template_rule():
    """D2 reads the record whenever the call needs a gradient (D3 reads
    the same record), else only with rays enough for the grid's voxels."""
    voxels = 128 ** 3
    least = int(np.ceil(diff_kernel.RECORD_MIN_RAYS_PER_VOXEL * voxels))
    assert diff_kernel.uses_record(1, voxels, True)
    assert diff_kernel.uses_record(least, voxels, False)
    assert not diff_kernel.uses_record(least - 1, voxels, False)
    assert not diff_kernel.uses_record(64 * 64, voxels, False)     # Trainer.render's view


def test_march_bwd_on_cpu_tensors_is_the_plain_backward():
    shape = (8, 12, 10)
    sigma, albedo = _field(shape, 5)
    o, d = _rays(shape, 40, 6)
    fwd = diff_kernel.march_fwd(sigma, albedo, o, d, VPU, STEPS)
    cts = [torch.ones(40, 3), torch.ones(40), torch.ones(40)]
    got = diff_kernel.march_bwd(sigma, albedo, o, d, VPU, STEPS, *fwd, *cts)
    ref = diff._render_bwd(sigma, albedo, o, d, VPU, STEPS, *fwd, *cts)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)
    rec = diff_kernel.pack_record(sigma, albedo)       # a record given changes nothing here
    for g, r in zip(diff_kernel.march_bwd(sigma, albedo, o, d, VPU, STEPS, *fwd, *cts, rec=rec),
                    ref):
        assert torch.equal(g, r)
