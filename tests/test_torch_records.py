"""The integrate kernels' record layout (`ops/cuda/diffint.py`): one
(NB*512, 4) table of (sigma, albedo r, g, b) per voxel in, one (NB*512, 4)
table of gradients out.

- `pack_records` equals the four `pack_rows` tables stacked on the last
  axis, and `unpack_records` inverts it: equal bit for bit.
- The plain march on the record table equals the four-table march it
  replaced, bit for bit, on the CPU (where `index_add_` adds in a fixed
  order): `tests/data/diffint_four_table_plain.npz` holds that march's
  forward outputs (fwd<k>: Cr, Cg, Cb, T, D; flags<k>) and four gradient
  tables (grads<k>: the four (NB*4, 128) tables, flattened) for case k of
  CASES on the inputs `_field` and `_case` make, bsize (2, 2, 2), vpu 10.
  It was written by the four-table plain version (`integrate_fwd_plain` /
  `integrate_bwd_plain` taking `pack_rows` tables of sigma and of each
  albedo channel, in the git history of `ops/cuda/diffint.py`).
- The four-table entry points (`integrate_fwd_tiles`,
  `integrate_bwd_tiles`) equal the record-level ones exactly.
- The plain march's count of warp-steps whose lanes share a voxel.
"""

import os

import numpy as np
import pytest
import torch

from voxel_tracer_tpu_torch.ops.cuda import diffint

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "diffint_four_table_plain.npz")
G, VPU = 16, 10.0
# (quad, trivial carry, t_eps)
CASES = [(0, True, 0.0), (1, False, 1e-3), (-1, False, 0.0)]


def _field(seed=21):
    """16^3 sigma and albedo: a blob with scattered zeros and one empty
    brick."""
    rng = np.random.RandomState(seed)
    zz, yy, xx = np.meshgrid(*[np.linspace(0, 1, G)] * 3, indexing="ij")
    r2 = (xx - 0.5) ** 2 + (yy - 0.5) ** 2 + (zz - 0.5) ** 2
    sigma = 20.0 * np.exp(-r2 * 6.0) * rng.rand(G, G, G)
    sigma[rng.rand(G, G, G) < 0.3] = 0.0
    sigma[8:, 8:, :8] = 0.0                  # brick (0, 1, 1) empty
    albedo = rng.rand(G, G, G, 3)
    return sigma.astype(np.float32), albedo.astype(np.float32)


def _rays(n=384, seed=22):
    """Rays from all sides toward the volume, both dz signs; the first 24
    axis-parallel with +-0 components."""
    rng = np.random.RandomState(seed)
    size = G / VPU
    o = rng.uniform(-0.5, size + 0.5, (n, 3)).astype(np.float32)
    d = (rng.uniform(0.2, size - 0.2, (n, 3)) - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    axes = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1], [-1, 0, 0], [0, -1, 0],
                     [0, 0, -1]], np.float32)
    d[:24] = np.where(axes == 0, np.where(rng.rand(6, 3) < 0.5, -0.0, 0.0),
                      axes)[np.arange(24) % 6]
    o[:24] = 0.5 * size - 1.2 * size * d[:24] \
        + rng.uniform(-0.6, 0.6, (24, 3)).astype(np.float32) * (d[:24] == 0)
    return o, d


def _case(quad, trivial, seed=23):
    """numpy inputs of one case: rays, entering carry and cotangents."""
    o, d = _rays()
    n = o.shape[0]
    rng = np.random.RandomState(seed)
    carry = rng.uniform(0.0, 0.5, (5, n)).astype(np.float32)
    carry[0] += 0.5
    if trivial:
        carry[:] = 0.0
        carry[0] = 1.0
    cts = rng.randn(5, n).astype(np.float32)
    return o, d, carry, cts


def _tensors(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("shape", [(16, 16, 16), (8, 24, 16)])
def test_pack_records_stacks_pack_rows(shape):
    rng = np.random.RandomState(3)
    sigma = torch.from_numpy(rng.rand(*shape).astype(np.float32))
    sigma[:8, :8, :8] = 0.0
    albedo = torch.from_numpy(rng.rand(*shape, 3).astype(np.float32))
    rec = diffint.pack_records(sigma, albedo)
    nv = sigma.numel()
    assert rec.shape == (nv, 4) and rec.is_contiguous()
    rows = [diffint.pack_rows(f) for f in
            (sigma, albedo[..., 0], albedo[..., 1], albedo[..., 2])]
    assert torch.equal(rec, torch.stack([r.reshape(-1) for r in rows], -1))
    back = diffint.unpack_records(rec, shape)
    assert back.shape == (*shape, 4)
    assert torch.equal(back[..., 0], sigma) and torch.equal(back[..., 1:], albedo)
    assert torch.equal(diffint.occ_words(rec[:, 0]), diffint.occ_words(rows[0]))


@pytest.mark.parametrize("case", range(len(CASES)))
def test_record_march_equals_four_table_march(case):
    quad, trivial, t_eps = CASES[case]
    golden = np.load(GOLDEN)
    sigma, albedo = _field()
    rec = diffint.pack_records(torch.from_numpy(sigma), torch.from_numpy(albedo))
    occ = diffint.occ_words(rec[:, 0])
    o, d, carry, cts = _tensors(*_case(quad, trivial))
    kw = dict(bsize=(2, 2, 2), vpu=VPU, t_eps=t_eps)
    fwd = diffint.integrate_fwd_plain(quad, occ, o, d, tuple(carry), rec, **kw)
    np.testing.assert_array_equal(torch.stack(fwd[:5]).numpy(), golden[f"fwd{case}"])
    np.testing.assert_array_equal(fwd[5].numpy(), golden[f"flags{case}"])
    assert int((fwd[5] == 2).sum()) > 64
    grec = diffint.integrate_bwd_plain(quad, occ, o, d, tuple(carry), rec,
                                       tuple(cts), fwd[:5], **kw)
    assert grec.shape == rec.shape
    # the four gradient tables are the record table's columns
    np.testing.assert_array_equal(grec.t().numpy(), golden[f"grads{case}"])
    assert (np.abs(golden[f"grads{case}"]).max(axis=1) > 0).all()


def test_tiles_entry_points_equal_record_launchers():
    """integrate_fwd_tiles / integrate_bwd_tiles (four packed tables in, four
    out) equal the record-level launchers on the same inputs."""
    quad, trivial, t_eps = CASES[1]
    sigma, albedo = (torch.from_numpy(a) for a in _field())
    rec = diffint.pack_records(sigma, albedo)
    tables = tuple(diffint.pack_rows(f).contiguous() for f in
                   (sigma, albedo[..., 0], albedo[..., 1], albedo[..., 2]))
    occ = diffint.occ_words(tables[0])
    o, d, carry, cts = _tensors(*_case(quad, trivial))
    kw = dict(bsize=(2, 2, 2), vpu=VPU, t_eps=t_eps)
    ft = diffint.integrate_fwd_tiles(quad, occ, o, d, tuple(carry), *tables, **kw)
    fr = diffint.integrate_fwd_records(quad, occ, o, d, tuple(carry), rec, **kw)
    for a, b in zip(ft, fr):
        assert torch.equal(a, b)
    gt = diffint.integrate_bwd_tiles(quad, occ, o, d, tuple(carry), *tables,
                                     tuple(cts), ft[:5], **kw)
    gr = diffint.integrate_bwd_records(quad, occ, o, d, tuple(carry), rec,
                                       tuple(cts), fr[:5], **kw)
    assert len(gt) == 4
    for k, g in enumerate(gt):
        assert g.shape == tables[k].shape
        assert torch.equal(g.reshape(-1), gr[:, k])


@pytest.mark.parametrize("spread", [0.0, 1.0])
def test_warp_duplicate_count(spread):
    """The plain march counts the warp-steps (32 consecutive rays at one
    fine step) in which two live lanes read the same voxel: every one of
    them for 64 identical rays, none for 64 parallel rays a voxel apart or
    more."""
    sigma, albedo = (torch.from_numpy(a) for a in _field())
    sigma = torch.full_like(sigma, 0.5)        # dense: no skipped bricks
    rec = diffint.pack_records(sigma, albedo)
    n = 64
    k = torch.arange(n)
    o = torch.zeros(n, 3)
    o[:, 0] = (spread * (k % 16) + 0.5) / VPU     # one voxel column a ray
    o[:, 1] = (spread * (k // 16) + 0.5) / VPU
    o[:, 2] = -0.3
    d = torch.tensor([[0.0, 0.0, 1.0]]).repeat(n, 1)
    stats = {}
    diffint.integrate_fwd_plain(0, diffint.occ_words(rec[:, 0]), o, d,
                                diffint._init_carry(n, "cpu"), rec,
                                bsize=(2, 2, 2), vpu=VPU, stats=stats)
    assert stats["fine_steps"] == n * G            # 16 voxels a ray in z
    assert stats["warp_steps"] == 2 * G
    if spread:
        assert stats["dup_warp_steps"] == 0 and stats["dup_lanes"] == 0
    else:
        assert stats["dup_warp_steps"] == stats["warp_steps"]
        assert stats["dup_lanes"] == n * G - 2 * G
