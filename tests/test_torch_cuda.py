"""The CUDA kernels of the port vs their plain PyTorch versions, on the card.

Marked `cuda`: each test skips when no CUDA device is present (decided in
the test, never at import).  Run on a machine with an NVIDIA GPU:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: mega kernels: hits, materials, axes, steps and resolved flags
equal; depth within 1e-5 (0 on ray lists: the same float program); image
within 1 LSB (expf may differ by an ulp).
Integrate kernels (record layout): flags equal; color, trans and depth
within 1e-5 (expf may differ by an ulp); each gradient column within
1e-4 x its max|g| (the kernel's vector reductions and `index_add_` sum in
orders that change from run to run, most where many rays update one
voxel), and exactly 0 in empty bricks and, for d sigma, where sigma is 0.
Coherent (B5) and indep (B3, B4) kernels: the same float32 program as the
plain versions, so hits, voxel/material, axes, steps and resolved flags
equal; t within 1e-5 (equal on B5's edge rays, its large grid and its
edited grid, and on the indep volumes that fill the bitmap or walk
hundreds of bricks); image within 1 LSB (expf in the sky).
The DDA kernel (D1) against the plain DDA (`ops/dda.py`) in every mode:
every output equal, t bit for bit (the same float32 program; stochastic
shadows key on the hit cell).
The differentiable march (D2, D3) against the plain march (`ops/diff.py`):
color, trans and depth within 1e-6 and NaN on the same rays; gradients
within 1e-4 x max|g| (atomics), d sigma 0 where sigma is 0.
"""

import numpy as np
import pytest
import torch

from voxel_tracer_tpu_torch.models.camera import Camera
from voxel_tracer_tpu_torch.models.volume import VoxelVolume
from voxel_tracer_tpu_torch.ops import dda
from voxel_tracer_tpu_torch.ops.cuda import (coherent, diffint, indep,
                                             integrate, mega, renderer_fast)
from voxel_tracer_tpu_torch.ops.cuda import dda as dda_kernel
from voxel_tracer_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _sphere_volume():
    n = 16
    z, y, x = np.meshgrid(*[np.arange(n)] * 3, indexing="ij")
    c = (n - 1) / 2
    d = np.sqrt((x - c) ** 2 + (y - c) ** 2 + (z - c) ** 2)
    grid = np.where(d < 0.42 * n, np.where(y > c, 140, 23), 0).astype(np.uint8)
    pal = np.random.RandomState(3).rand(256, 3).astype(np.float32)
    return VoxelVolume(grid, palette=pal, pos=(0.1, -0.05, 0.2), vpu=20.0)


@pytest.mark.parametrize("shading", ["flat", "lambert", "raw", "trace"])
@pytest.mark.parametrize("sky_mode", ["analytic", "constant", "none"])
def test_camera_kernel_matches_plain(cuda, shading, sky_mode):
    mv = mega.MegaVolume(VoxelVolume.noise_filled((40, 48, 56)), cuda)
    cam = Camera.create((2.0, 1.4, -2.4), (0.0, 0.0, 0.0), 2.0)
    cam_p = mega.mega_camera(mv, cam, (-0.62, 0.47, -0.63), 96, 48,
                             sky_const=(0.1, 0.2, 0.3))
    kw = dict(width=96, height=48, sky_mode=sky_mode, shading=shading)
    before = mega.KERNEL_LAUNCHES["mega_camera"]
    rk, tk, ak = mega.render_mega_tiles(cam_p, mv.tables, **kw)
    assert mega.KERNEL_LAUNCHES["mega_camera"] == before + 1
    rp, tp, ap = mega.render_mega_tiles_plain(cam_p, mv.tables, **kw)
    torch.cuda.synchronize()
    assert torch.equal(ak, ap)
    assert torch.equal(tk < mega.BIG, tp < mega.BIG)
    assert float((tk - tp).abs().max()) <= 1e-5
    diff = (mega._unpack_rgb8(rk) - mega._unpack_rgb8(rp)).abs()
    assert int(diff.max()) <= 1


def test_ray_kernel_matches_plain(cuda):
    rng = np.random.RandomState(1)
    n = 8192
    o = rng.uniform(-0.5, 1.3, (n, 3)).astype(np.float32)
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:64] = [[0.0, -0.0, 1.0], [-0.0, 1.0, 0.0], [-1.0, 0.0, -0.0],
              [0.0, 0.0, -1.0]] * 16
    mv = mega.MegaVolume(_sphere_volume(), cuda)
    o_t, d_t = torch.from_numpy(o).to(cuda), torch.from_numpy(d).to(cuda)
    for fetch in (False, True):
        k = mega.trace_rays(o_t, d_t, mv.tables, fetch_mat=fetch)
        p = mega.trace_rays_plain(o_t, d_t, mv.tables, fetch_mat=fetch)
        for f in ("mat", "ax", "steps", "resolved"):
            assert torch.equal(k[f], p[f]), f
        assert torch.equal(k["t"] < mega.BIG, p["t"] < mega.BIG)
        assert float((k["t"] - p["t"]).abs().max()) <= 1e-5


def test_lit_frame_kernel_matches_plain(cuda):
    mv = mega.MegaVolume(_sphere_volume(), cuda)
    cam = Camera.create((1.2, 0.9, -1.4), (0.1, -0.05, 0.2), 2.0)
    k = mega.render_lambert_mega(mv, cam, 64, 32)
    p = mega.render_lambert_mega_plain(mv, cam, 64, 32)
    for f in ("depth", "normal", "material", "steps", "irradiance"):
        assert torch.equal(k[f], p[f]), f
    assert int((k["image"].int() - p["image"].int()).abs().max()) <= 1


def _assert_mega_trace_equal(k, p):
    for f in ("mat", "ax", "steps", "resolved"):
        assert torch.equal(k[f], p[f]), f
    assert torch.equal(k["t"] < mega.BIG, p["t"] < mega.BIG)
    assert float((k["t"] - p["t"]).abs().max()) == 0.0


@pytest.mark.parametrize("length", [4096, 65600])
def test_ray_kernel_step_budget(cuda, length):
    """The long sparse volume of `profiling.budget_scene`: most rays run out
    of the 256-step budget, some hit, some cross brick corners; at 4096
    voxels (2048 bricks, a 64-word bitmap) and 65600 (32,800 bricks, 1025
    words)."""
    g, o, d, vpu = profiling.budget_scene(length=length, n_rays=65536)
    tb = mega.pack_tables(g, np.ones((256, 3), np.float32), vpu, cuda)
    assert tb.bitmap.numel() == (length // 8 * 4 + 31) // 32
    o_t, d_t = torch.from_numpy(o).to(cuda), torch.from_numpy(d).to(cuda)
    k = mega.trace_rays(o_t, d_t, tb, fetch_mat=True)
    p = mega.trace_rays_plain(o_t, d_t, tb, fetch_mat=True)
    _assert_mega_trace_equal(k, p)
    exhausted = int((~k["resolved"]).sum())
    assert exhausted > 65536 // 2 and bool((k["t"] < mega.BIG).any())
    assert bool((k["steps"][~k["resolved"]] == 256).all())


def test_ray_kernel_empty_list(cuda):
    mv = mega.MegaVolume(_sphere_volume(), cuda)
    empty = torch.zeros((0, 3), device=cuda)
    before = mega.KERNEL_LAUNCHES["mega_rays"]
    k = mega.trace_rays(empty, empty, mv.tables, fetch_mat=True)
    p = mega.trace_rays_plain(empty, empty, mv.tables, fetch_mat=True)
    assert mega.KERNEL_LAUNCHES["mega_rays"] == before
    for f in p:
        assert k[f].shape == (0,) and k[f].dtype == p[f].dtype, f


def test_kernel_rejects_bad_input(cuda):
    mv = mega.MegaVolume(_sphere_volume(), cuda)
    o = torch.zeros((4, 3), device=cuda)
    with pytest.raises(TypeError):
        mega.trace_rays(o.double(), o.double(), mv.tables)
    with pytest.raises(ValueError):
        mega.trace_rays(o.t().contiguous().t(), o, mv.tables)
    with pytest.raises(ValueError):
        mega.trace_rays(o, o.cpu(), mv.tables)


# ---------------------------------------------------------------------------
# B6 / B7: the integrate kernels
# ---------------------------------------------------------------------------

def _blob_scene(dev, empty=False, g=32):
    rng = np.random.RandomState(11)
    zz, yy, xx = np.meshgrid(*[np.linspace(0, 1, g)] * 3, indexing="ij")
    r2 = (xx - 0.5) ** 2 + (yy - 0.5) ** 2 + (zz - 0.5) ** 2
    blob = 30.0 * np.exp(-r2 * 60.0)
    sigma = np.where(blob > 0.05, rng.rand(g, g, g) * blob * 0.3, 0.0)
    if empty:
        sigma[:] = 0.0
    albedo = rng.rand(g, g, g, 3)
    rec = diffint.pack_records(torch.tensor(sigma, dtype=torch.float32),
                               torch.tensor(albedo, dtype=torch.float32)).to(dev)
    return rec, diffint.occ_words(rec[:, 0]), (g // 8,) * 3, float(g)


def _mixed_rays(dev, n=4096):
    """Rays from all sides in both dz signs; the first 96 are axis-parallel
    with +-0 components."""
    rng = np.random.RandomState(5)
    o = rng.uniform(-0.6, 1.6, (n, 3)).astype(np.float32)
    tgt = rng.uniform(0.2, 0.8, (n, 3)).astype(np.float32)
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    axes = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1], [-1, 0, 0], [0, -1, 0],
                     [0, 0, -1]], np.float32)
    d[:96] = np.where(axes == 0, np.where(rng.rand(6, 3) < 0.5, -0.0, 0.0),
                      axes)[np.arange(96) % 6]
    o[:96] = 0.5 - 1.2 * d[:96] + rng.uniform(-0.3, 0.3, (96, 3)) * (d[:96] == 0)
    return torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)


def _carry(n, dev, trivial):
    if trivial:
        return diffint._init_carry(n, dev)
    rng = np.random.RandomState(2)
    c = rng.uniform(0.0, 0.5, (5, n)).astype(np.float32)
    c[0] += 0.5
    return tuple(torch.from_numpy(x).to(dev) for x in c)


def _assert_grads_match(kb, pb, rec, bsize):
    """Kernel vs plain gradient records: each column within 1e-4 x its
    max|g|; exactly 0 in empty bricks and, for d sigma, where sigma is 0."""
    for k in range(4):
        scale = float(pb[:, k].abs().max())
        assert scale > 0.0, k
        assert float((kb[:, k] - pb[:, k]).abs().max()) <= 1e-4 * scale, k
    assert float(kb[:, 0][rec[:, 0] == 0.0].abs().max()) == 0.0
    nb = bsize[0] * bsize[1] * bsize[2]
    empty = rec[:, 0].reshape(nb, 512).amax(dim=1) <= 0.0
    assert bool(empty.any())
    assert float(kb.reshape(nb, 512 * 4)[empty].abs().max()) == 0.0


@pytest.mark.parametrize("quad", [0, 1, -1])
@pytest.mark.parametrize("trivial_carry", [True, False])
@pytest.mark.parametrize("t_eps", [0.0, 1e-3])
def test_integrate_kernels_match_plain(cuda, quad, trivial_carry, t_eps):
    rec, occ, bsize, vpu = _blob_scene(cuda)
    o, d = _mixed_rays(cuda)
    n = o.shape[0]
    carry = _carry(n, cuda, trivial_carry)
    kw = dict(bsize=bsize, vpu=vpu, t_eps=t_eps)
    before = dict(diffint.KERNEL_LAUNCHES)
    k = diffint.integrate_fwd_records(quad, occ, o, d, carry, rec, **kw)
    p = diffint.integrate_fwd_plain(quad, occ, o, d, carry, rec, **kw)
    assert torch.equal(k[5], p[5])
    assert int((k[5] & 2).sum()) > n // 4
    for a, b in zip(k[:5], p[:5]):
        assert float((a - b).abs().max()) <= 1e-5
    rng = np.random.RandomState(9)
    cts = tuple(torch.from_numpy(x).to(cuda)
                for x in rng.randn(5, n).astype(np.float32))
    kb = diffint.integrate_bwd_records(quad, occ, o, d, carry, rec, cts, k[:5], **kw)
    pb = diffint.integrate_bwd_plain(quad, occ, o, d, carry, rec, cts, k[:5], **kw)
    assert diffint.KERNEL_LAUNCHES["integrate_fwd"] == before["integrate_fwd"] + 1
    assert diffint.KERNEL_LAUNCHES["integrate_bwd"] == before["integrate_bwd"] + 1
    _assert_grads_match(kb, pb, rec, bsize)


@pytest.mark.parametrize("bundle", ["identical", "parallel"])
def test_integrate_bwd_contention(cuda, bundle):
    """Many rays through the same voxels: 4096 identical rays, or a 64x64
    bundle of parallel rays a quarter voxel apart (16 rays a voxel column),
    so the gradient reductions meet duplicate addresses within a warp and
    across warps."""
    rec, occ, bsize, vpu = _blob_scene(cuda)
    n = 4096
    k = torch.arange(n, device=cuda)
    o = torch.empty((n, 3), device=cuda)
    if bundle == "identical":
        o[:] = torch.tensor([0.43, 0.51, -0.4], device=cuda)
    else:
        o[:, 0] = 0.3 + (k % 64).float() * (0.25 / vpu)
        o[:, 1] = 0.3 + (k // 64).float() * (0.25 / vpu)
        o[:, 2] = -0.4
    d = torch.nn.functional.normalize(
        torch.tensor([[0.02, 0.01, 1.0]], device=cuda), dim=1).repeat(n, 1)
    carry = _carry(n, cuda, True)
    kw = dict(bsize=bsize, vpu=vpu)
    fwd = diffint.integrate_fwd_records(0, occ, o, d, carry, rec, **kw)
    rng = np.random.RandomState(8)
    cts = tuple(torch.from_numpy(x).to(cuda)
                for x in rng.randn(5, n).astype(np.float32))
    kb = diffint.integrate_bwd_records(0, occ, o, d, carry, rec, cts, fwd[:5], **kw)
    pb = diffint.integrate_bwd_plain(0, occ, o, d, carry, rec, cts, fwd[:5], **kw)
    _assert_grads_match(kb, pb, rec, bsize)


def test_integrate_tiles_interface_on_the_card(cuda):
    """integrate_fwd_tiles / integrate_bwd_tiles (four packed tables)
    interleave into the record kernels and split their gradients."""
    rec, occ, bsize, vpu = _blob_scene(cuda)
    tables = tuple(rec[:, k].reshape(-1, 128).contiguous() for k in range(4))
    o, d = _mixed_rays(cuda, 1024)
    carry = _carry(1024, cuda, False)
    kw = dict(bsize=bsize, vpu=vpu)
    ft = diffint.integrate_fwd_tiles(0, occ, o, d, carry, *tables, **kw)
    fr = diffint.integrate_fwd_records(0, occ, o, d, carry, rec, **kw)
    for a, b in zip(ft, fr):
        assert torch.equal(a, b)
    gt = diffint.integrate_bwd_tiles(0, occ, o, d, carry, *tables, carry, ft[:5], **kw)
    gr = diffint.integrate_bwd_records(0, occ, o, d, carry, rec, carry, ft[:5], **kw)
    for k, g in enumerate(gt):
        assert g.shape == tables[k].shape
        scale = float(gr[:, k].abs().max())
        assert float((g.reshape(-1) - gr[:, k]).abs().max()) <= 1e-4 * scale


def test_integrate_kernels_empty_grid(cuda):
    rec, occ, bsize, vpu = _blob_scene(cuda, empty=True)
    assert int(occ.abs().sum()) == 0
    o, d = _mixed_rays(cuda, 512)
    carry = _carry(512, cuda, False)
    cr, cg, cb, tr, dp, fl = diffint.integrate_fwd_records(
        0, occ, o, d, carry, rec, bsize=bsize, vpu=vpu)
    for a, b in zip((tr, cr, cg, cb, dp), carry):
        assert torch.equal(a, b)
    grad = diffint.integrate_bwd_records(
        0, occ, o, d, carry, rec, carry, carry, bsize=bsize, vpu=vpu)
    assert float(grad.abs().max()) == 0.0


def test_integrate_kernels_no_rays(cuda):
    rec, occ, bsize, vpu = _blob_scene(cuda)
    o = torch.zeros((0, 3), device=cuda)
    carry = _carry(0, cuda, True)
    before = dict(diffint.KERNEL_LAUNCHES)
    out = diffint.integrate_fwd_records(0, occ, o, o, carry, rec,
                                        bsize=bsize, vpu=vpu)
    grad = diffint.integrate_bwd_records(0, occ, o, o, carry, rec, carry,
                                         carry, bsize=bsize, vpu=vpu)
    assert diffint.KERNEL_LAUNCHES == before
    assert all(x.shape == (0,) for x in out)
    assert grad.shape == rec.shape and float(grad.abs().max()) == 0.0


def test_integrate_kernels_reject_bad_input(cuda):
    rec, occ, bsize, vpu = _blob_scene(cuda)
    o, d = _mixed_rays(cuda, 128)
    carry = _carry(128, cuda, True)
    kw = dict(bsize=bsize, vpu=vpu)
    with pytest.raises(TypeError):
        diffint.integrate_fwd_records(0, occ, o.double(), d, carry, rec, **kw)
    with pytest.raises(ValueError):
        diffint.integrate_fwd_records(0, occ, o, d.t().contiguous().t(), carry,
                                      rec, **kw)
    with pytest.raises(ValueError):
        diffint.integrate_fwd_records(0, occ.cpu(), o, d, carry, rec, **kw)
    with pytest.raises(ValueError):
        diffint.integrate_bwd_records(0, occ, o, d, carry, rec,
                                      tuple(c.cpu() for c in carry), carry, **kw)
    with pytest.raises(ValueError):        # records 4 bytes off 16-byte alignment
        flat = torch.zeros(rec.numel() + 1, device=cuda)
        diffint.integrate_fwd_records(0, occ, o, d, carry, flat[1:].view(-1, 4), **kw)
    with pytest.raises(ValueError):        # a four-table table of the wrong shape
        tables = tuple(rec[:, k].reshape(-1, 128).contiguous() for k in range(4))
        diffint.integrate_fwd_tiles(0, occ, o, d, carry, *tables[:3], tables[3][1:],
                                    **kw)


def test_render_density_mega_on_the_card(cuda):
    """The autograd path launches both kernels; the card and the CPU
    plain version agree (forward 1e-5; grads 1e-4 x max|g|)."""
    g = 32
    rng = np.random.RandomState(4)
    sigma = np.where(rng.rand(g, g, g) < 0.3, rng.rand(g, g, g) * 20, 0.0)
    albedo = rng.rand(g, g, g, 3)
    o, d = _mixed_rays("cpu", 2048)
    target = torch.from_numpy(rng.rand(2048, 3).astype(np.float32))
    grads = []
    for dev in (cuda, "cpu"):
        s = torch.tensor(sigma, dtype=torch.float32, device=dev, requires_grad=True)
        a = torch.tensor(albedo, dtype=torch.float32, device=dev, requires_grad=True)
        before = dict(diffint.KERNEL_LAUNCHES)
        out = diffint.render_density_mega(s, a, o.to(dev), d.to(dev), float(g))
        loss = ((out["color"] - target.to(dev)) ** 2).mean() + out["depth"].mean()
        loss.backward()
        launched = {k: v - before[k] for k, v in diffint.KERNEL_LAUNCHES.items()}
        assert launched == ({"integrate_fwd": 1, "integrate_bwd": 1}
                            if dev == cuda else
                            {"integrate_fwd": 0, "integrate_bwd": 0})
        grads.append((out["color"].detach().cpu(), s.grad.cpu(), a.grad.cpu()))
    (ck, sk, ak), (cp, sp, ap) = grads
    assert float((ck - cp).abs().max()) <= 1e-5
    for x, y in ((sk, sp), (ak, ap)):
        assert float((x - y).abs().max()) <= 1e-4 * float(y.abs().max())


# ---------------------------------------------------------------------------
# B5: the coherent kernel; B3 / B4: the indep kernels
# ---------------------------------------------------------------------------

def _local_rays(dev, n, lo, hi, seed):
    """Random local rays; the first 96 are axis-parallel with +-0
    components, the last 64 start near 1e30 (a missed pixel's shadow
    ray)."""
    rng = np.random.RandomState(seed)
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    axes = np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1], [-1, 0, 0], [0, -1, 0],
                     [0, 0, -1]], np.float32)
    d[:96] = np.where(axes == 0, np.where(rng.rand(6, 3) < 0.5, -0.0, 0.0),
                      axes)[np.arange(96) % 6]
    o[-64:] = d[-64:] * 1e30
    return torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)


def _assert_trace_equal(k, p):
    for f in ("vox", "mat", "ax", "steps", "resolved"):
        if f in p:
            assert torch.equal(k[f], p[f]), f
    big = coherent.BIG
    assert torch.equal(k["t"] < big, p["t"] < big)
    assert float((k["t"] - p["t"]).abs().max()) <= 1e-5


@pytest.mark.parametrize("grid", ["noise", "sphere"])
def test_coherent_kernel_matches_plain(cuda, grid):
    vol = (VoxelVolume.noise_filled((40, 48, 56)) if grid == "noise"
           else _sphere_volume())
    pv = coherent.pack_volume(vol.grid, vol.vpu, cuda)
    o, d = _local_rays(cuda, 8192, -0.5, 3.3, 3)
    before = coherent.KERNEL_LAUNCHES["coherent"]
    k = coherent.trace_coherent(pv.occ, pv.words, o, d, pv.bsize, pv.vpu)
    assert coherent.KERNEL_LAUNCHES["coherent"] == before + 1
    p = coherent.trace_coherent_plain(pv.occ, pv.words, o, d, pv.bsize, pv.vpu)
    _assert_trace_equal(k, p)
    assert bool(k["resolved"].all()) and bool((k["t"] < coherent.BIG).any())
    far = slice(-64, None)
    assert bool((k["vox"][far] == -1).all() and (k["steps"][far] == 0).all())


def test_coherent_kernel_empty_list_and_bad_input(cuda):
    pv = coherent.pack_volume(_sphere_volume().grid, 20.0, cuda)
    empty = torch.zeros((0, 3), device=cuda)
    before = coherent.KERNEL_LAUNCHES["coherent"]
    k = coherent.trace_coherent(pv.occ, pv.words, empty, empty, pv.bsize, pv.vpu)
    assert coherent.KERNEL_LAUNCHES["coherent"] == before
    assert all(v.shape == (0,) for v in k.values())
    o = torch.zeros((4, 3), device=cuda)
    with pytest.raises(TypeError):
        coherent.trace_coherent(pv.occ, pv.words, o.double(), o.double(),
                                pv.bsize, pv.vpu)
    with pytest.raises(ValueError):
        coherent.trace_coherent(pv.occ.cpu(), pv.words, o, o, pv.bsize, pv.vpu)


def _assert_coherent_equal(k, p):
    """B5 against its plain version: every field equal, t included."""
    for f in ("t", "vox", "ax", "steps", "resolved"):
        assert k[f].dtype == p[f].dtype and torch.equal(k[f], p[f]), f


def _edge_volume(grid):
    if grid == "sphere":
        return _sphere_volume()
    if grid == "bench":                 # bench.py's 64^3 noise, 512 bricks
        return VoxelVolume.noise_filled((64, 64, 64), pos=(0, 0, 0), vpu=20.0)
    return VoxelVolume.noise_filled((40, 48, 56))


@pytest.mark.parametrize("grid", ["sphere", "noise", "bench"])
def test_coherent_kernel_edge_rays(cuda, grid):
    """`profiling.edge_rays`: axis-parallel rays, zero direction
    components, starts inside solid voxels and on brick faces, origins near
    1e30, rays grazing brick edges and through brick corners."""
    vol = _edge_volume(grid)
    pv = coherent.pack_volume(vol.grid, vol.vpu, cuda)
    o, d = (torch.from_numpy(x).to(cuda) for x in profiling.edge_rays(vol.grid, vol.vpu))
    before = coherent.KERNEL_LAUNCHES["coherent"]
    k = coherent.trace_coherent(pv.occ, pv.words, o, d, pv.bsize, pv.vpu)
    assert coherent.KERNEL_LAUNCHES["coherent"] == before + 1
    p = coherent.trace_coherent_plain(pv.occ, pv.words, o, d, pv.bsize, pv.vpu)
    torch.cuda.synchronize()
    _assert_coherent_equal(k, p)
    assert bool(k["resolved"].all()) and bool((k["t"] < coherent.BIG).any())


def test_coherent_kernel_large_grid(cuda):
    """A grid of 409,600 bricks (a 51,200-byte bitmap), 2 % of them holding
    random voxels, and rays in and around it."""
    rng = np.random.RandomState(9)
    bsize = (80, 80, 64)
    nb = bsize[0] * bsize[1] * bsize[2]
    bits = np.zeros((nb, 512), bool)
    full = np.nonzero(rng.rand(nb) < 0.02)[0]
    bits[full] = rng.rand(len(full), 512) < 0.1
    words = np.packbits(bits, axis=1, bitorder="little").view("<u4").view(np.int32)
    occ = torch.tensor(words.any(axis=1).astype(np.int32), device=cuda)
    words = torch.tensor(words, device=cuda)
    o, d = _local_rays(cuda, 65536, -1.0, 33.0, 5)
    o = o * torch.tensor([1.0, 1.0, 0.8], device=cuda)
    k = coherent.trace_coherent(occ, words, o, d, bsize, 20.0)
    p = coherent.trace_coherent_plain(occ, words, o, d, bsize, 20.0)
    torch.cuda.synchronize()
    _assert_coherent_equal(k, p)
    assert bool((k["t"] < coherent.BIG).any())


def test_coherent_kernel_follows_in_place_occupancy_edits(cuda):
    """The launch arguments kept on `occ` are rebuilt after an in-place
    edit: the kernel then walks the edited bitmap, as the plain version
    walks the edited flags."""
    vol = _sphere_volume()
    pv = coherent.pack_volume(vol.grid, vol.vpu, cuda)
    o, d = _local_rays(cuda, 8192, -0.5, 1.3, 11)
    first = coherent.trace_coherent(pv.occ, pv.words, o, d, pv.bsize, pv.vpu)
    pv.occ[pv.occ.nonzero()[:4, 0]] = 0
    k = coherent.trace_coherent(pv.occ, pv.words, o, d, pv.bsize, pv.vpu)
    p = coherent.trace_coherent_plain(pv.occ, pv.words, o, d, pv.bsize, pv.vpu)
    torch.cuda.synchronize()
    _assert_coherent_equal(k, p)
    assert not torch.equal(first["vox"], k["vox"])


def test_lambert_fast_kernel_matches_plain(cuda):
    vols = [_sphere_volume(), VoxelVolume(_sphere_volume().grid, pos=(0.9, 0.1, 0.4))]
    scene = renderer_fast.FastScene.build(vols, device=cuda)
    cam = Camera.create((1.2, 0.9, -1.4), (0.4, 0.0, 0.3), 2.0)
    before = coherent.KERNEL_LAUNCHES["coherent"]
    k = renderer_fast.render_lambert_fast(scene, cam, 64, 32)
    assert coherent.KERNEL_LAUNCHES["coherent"] == before + 4
    p = renderer_fast.render_lambert_fast_plain(scene, cam, 64, 32)
    for f in ("depth", "normal", "material", "steps", "irradiance", "albedo"):
        assert torch.equal(k[f], p[f]), f
    assert float((k["image"] - p["image"]).abs().max()) <= 1.0 / 255


@pytest.mark.parametrize("shading", ["flat", "lambert", "raw", "trace"])
@pytest.mark.parametrize("sky_mode", ["analytic", "constant", "none"])
def test_indep_camera_kernel_matches_plain(cuda, shading, sky_mode):
    mv = mega.MegaVolume(VoxelVolume.noise_filled((40, 48, 56)), cuda)
    occb = indep.occb_of(mv.tables)
    cam = Camera.create((2.0, 1.4, -2.4), (0.0, 0.0, 0.0), 2.0)
    cam_p = mega.mega_camera(mv, cam, (-0.62, 0.47, -0.63), 96, 48,
                             sky_const=(0.1, 0.2, 0.3))
    kw = dict(width=96, height=48, sky_mode=sky_mode, shading=shading)
    before = indep.KERNEL_LAUNCHES["indep_camera"]
    rk, tk, ak = indep.render_indep_tiles(cam_p, occb, mv.tables, **kw)
    assert indep.KERNEL_LAUNCHES["indep_camera"] == before + 1
    rp, tp, ap = indep.render_indep_tiles_plain(cam_p, occb, mv.tables, **kw)
    assert torch.equal(ak, ap)
    assert torch.equal(tk < indep.BIG, tp < indep.BIG)
    assert float((tk - tp).abs().max()) <= 1e-5
    diff = (mega._unpack_rgb8(rk) - mega._unpack_rgb8(rp)).abs()
    assert int(diff.max()) <= 1


def test_indep_ray_kernel_matches_plain(cuda):
    mv = mega.MegaVolume(_sphere_volume(), cuda)
    occb = indep.occb_of(mv.tables)
    o, d = _local_rays(cuda, 8192, -0.5, 1.3, 1)
    before = indep.KERNEL_LAUNCHES["indep_rays"]
    k = indep.trace_rays_indep(o, d, occb, mv.tables)
    assert indep.KERNEL_LAUNCHES["indep_rays"] == before + 1
    p = indep.trace_rays_indep_plain(o, d, occb, mv.tables)
    _assert_trace_equal(k, p)
    assert bool(k["resolved"].all()) and bool((k["t"] < indep.BIG).any())


@pytest.mark.parametrize("volume", ["noise_128", "long_sparse"])
def test_indep_kernels_on_full_bitmap_and_long_walks(cuda, volume):
    """B3 and B4 on the largest volume indep takes (128^3 noise: 4096
    bricks, a full 128-word bitmap) and on `profiling.budget_scene`'s
    (16, 16, 4096) volume, whose rays walk hundreds of mostly empty bricks
    end to end: t and aux equal, image within 1 LSB, every ray resolved."""
    if volume == "noise_128":
        vol = VoxelVolume.noise_filled((128, 128, 128), vpu=40.0)
        cam = Camera.create((2.0, 1.4, -2.4), (0.0, 0.0, 0.0), 2.0)
        o, d = _local_rays(cuda, 8192, -1.0, 4.2, 4)
    else:
        g, o, d, vpu = profiling.budget_scene(length=4096, n_rays=8192)
        vol = VoxelVolume(g, pos=(0.0, 0.0, 0.0), vpu=vpu)
        cam = Camera.create((-258.0, 0.3, 0.2), (0.0, 0.0, 0.0), 2.0)
        o, d = torch.from_numpy(o).to(cuda), torch.from_numpy(d).to(cuda)
    mv = mega.MegaVolume(vol, cuda)
    occb = indep.occb_of(mv.tables)
    assert mv.tables.bocc.numel() == (4096 if volume == "noise_128" else 2048)
    cam_p = mega.mega_camera(mv, cam, (-0.62, 0.47, -0.63), 96, 48)
    kw = dict(width=96, height=48, shading="lambert")
    before = dict(indep.KERNEL_LAUNCHES)
    rk, tk, ak = indep.render_indep_tiles(cam_p, occb, mv.tables, **kw)
    k = indep.trace_rays_indep(o, d, occb, mv.tables)
    assert indep.KERNEL_LAUNCHES == {n: c + 1 for n, c in before.items()}
    rp, tp, ap = indep.render_indep_tiles_plain(cam_p, occb, mv.tables, **kw)
    p = indep.trace_rays_indep_plain(o, d, occb, mv.tables)
    assert torch.equal(ak, ap) and torch.equal(tk, tp)
    assert int((mega._unpack_rgb8(rk) - mega._unpack_rgb8(rp)).abs().max()) <= 1
    assert bool((((ak >> mega.AUX_RESOLVED_SHIFT) & 1) == 1).all())
    _assert_trace_equal(k, p)
    assert torch.equal(k["t"], p["t"])
    assert bool(k["resolved"].all()) and bool((k["t"] < indep.BIG).any())
    assert bool((tk < indep.BIG).any())
    if volume == "long_sparse":
        assert float(k["steps"].float().mean()) > 256     # walks, not budgets


def test_indep_kernel_rejects_bad_input(cuda):
    mv = mega.MegaVolume(VoxelVolume.noise_filled((136, 136, 136)), cuda)
    occb = torch.zeros(128, dtype=torch.int32, device=cuda)
    o = torch.zeros((4, 3), device=cuda)
    with pytest.raises(ValueError):        # 4913 bricks > 4096
        indep.trace_rays_indep(o, o, occb, mv.tables)
    mv = mega.MegaVolume(_sphere_volume(), cuda)
    with pytest.raises(ValueError):
        indep.trace_rays_indep(o, o, occb.cpu(), mv.tables)


# ---------------------------------------------------------------------------
# The full-material Whitted frame on B1 / B2
# ---------------------------------------------------------------------------

def _material_scene(device):
    """tests/test_whitted_mega.py's material scene with the port's own
    classes: floor, hollow glass box around a pillar, mirror slab, sphere
    light, procedural sky."""
    from voxel_tracer_tpu_torch.models.scene import Scene
    from voxel_tracer_tpu_torch.models.skydome import SkyDome
    n = 32
    g = np.zeros((n, n, n), np.uint8)
    g[:, 0:3, :] = 30
    g[10:24, 3:17, 4:16] = 3
    g[12:22, 5:15, 6:14] = 0
    g[14:20, 3:11, 8:12] = 40
    g[:, 3:20, 26:28] = 12
    pal = np.random.RandomState(7).rand(256, 3).astype(np.float32) * 0.8 + 0.1
    vol = VoxelVolume(g, palette=pal, vpu=20.0)
    scene = Scene(volumes=[vol], skydome=SkyDome.procedural(32, 16))
    scene.add_light((0.5, 1.2, -0.6), 0.08, (1.0, 0.9, 0.8), 6.0)
    return vol, scene.data(device)


@pytest.mark.parametrize("compact", [False, True])
def test_whitted_frame_kernel_equals_plain(cuda, compact):
    """Every trace of the frame on B1 / B2 vs the same frame traced by the
    plain versions: bit for bit, field for field."""
    from voxel_tracer_tpu_torch.ops.cuda.whitted import MegaIntersector, render_whitted_mega
    from voxel_tracer_tpu_torch.renderer import RenderConfig
    vol, sd = _material_scene(cuda)
    mv = mega.MegaVolume(vol, cuda)
    w, h = 96, 64
    cfg = RenderConfig(width=w, height=h, shading="full", max_bounces=3,
                       glass_reflections=2, compact=compact)
    cam = Camera.create((1.1, 0.9, -1.5), (0.0, 0.3, 0.0), w / h)
    before = dict(mega.KERNEL_LAUNCHES)
    k = render_whitted_mega(MegaIntersector(mv, shadow_rounds=2, compact=compact),
                            sd, cam, w, h, 5, config=cfg)
    assert mega.KERNEL_LAUNCHES["mega_camera"] == before["mega_camera"] + 1
    assert mega.KERNEL_LAUNCHES["mega_rays"] > before["mega_rays"] + 10
    plain = MegaIntersector(mv, shadow_rounds=2, compact=compact,
                            trace_fn=mega.trace_rays_plain,
                            tiles_fn=mega.render_mega_tiles_plain)
    p = render_whitted_mega(plain, sd, cam, w, h, 5, config=cfg)
    torch.cuda.synchronize()
    for f in k:
        assert torch.equal(k[f], p[f]), f
    mats = k["material"]
    assert bool(((mats >= 1) & (mats <= 8)).any()) and bool(((mats >= 9) & (mats <= 16)).any())


def test_inverted_table_kernel_matches_plain(cuda):
    """B2 on the inverted tables of a glass id (occupied = voxel != 4,
    materials of the grid) on a 36x20x28 grid whose glass touches the far
    faces."""
    g = np.zeros((36, 20, 28), np.uint8)
    g[6:, 4:, 9:] = 4
    g[14:20, 8:12, 14:18] = 40
    g[24:30, 6:9, 20:24] = 12
    tb = mega.pack_tables(g, np.ones((256, 3), np.float32), 20.0, cuda, occupied=g != 4)
    rng = np.random.RandomState(3)
    n = 16384
    o = rng.uniform(-0.1, 1.9, (n, 3)).astype(np.float32)
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o_t, d_t = torch.from_numpy(o).to(cuda), torch.from_numpy(d).to(cuda)
    k = mega.trace_rays(o_t, d_t, tb, fetch_mat=True)
    p = mega.trace_rays_plain(o_t, d_t, tb, fetch_mat=True)
    torch.cuda.synchronize()
    for f in ("t", "mat", "ax", "steps", "resolved"):
        assert torch.equal(k[f], p[f]), f
    hit = k["t"] < mega.BIG
    assert bool(hit.any()) and bool((k["mat"][hit] == 0).any())      # air exits


def test_lambert_mega_prev_accu_kernel_matches_plain(cuda):
    vol = VoxelVolume.noise_filled((40, 48, 56))
    mv = mega.MegaVolume(vol, cuda)
    w, h = 96, 48
    from voxel_tracer_tpu_torch.renderer import empty_accu
    accu, planes = empty_accu(w, h, cuda), None
    for pos in ((2.0, 1.4, -2.4), (2.02, 1.4, -2.38)):
        cam = Camera.create(pos, (0.0, 0.0, 0.0), w / h)
        planes = cam.planes if planes is None else planes
        kw = dict(prev_accu=accu, prev_planes=planes, depth_delta=0.01)
        k = mega.render_lambert_mega(mv, cam, w, h, **kw)
        p = mega.render_lambert_mega_plain(mv, cam, w, h, **kw)
        torch.cuda.synchronize()
        for f in ("depth", "normal", "material", "steps"):
            assert torch.equal(k[f], p[f]), f
        for f in ("irradiance", "accu"):
            assert float((k[f] - p[f]).abs().max()) <= 1e-5, f
        accu, planes = k["accu"], cam.planes


def test_set_voxel_tables_on_the_card(cuda):
    """O(1) edits of the device tables (full and inverted) against a
    repack on the card, bit 31 of a word and of the bitmap included."""
    from voxel_tracer_tpu_torch.ops.cuda.whitted import MegaIntersector
    g = np.zeros((20, 28, 36), np.uint8)
    g[2:18, 3:20, 4:30] = 4
    g[5:9, 5:9, 5:9] = 40
    vol = VoxelVolume(g, vpu=20.0)
    isect = MegaIntersector(mega.MegaVolume(vol, cuda))
    rng = np.random.RandomState(3)
    for _ in range(300):
        isect.set_voxel(int(rng.randint(36)), int(rng.randint(28)), int(rng.randint(20)),
                        int(rng.choice([0, 4, 40, 12])))
    for z in range(8, 16):                         # brick 31 = (bx, by, bz) = (1, 2, 1)...
        for y in range(16, 24):
            for x in range(8, 16):
                isect.set_voxel(x, y, z, 0)
    isect.set_voxel(15, 19, 8, 41)                 # ...voxel index 31 of it
    torch.cuda.synchronize()
    fresh = MegaIntersector(mega.MegaVolume(VoxelVolume(vol.grid.copy(), vol.palette), cuda))
    pairs = [(isect.full_tables, fresh.full_tables)]
    pairs += [(isect.inv_tables[i], fresh.inv_tables[i]) for i in fresh.glass_ids]
    for a, b in pairs:
        for f in ("bocc", "bitmap", "occw", "matb", "grid", "brick_occ"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert torch.equal(isect.grid_dda, fresh.grid_dda)


def test_multi_frame_kernel_equals_plain(cuda):
    """The default scene's frame on B2 (five volumes, drones turned, one
    laser capsule) vs the same frame traced by B2's plain version, at
    128x96: bit for bit, field for field."""
    from voxel_tracer_tpu_torch.game.enemy import _yaw_matrix
    from voxel_tracer_tpu_torch.models.camera import Camera
    from voxel_tracer_tpu_torch.ops.cuda.multi import (MultiMegaIntersector, make_drone_scene,
                                                       render_whitted_multi)
    from voxel_tracer_tpu_torch.ops.cuda.whitted import MegaIntersector
    from voxel_tracer_tpu_torch.renderer import RenderConfig
    vols, scene = make_drone_scene(asset_dir=None)
    for i, v in enumerate(vols[1:]):
        v.set_rotation(_yaw_matrix(0.4 + 0.9 * i))
    scene.add_capsule((2.6, 2.9, -2.2), tuple(vols[2].pos), 0.02)
    sd = scene.data(cuda)
    mvs = [mega.MegaVolume(v, cuda) for v in vols]
    w, h = 128, 96
    cfg = RenderConfig(width=w, height=h, shading="full", max_bounces=2, glass_reflections=2,
                       compact=True)
    cam = Camera.create((5.0, 2.8, 2.5), (1.0, 0.8, -1.5), w / h)

    def frame(**kw):
        m = MultiMegaIntersector([MegaIntersector(mv, shadow_rounds=2, compact=True, **kw)
                                  for mv in mvs])
        return render_whitted_multi(m, sd, cam, w, h, 3, config=cfg)

    before = mega.KERNEL_LAUNCHES["mega_rays"]
    k = frame()
    assert mega.KERNEL_LAUNCHES["mega_rays"] > before + 10
    p = frame(trace_fn=mega.trace_rays_plain)
    torch.cuda.synchronize()
    for f in k:
        assert torch.equal(k[f], p[f]), f
    mats = k["material"]
    assert bool(((mats >= 1) & (mats <= 8)).any()) and bool(((mats >= 17) & (mats <= 48)).any())


def test_ray_kernel_zero_direction_rays(cuda):
    """Zero directions (refract's total internal reflection hands them to
    the tracer; the default scene's frame traces some) enter the slab test
    at t = inf and stop at a cell with t = inf: a miss whose axis word is
    the entry axis's, as in the plain version; +-0 components, origins
    inside and around the grid."""
    g = np.zeros((16, 16, 16), np.uint8)
    g[4:12, 6:10, 4:12] = 17
    tb = mega.pack_tables(g, np.ones((256, 3), np.float32), 20.0, cuda)
    rng = np.random.RandomState(4)
    n = 4096
    o = rng.uniform(-1.0, 1.8, (n, 3)).astype(np.float32)
    d = np.where(rng.rand(n, 3) < 0.5, -0.0, 0.0).astype(np.float32)
    o_t, d_t = torch.from_numpy(o).to(cuda), torch.from_numpy(d).to(cuda)
    k = mega.trace_rays(o_t, d_t, tb, fetch_mat=True)
    p = mega.trace_rays_plain(o_t, d_t, tb, fetch_mat=True)
    torch.cuda.synchronize()
    for f in ("t", "mat", "ax", "steps", "resolved"):
        assert torch.equal(k[f], p[f]), f
    # rays starting in a solid voxel hit at t = 0; others stop at t = inf
    assert bool(((k["t"] >= mega.BIG) & (k["mat"] != 0)).any())


def _dda_case(mode, dev):
    """(grid, brick_occ, origins, dirs, vpu, keywords) of one D1 mode on a
    36x20x28 grid (cut bricks) of glass (4), a pillar (40) and a mirror
    (12), or three stacked 32^3 grids with oid and a per-ray vpu."""
    from voxel_tracer_tpu_torch.models.volume import compute_brick_occ
    rng = np.random.RandomState(12)
    n = 8192

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:n // 16] = 0.0
    d[np.arange(n // 16), rng.randint(0, 3, n // 16)] = 1.0
    if mode == "zero_dirs":
        d = np.where(rng.rand(n, 3) < 0.5, -0.0, 0.0).astype(np.float32)
    if mode.startswith("stacked"):
        grids = [VoxelVolume.noise_filled((32, 32, 32)).grid,
                 _sphere_volume().grid.repeat(2, 0).repeat(2, 1).repeat(2, 2),
                 VoxelVolume.noise_filled((32, 32, 32), threshold=0.3, material=4).grid]
        vpus = np.array([20.0, 16.0, 25.0], np.float32)
        oid = rng.randint(0, 3, n)
        o = (rng.uniform(-0.3, 1.3, (n, 3)) * (32.0 / vpus[oid])[:, None]).astype(np.float32)
        kw = dict(oid=t(oid))
        if mode == "stacked_medium":
            kw["medium"] = t(np.where(rng.rand(n) < 0.5, 4, 0).astype(np.int32))
        return (t(np.stack(grids).astype(np.int32)),
                t(np.stack([compute_brick_occ(g) for g in grids])), t(o), t(d),
                t(vpus[oid]), kw)
    g = np.zeros((36, 20, 28), np.uint8)
    g[6:, 4:, 9:] = 4
    g[14:20, 8:12, 14:18] = 40
    g[24:30, 6:9, 20:24] = 12
    o = rng.uniform(-0.1, 1.9, (n, 3)).astype(np.float32)
    kw = {}
    if mode in ("medium", "medium_budget"):
        kw["medium"] = t(np.where(rng.rand(n) < 0.5, 4, 0).astype(np.int32))
        if mode == "medium_budget":
            kw["max_steps"] = 6
    elif mode == "ignore":
        kw["ignore"] = t(np.where(rng.rand(n) < 0.75, 4, 0).astype(np.int32))
    elif mode == "shadow":
        seed = rng.randint(0, 2 ** 32, n, dtype=np.uint64)
        seed[:n // 4] |= np.uint64(1 << 31)
        kw.update(shadow=True, shadow_seed=t(seed.astype(np.int64)))
    return t(g.astype(np.int32)), t(compute_brick_occ(g)), t(o), t(d), 20.0, kw


@pytest.mark.parametrize("mode", ["first_hit", "medium", "medium_budget", "ignore", "shadow",
                                  "stacked", "stacked_medium", "zero_dirs"])
def test_dda_kernel_matches_plain(cuda, mode):
    grid, bocc, o, d, vpu, kw = _dda_case(mode, cuda)
    before = dda_kernel.KERNEL_LAUNCHES["dda"]
    k = dda_kernel.intersect_volume_local(grid, bocc, o, d, vpu, **kw)
    assert dda_kernel.KERNEL_LAUNCHES["dda"] == before + 1
    p = dda.intersect_volume_local(grid, bocc, o, d, vpu, **kw)
    torch.cuda.synchronize()
    assert k.keys() == p.keys()
    for f in k:
        assert torch.equal(k[f], p[f]), f
    if mode != "zero_dirs":
        assert bool((k["t"] < 1e30).any())
    if mode == "medium_budget":
        assert bool((~k["resolved"]).any())


def test_dda_kernel_empty_list_and_bad_input(cuda):
    grid, bocc, o, d, vpu, _kw = _dda_case("first_hit", cuda)
    before = dda_kernel.KERNEL_LAUNCHES["dda"]
    e = dda_kernel.intersect_volume_local(grid, bocc, o[:0], d[:0], vpu)
    assert e["t"].shape == (0,) and e["step_sign"].shape == (0, 3)
    assert dda_kernel.KERNEL_LAUNCHES["dda"] == before
    with pytest.raises(TypeError):
        dda_kernel.intersect_volume_local(grid, bocc, o.double(), d, vpu)
    with pytest.raises(ValueError):
        dda_kernel.intersect_volume_local(grid, bocc[:-1], o, d, vpu)
    with pytest.raises(ValueError):
        dda_kernel.intersect_volume_local(grid, bocc, o, d, vpu, shadow=True)
    with pytest.raises(ValueError):
        dda_kernel.intersect_volume_local(grid, bocc, o, d, torch.ones(5, device=cuda))


# ---------------------------------------------------------------------------
# D2 / D3: the differentiable march (ops/cuda/diff.py) against the plain
# march (ops/diff.py): color, trans and depth within 1e-6 (the same float32
# program; expf may differ in the last bit) and NaN on the same rays (the
# depth of a ray whose set-up leaves t_exit or a first crossing at -inf);
# d sigma and d albedo within 1e-4 x max|g| (atomics and index_add_ sum in
# run-dependent orders), d sigma exactly 0 where sigma is 0
# ---------------------------------------------------------------------------

def _march_scene(kind, dev):
    """(sigma, albedo, origins, dirs, vpu) on ``dev``: tests/test_torch_diff.py's
    edge scene (16^3, a fan of 256 rays, axis-parallel rays with +-0
    components and two misses) or a 32^3 random field (a third of sigma 0,
    albedo with negative entries) with 4096 rays from all sides."""
    if kind == "edge":
        rng = np.random.default_rng(0)
        sigma = rng.uniform(0, 8.0, (16, 16, 16)).astype(np.float32)
        albedo = rng.uniform(0, 1, (16, 16, 16, 3)).astype(np.float32)
        yy, zz = np.meshgrid(np.linspace(0.2, 1.4, 16), np.linspace(0.2, 1.4, 16))
        tgt = np.stack([np.full(yy.size, 1.6), yy.ravel(), zz.ravel()], -1)
        o = np.tile(np.array([-0.9, 0.8, 0.8]), (tgt.shape[0], 1))
        d = tgt - o
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        o = np.concatenate([o, [[0.55, 0.85, -0.5], [-0.5, 0.3, 0.7],
                                [3.0, 3.0, 3.0], [-1.0, -1.0, -1.0]]]).astype(np.float32)
        d = np.concatenate([d, [[-0.0, 0.0, 1.0], [1.0, -0.0, 0.0],
                                [1.0, 0.0, 0.0], [0.0, 0.0, -1.0]]]).astype(np.float32)
        o, d, vpu = torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev), 10.0
    else:
        rng = np.random.RandomState(8)
        g = 32
        sigma = np.where(rng.rand(g, g, g) < 0.35, 0.0, rng.rand(g, g, g) * 12.0)
        albedo = rng.uniform(-0.3, 1.0, (g, g, g, 3))
        (o, d), vpu = _mixed_rays(dev), float(g)
    sigma, albedo = (torch.tensor(x, dtype=torch.float32, device=dev) for x in (sigma, albedo))
    return sigma, albedo, o, d, vpu


@pytest.mark.parametrize("scene", ["edge", "random"])
def test_march_kernels_match_plain(cuda, scene):
    from voxel_tracer_tpu_torch.ops import diff
    from voxel_tracer_tpu_torch.ops.cuda import diff as diff_kernel
    sigma, albedo, o, d, vpu = _march_scene(scene, cuda)
    n = o.shape[0]
    rng = np.random.RandomState(3)
    cts = tuple(torch.from_numpy(rng.randn(*s).astype(np.float32)).to(cuda)
                for s in ((n, 3), (n,), (n,)))
    res = []
    for fn in (diff_kernel.render_density, diff.render_density):
        s, a = sigma.clone().requires_grad_(), albedo.clone().requires_grad_()
        before = dict(diff_kernel.KERNEL_LAUNCHES)
        out = fn(s, a, o, d, vpu, 192)
        outs = (out["color"], out["trans"], out["depth"])
        torch.autograd.backward(outs, cts)
        torch.cuda.synchronize()
        launched = {k: v - before[k] for k, v in diff_kernel.KERNEL_LAUNCHES.items()}
        res.append(([x.detach() for x in outs], s.grad, a.grad, launched))
    (ok, sk, ak, lk), (op, sp, ap, lp) = res
    assert lk == {"diff_fwd": 1, "diff_bwd": 1} and lp == {"diff_fwd": 0, "diff_bwd": 0}
    for k, p in zip(ok, op):
        assert torch.equal(torch.isnan(k), torch.isnan(p))
        fin = ~torch.isnan(p)
        assert float((k[fin] - p[fin]).abs().max()) <= 1e-6
    assert bool((op[1] < 1).any())
    for x, y in ((sk, sp), (ak, ap)):
        assert float((x - y).abs().max()) <= 1e-4 * float(y.abs().max())
    assert not bool(sk[sigma == 0].any()) and not bool(sp[sigma == 0].any())


def test_march_kernels_empty_list_and_bad_input(cuda):
    from voxel_tracer_tpu_torch.ops.cuda import diff as diff_kernel
    sigma, albedo, o, d, vpu = _march_scene("random", cuda)
    before = dict(diff_kernel.KERNEL_LAUNCHES)
    e = diff_kernel.render_density(sigma, albedo, o[:0], d[:0], vpu)
    assert e["color"].shape == (0, 3) and e["trans"].shape == (0,)
    assert diff_kernel.KERNEL_LAUNCHES == before
    with pytest.raises(TypeError):
        diff_kernel.render_density(sigma, albedo, o.double(), d, vpu)
    with pytest.raises(ValueError):
        diff_kernel.render_density(sigma.cpu(), albedo, o, d, vpu)
    with pytest.raises(ValueError):
        diff_kernel.render_density(sigma, albedo[..., :2], o, d, vpu)
    c, t, dp = diff_kernel.march_fwd(sigma, albedo, o, d, vpu, 64)
    with pytest.raises(ValueError):
        diff_kernel.march_bwd(sigma, albedo, o, d, vpu, 64, c, t, dp, c[:, 0], t, dp)
    assert diff_kernel.KERNEL_LAUNCHES["diff_bwd"] == before["diff_bwd"]
