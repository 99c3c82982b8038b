"""The CUDA kernels of the port vs their plain PyTorch versions, on the card.

Marked `cuda`: each test skips when no CUDA device is present (decided in
the test, never at import).  Run on a machine with an NVIDIA GPU:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerances: mega kernels: hits, materials, axes, steps and resolved flags
equal; depth within 1e-5; image within 1 LSB (expf may differ by an ulp).
Integrate kernels (record layout): flags equal; color, trans and depth
within 1e-5 (expf may differ by an ulp); each gradient column within
1e-4 x its max|g| (the kernel's vector reductions and `index_add_` sum in
orders that change from run to run, most where many rays update one
voxel), and exactly 0 in empty bricks and, for d sigma, where sigma is 0.
Coherent (B5) and indep (B3, B4) kernels: the same float32 program as the
plain versions, so hits, voxel/material, axes, steps and resolved flags
equal; t within 1e-5; image within 1 LSB (expf in the sky).
"""

import numpy as np
import pytest
import torch

from voxel_tracer_tpu_torch.models.camera import Camera
from voxel_tracer_tpu_torch.models.volume import VoxelVolume
from voxel_tracer_tpu_torch.ops.cuda import (coherent, diffint, indep,
                                             integrate, mega, renderer_fast)

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


def test_indep_kernel_rejects_bad_input(cuda):
    mv = mega.MegaVolume(VoxelVolume.noise_filled((136, 136, 136)), cuda)
    occb = torch.zeros(128, dtype=torch.int32, device=cuda)
    o = torch.zeros((4, 3), device=cuda)
    with pytest.raises(ValueError):        # 4913 bricks > 4096
        indep.trace_rays_indep(o, o, occb, mv.tables)
    mv = mega.MegaVolume(_sphere_volume(), cuda)
    with pytest.raises(ValueError):
        indep.trace_rays_indep(o, o, occb.cpu(), mv.tables)
