"""The CUDA kernel of the port vs its plain PyTorch version, on the card.

Marked `cuda`: each test skips when no CUDA device is present (decided in
the test, never at import).  Run on a machine with an NVIDIA GPU:

    python -m pytest tests/test_torch_cuda.py -q

Tolerances: hits, materials, axes, steps and resolved flags equal; depth
within 1e-5; image within 1 LSB (expf may differ by an ulp).
"""

import numpy as np
import pytest
import torch

from voxel_tracer_tpu_torch.models.camera import Camera
from voxel_tracer_tpu_torch.models.volume import VoxelVolume
from voxel_tracer_tpu_torch.ops.cuda import mega

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
