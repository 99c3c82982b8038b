"""The game scene's multi-object path on the card: the composite kernels
(`ops/cuda/composite.py`, C1) with a per-ray object over a stacked group
of turned volumes, each with its own palette, against their plain glue,
and the moving frame of the cell `drone_scene_720p.game`.

Marked `cuda`: each test skips when no CUDA device is present (decided in
the test, never at import).  Run on a machine with an NVIDIA GPU:

    python -m pytest --noconftest -q -p no:cacheprovider tests/test_torch_game_cuda.py

- `to_local` and `record` (written fresh, merged nearer with and without
  a candidate's ``live``, the interior march's select over global object
  indices) on the drone group moved by `SceneData.with_transforms`, D1's
  own outputs between them, bit for bit against `_local_rays` / `_record`;
- the cell's frame (1280x720, 8 bounces, 8 glass reflections) on the
  kernels against the same frame on the glue, every output field equal;
- a moved frame equal to the frame of the host scene moved and uploaded
  anew, with no D1 table derived and no synchronize in the update.
"""

import warnings
from functools import partial
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from test_torch_composite_glue import assert_same
from test_torch_game_scene import CELL_CONFIG, _moved_host, game_scene, moves

from port_bench.scenes import drone_scene

from voxel_tracer_tpu_torch.models.camera import Camera
from voxel_tracer_tpu_torch.ops import composite
from voxel_tracer_tpu_torch.ops.cuda import composite as kernels
from voxel_tracer_tpu_torch.ops.cuda import dda as dda_kernel
from voxel_tracer_tpu_torch.renderer import RenderConfig, Renderer

pytestmark = pytest.mark.cuda

GLUE = SimpleNamespace(**{f.__name__: partial(f, dda_fn=dda_kernel.intersect_volume_local)
                          for f in (composite.intersect_scene, composite.intersect_group,
                                    composite.march_interior, composite.is_occluded)})
SEED = 2 ** 31 + 3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _moved(cuda, j=7):
    raw, host, sd, drones = game_scene(SEED, cuda, CELL_CONFIG)
    tr = moves(raw, j)
    return raw, host, sd.with_transforms(dict(zip(drones, tr))), drones, tr


def _rays(raw, n, cuda, seed):
    """Rays from around the drones' flight toward points near them."""
    rng = np.random.RandomState(seed)
    c = np.float32(drone_scene.BOX_POS) + np.float32([0, 1.0, 0])
    o = c + rng.uniform(-3.0, 3.0, (n, 3)).astype(np.float32)
    d = c + rng.uniform(-1.6, 1.6, (n, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[::17, 1] = 0.0
    return torch.from_numpy(o).to(cuda), torch.from_numpy(d.astype(np.float32)).to(cuda)


@pytest.mark.parametrize("n", [1, 4099, 300_001])
def test_per_ray_objects_over_turned_volumes_match_the_glue(cuda, n):
    raw, _host, sd, _drones, _tr = _moved(cuda)
    group = next(g for g in sd.groups if g.grid.shape[0] == 4)
    assert len({g.tobytes() for g in group.palette.cpu().numpy()}) == 4
    assert not torch.equal(group.rot[0], torch.eye(3, device=cuda))
    o, d = _rays(raw, n, cuda, n)
    g = torch.Generator().manual_seed(n)
    oid = torch.randint(0, 4, (n,), generator=g).to(cuda)
    live = (torch.rand(n, generator=g) < 0.7).to(cuda)
    out = kernels.to_local(group, o, d, oid=oid)
    ref = composite._local_rays(group, o, d, oid=oid)
    assert_same(out[:3], ref[:3], "to_local")
    res = dda_kernel.intersect_volume_local(group.grid, group.brick_occ, ref[0], ref[1],
                                            ref[2], oid=oid)
    if n > 1000:
        assert (res["t"] < 1e30).sum() > n // 50        # the rays meet the drones
    first = composite._record(group, res, None, oid=oid, obj_base=0)
    assert_same(kernels.record(group, res, None, oid=oid, obj_base=0), first, "fresh")
    for lv in (None, live):
        res2 = dda_kernel.intersect_volume_local(
            group.grid, group.brick_occ, *composite._local_rays(group, o, d, oid=oid.flip(0))[:3],
            oid=oid.flip(0))
        want = composite._record(group, res2, first, oid=oid.flip(0), live=lv)
        got = kernels.record(group, res2, composite.HitResult(*(x.clone() for x in first)),
                             oid=oid.flip(0), live=lv)
        assert_same(got, want, "nearer" if lv is None else "nearer_live")
    obj = torch.randint(-1, 6, (n,), generator=g, dtype=torch.int32).to(cuda)
    lo = kernels.to_local(group, o * 0.1, d, obj=obj, obj_base=0)
    lr = composite._local_rays(group, o * 0.1, d, obj=obj, obj_base=0)
    assert_same(lo[:3], lr[:3], "to_local obj")
    assert torch.equal(lo[3], lr[3])
    res3 = dda_kernel.intersect_volume_local(group.grid, group.brick_occ, *lr[:3], oid=lr[3],
                                             medium=4)
    assert_same(kernels.record(group, res3, None, obj=obj, obj_base=0, select=True),
                composite._record(group, res3, None, obj=obj, obj_base=0, select=True),
                "select")


def _frame(sd, raw, j, cfg, cuda, isect=composite):
    pos, target = drone_scene.pose(raw, j, 63, 3.2, 1.2)
    cam = Camera.create(pos, target, cfg["width"] / cfg["height"])
    return Renderer(RenderConfig(**cfg), device=cuda, isect=isect).render(sd, cam, frame=j)


@pytest.mark.parametrize("shading", ["full", "flat"])
def test_game_frame_matches_the_glue(cuda, shading):
    raw, _host, sd, _drones, _tr = _moved(cuda)
    cfg = {**CELL_CONFIG["render"], "shading": shading}
    kernels.reset_launch_counts()
    out = _frame(sd, raw, 7, cfg, cuda)
    calls = kernels.KERNEL_LAUNCHES["composite_fused"]
    assert calls >= 1 and kernels.KERNEL_LAUNCHES["composite_glue"] == 0
    ref = _frame(sd, raw, 7, cfg, cuda, isect=GLUE)
    assert kernels.KERNEL_LAUNCHES["composite_glue"] == calls
    assert set(out) == set(ref)
    for k in out:
        if isinstance(out[k], torch.Tensor):
            assert_same(out[k], ref[k], k)
    seen = set(out["material"].unique().tolist())
    assert {17, 25} <= seen


def test_moved_frames_keep_d1s_tables_and_never_sync(cuda):
    """No update synchronizes (PyTorch's sync debug mode), no moved frame
    derives D1's tables, and a moved frame equals the frame of the host
    scene moved and uploaded anew."""
    raw, host, sd, drones = game_scene(SEED, cuda, CELL_CONFIG)
    cfg = {**CELL_CONFIG["render"], "width": 640, "height": 360}
    first = dda_kernel.KERNEL_LAUNCHES["dda_tables"]
    # a view with glass, so the glass march's call on the box's stacked grid runs too
    _frame(sd.with_transforms(dict(zip(drones, moves(raw, 21)))), raw, 21, cfg, cuda)
    before = dda_kernel.KERNEL_LAUNCHES["dda_tables"]
    assert before > first
    for j in (1, 2, 3):
        given = dict(zip(drones, moves(raw, j)))
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode(1)
            try:
                moved = sd.with_transforms(given)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        syncs = [str(w.message) for w in caught
                 if "called a synchronizing CUDA operation" in str(w.message)]
        assert not syncs, syncs
        out = _frame(moved, raw, j, cfg, cuda)
    assert dda_kernel.KERNEL_LAUNCHES["dda_tables"] == before
    want = _frame(_moved_host(host, drones, moves(raw, 3), cuda), raw, 3, cfg, cuda)
    for k in out:
        if isinstance(out[k], torch.Tensor):
            assert_same(out[k], want[k], k)
