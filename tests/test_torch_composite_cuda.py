"""The composite kernels (`ops/cuda/composite.py`, `csrc/composite.cu`)
against their plain version, the glue of `ops/composite.py`, on the card.

Marked `cuda`: each test skips when no CUDA device is present (decided in
the test, never at import).  Run on a machine with an NVIDIA GPU:

    python -m pytest --noconftest -q -p no:cacheprovider tests/test_torch_composite_cuda.py

Both sides run D1: the glue is selected by passing D1's wrapper as
``dda_fn``.  Every output is compared bit for bit (float32 as int32
bits; NaN on the same entries with the same bits), since the kernels keep
the glue's float program and stochastic shadows key on the hit cell:

- `to_local` and `record` alone on synthetic inputs: a scalar object, a
  per-ray oid over a stacked group (O = 3), the interior march's obj
  (rows outside the group among them); write (fresh), nearer with and
  without `live`, select fresh and in place; t at 1e30, inf and NaN;
  broadcast and non-contiguous rays; N = 0, 1 and N not a multiple of
  the block;
- every traversal site (primary, scan with `ignore`, shadow and
  `is_occluded` with `shadow_seed`, `march_interior`, `intersect_group`,
  the grid-sharded trace's call) on one volume, a
  stacked group beside a single volume in either order, and primitives,
  with rays that miss and zero and NaN direction components;
- torch.sum's order over a 3-vector on the card, which the normal's
  length follows;
- the benchmark's glass-box frame (`port_bench/configs/glass_box_720p.json`,
  1280x720, 8 bounces, 8 glass reflections) in full and flat shading, and
  compacted, every output field equal, each traversal on the kernels.
"""

import json
from functools import partial
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from test_torch_composite_glue import SCENES, SITES, assert_same, scene_data, site_args

from voxel_tracer_tpu_torch.ops import composite
from voxel_tracer_tpu_torch.ops.cuda import composite as kernels
from voxel_tracer_tpu_torch.ops.cuda import dda as dda_kernel

pytestmark = pytest.mark.cuda

GLUE = SimpleNamespace(**{f.__name__: partial(f, dda_fn=dda_kernel.intersect_volume_local)
                          for f in (composite.intersect_scene, composite.intersect_group,
                                    composite.march_interior, composite.is_occluded)})


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_sum_of_three_squares_order(cuda):
    """torch.sum over a contiguous 3-vector on the card is (a0 + a2) + a1:
    two threads split the reduction, the first adding elements 0 and 2."""
    g = torch.Generator().manual_seed(0)
    x = (torch.randn(200_003, 3, generator=g) * torch.rand(200_003, 1, generator=g)).to(cuda)
    sq = x * x
    s = torch.sum(sq, dim=-1)
    assert_same(s, (sq[:, 0] + sq[:, 2]) + sq[:, 1])
    assert not torch.equal(s, (sq[:, 0] + sq[:, 1]) + sq[:, 2])   # the order shows


def _group(kind, cuda):
    sd = scene_data("stacked_first", cuda)
    return sd.groups[0 if kind == "stacked" else 1]


def _d1_like(n, cuda, seed):
    """Synthetic D1 outputs: hits, misses at 1e30, t at inf and NaN, every
    axis, step signs of either sign."""
    g = torch.Generator().manual_seed(seed)
    t = torch.rand(n, generator=g) * 3
    pick = torch.randint(0, 8, (n,), generator=g)
    t = torch.where(pick == 0, torch.tensor(1e30), t)
    t = torch.where(pick == 1, torch.tensor(float("inf")), t)
    t = torch.where(pick == 2, torch.tensor(float("nan")), t)
    t = torch.where(pick == 3, torch.tensor(1e30), t)
    return {"t": t.to(cuda),
            "mat": torch.randint(-3, 300, (n,), generator=g, dtype=torch.int32).to(cuda),
            "axis": torch.randint(0, 3, (n,), generator=g, dtype=torch.int32).to(cuda),
            "step_sign": (torch.randint(0, 2, (n, 3), generator=g) * 2 - 1).float().to(cuda),
            "steps": torch.randint(0, 40, (n,), generator=g, dtype=torch.int32).to(cuda)}


def _objects(kind, group, n, cuda, seed):
    g = torch.Generator().manual_seed(seed + 1)
    count = group.grid.shape[0]
    if kind == "scalar":
        return {"oid": count - 1}
    if kind == "oid":
        return {"oid": torch.randint(0, count, (n,), generator=g).to(cuda)}
    return {"obj": torch.randint(-2, count + 3, (n,), generator=g,
                                 dtype=torch.int32).to(cuda), "obj_base": 1}


@pytest.mark.parametrize("n", [0, 1, 1000, 65_613])
@pytest.mark.parametrize("objs", ["scalar", "oid", "obj"])
@pytest.mark.parametrize("group_kind", ["stacked", "single"])
def test_to_local_matches_plain(cuda, n, objs, group_kind):
    group = _group(group_kind, cuda)
    g = torch.Generator().manual_seed(n)
    o = (torch.randn(n, 3, generator=g) * 2).to(cuda)
    d = torch.randn(n, 3, generator=g).to(cuda)
    d[::5, 1] = 0.0
    d[::9, 2] = float("nan")
    kw = _objects(objs, group, n, cuda, n)
    for dirs in (d, torch.randn(3, generator=g).to(cuda).expand(n, 3),
                 torch.randn(3, n, generator=g).to(cuda).T):
        out = kernels.to_local(group, o, dirs, **kw)
        ref = composite._local_rays(group, o, dirs, **kw)
        assert_same(out[:3], ref[:3], "to_local")
        if isinstance(ref[3], torch.Tensor):
            assert torch.equal(out[3], ref[3])
        else:
            assert out[3] == ref[3]


MODES = [(mode, objs) for mode in ("write", "nearer", "nearer_live", "fresh_live")
         for objs in ("scalar", "oid")] + [("select", "obj"), ("select_fresh", "obj")]


@pytest.mark.parametrize("n", [0, 1, 1000, 65_613])
@pytest.mark.parametrize("mode,objs", MODES)
def test_record_matches_plain(cuda, n, mode, objs):
    group = _group("stacked", cuda)
    select = mode.startswith("select")
    kw = _objects(objs, group, n, cuda, n)
    res = _d1_like(n, cuda, seed=n + 1)
    live = None
    if "live" in mode:
        live = torch.rand(n, generator=torch.Generator().manual_seed(n)).to(cuda) < 0.6
    best = None
    if mode in ("nearer", "nearer_live", "select"):
        prev = _d1_like(n, cuda, seed=n + 2)
        best = composite._record(group, prev, None, oid=0)
    ref = composite._record(group, res, best, live=live, select=select, **kw)
    copy = None if best is None else composite.HitResult(*(x.clone() for x in best))
    out = kernels.record(group, res, copy, live=live, select=select, **kw)
    assert_same(out, ref, mode)
    if copy is not None:
        assert out.t.data_ptr() == copy.t.data_ptr()      # merged in place


@pytest.mark.parametrize("site", SITES)
@pytest.mark.parametrize("scene", SCENES)
@pytest.mark.parametrize("n", [0, 70_001])
def test_traversal_sites_match_the_glue(cuda, scene, site, n):
    sd = scene_data(scene, cuda)
    fn, args, kw = site_args(site, sd, seed=SITES.index(site), n=n, device=cuda)
    kernels.reset_launch_counts()
    out = fn(*args, **kw)
    assert kernels.KERNEL_LAUNCHES["composite_fused"] == 1
    assert kernels.KERNEL_LAUNCHES["composite_glue"] == 0
    ref = getattr(GLUE, fn.__name__)(*args, **kw)
    assert kernels.KERNEL_LAUNCHES["composite_glue"] == 1
    assert_same(out, ref, site)


def _glass_box(cuda):
    from port_bench.scenes import glass_box

    from voxel_tracer_tpu_torch.models.scene import Scene
    from voxel_tracer_tpu_torch.models.skydome import SkyDome
    from voxel_tracer_tpu_torch.models.volume import VoxelVolume

    root = Path(__file__).resolve().parents[1]
    config = json.loads((root / "port_bench" / "configs" / "glass_box_720p.json").read_text())
    raw = glass_box.build(config, 12345)
    scene = Scene(volumes=[VoxelVolume(raw["grid"], raw["palette"], pos=raw["pos"],
                                       vpu=raw["vpu"])],
                  skydome=SkyDome(raw["sky"]),
                  sun_dir=np.asarray(raw["sun_dir"], np.float32),
                  sun_light=np.asarray(raw["sun_light"], np.float32))
    for light in raw["lights"]:
        scene.add_light(*light)
    return config, raw, glass_box, scene.data(cuda)


@pytest.mark.parametrize("variant", ["full", "flat", "full_compact"])
def test_glass_box_frame_matches_the_glue(cuda, variant):
    from voxel_tracer_tpu_torch.models.camera import Camera
    from voxel_tracer_tpu_torch.renderer import RenderConfig, Renderer

    config, raw, glass_box, sd = _glass_box(cuda)
    cfg = dict(config["render"])
    if variant == "flat":
        cfg["shading"] = "flat"
    if variant == "full_compact":
        cfg.update(compact=True, width=640, height=360)
    pos, target = glass_box.pose(raw, 21, 63, 3.2, 1.2)
    cam = Camera.create(pos, target, cfg["width"] / cfg["height"])
    kernels.reset_launch_counts()
    out = Renderer(RenderConfig(**cfg), device=cuda).render(sd, cam, frame=21)
    calls = kernels.KERNEL_LAUNCHES["composite_fused"]
    assert calls >= 1 and kernels.KERNEL_LAUNCHES["composite_glue"] == 0
    ref = Renderer(RenderConfig(**cfg), device=cuda, isect=GLUE).render(sd, cam, frame=21)
    assert kernels.KERNEL_LAUNCHES["composite_glue"] == calls
    assert set(out) == set(ref)
    for k in out:
        if isinstance(out[k], torch.Tensor):
            assert_same(out[k], ref[k], k)
