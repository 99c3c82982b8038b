"""D1's candidate race (`ops/cuda/dda.race`, the `RaceArgs` entry of
`csrc/dda.cu`) against the K candidate passes it replaces
(`composite._race_slots`), on the card.

Marked `cuda`: each test skips when no CUDA device is present (decided in
the test, never at import).  Run on a machine with an NVIDIA GPU:

    python -m pytest --noconftest -q -p no:cacheprovider tests/test_torch_race_cuda.py

Every record field (t, mat, normal, albedo, steps, obj) is held to the
slot loop's bit for bit (`assert_same`), the slot loop run on the glue
(`_local_rays` / `_record`) and on C1 (`ops/cuda/composite.to_local` /
`record`), each around D1's pass 1:

- the primary, ``ignore`` and stochastic-shadow modes, K = 1..8 over
  stacked groups of O = 2..8 volumes at random rotations, positions and
  vpu (slots past O empty), the race written fresh and merged into a
  running record;
- rows whose candidates all miss, tied slab entries (two objects at one
  transform), broadcast (stride-0) direction rows, N = 0, 1 and N not a
  multiple of the block, the bitmap read from global memory
  (`GLOBAL_BITMAP`);
- no synchronize inside the race (PyTorch's sync debug mode), and
  `KERNEL_LAUNCHES["dda_race"]` counting its launches;
- the game cell's frame at one orbit position: every output field
  hash-equal to the same frame with the slot loop forced, one race a
  prepass call, and, with spans on, the race's ``kept`` (and the rays
  handed to D1) equal to the candidate spans' totals on that frame.
"""

import hashlib

import numpy as np
import pytest
import torch

from test_torch_composite_glue import _rot, _shell, assert_same
from test_torch_game_scene import CELL_CONFIG, game_scene

from port_bench import spans as bench_spans
from port_bench.scenes import drone_scene

from voxel_tracer_tpu_torch.models.camera import Camera
from voxel_tracer_tpu_torch.models.scene import Scene
from voxel_tracer_tpu_torch.models.volume import VoxelVolume
from voxel_tracer_tpu_torch.ops import composite, dda
from voxel_tracer_tpu_torch.ops.cuda import composite as kernels
from voxel_tracer_tpu_torch.ops.cuda import dda as dda_kernel
from voxel_tracer_tpu_torch.ops.math3d import BIG_F32
from voxel_tracer_tpu_torch.renderer import RenderConfig, Renderer
from voxel_tracer_tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda

SEED = 2 ** 31 + 11
MODES = ("primary", "ignore", "shadow")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _group(count, cuda, seed, mode="primary", same=None):
    """A stacked group of ``count`` 16^3 shells at random rotations,
    positions and vpu; shadow groups have walls of ids <= 16 (occluding
    with p = 0.15 by the hash) around cores of id 40.  ``same`` (i, j):
    object j at object i's transform."""
    rng = np.random.RandomState(seed)
    pal = (rng.rand(256, 3) * 0.8 + 0.1).astype(np.float32)
    tr = [(_rot(rng.randn(3), rng.uniform(0, np.pi)),
           rng.uniform(-1.0, 1.0, 3).astype(np.float32),
           float(rng.choice([8.0, 12.5, 20.0]))) for _ in range(count)]
    if same is not None:
        tr[same[1]] = tr[same[0]]
    wall = 3 if mode == "shadow" else 30
    vols = [VoxelVolume(_shell((16, 16, 16), wall + k, 40), pal, pos=p, rot=r, vpu=v)
            for k, (r, p, v) in enumerate(tr)]
    groups = Scene(volumes=vols).data(cuda).groups
    assert len(groups) == 1
    return groups[0]


def _rays(group, n, cuda, seed):
    """Rays from a box around the group toward points near its objects;
    a fifth aimed away (all their candidates miss), every 7th with zero y
    and z direction components."""
    g = torch.Generator().manual_seed(seed)
    pos = group.pos.cpu()
    centre = pos[torch.randint(0, pos.shape[0], (n,), generator=g)]
    o = centre + (torch.rand(n, 3, generator=g) * 6.0 - 3.0)
    d = centre + (torch.rand(n, 3, generator=g) - 0.5) - o
    away = torch.rand(n, generator=g) < 0.2
    d = torch.where(away[:, None], -d, d)
    d = d / torch.linalg.norm(d, dim=1, keepdim=True)
    d[::7, 1:] = 0.0
    return o.contiguous().to(cuda), d.contiguous().to(cuda)


def _modes(mode, group, n, cuda, seed):
    """D1's keywords of one traversal mode, per ray."""
    g = torch.Generator().manual_seed(seed)
    if mode == "ignore":
        ids = torch.tensor([0, 0, 30, 31, 40], dtype=torch.int32)
        return {"ignore": ids[torch.randint(0, 5, (n,), generator=g)].to(cuda)}
    if mode == "shadow":
        seeds = torch.randint(0, 2 ** 32, (n,), generator=g, dtype=torch.int64)
        return {"shadow": True, "shadow_seed": seeds.to(cuda)}
    return {}


def _running(n, count, cuda, seed):
    """A running record as an earlier group leaves it: t near the group or
    a miss, and every other field at random."""
    g = torch.Generator().manual_seed(seed)
    t = torch.rand(n, generator=g) * 6.0
    t = torch.where(torch.rand(n, generator=g) < 0.4, torch.full_like(t, BIG_F32), t)
    return composite.HitResult(
        t=t.to(cuda),
        mat=torch.randint(0, 256, (n,), generator=g, dtype=torch.int32).to(cuda),
        normal=torch.randn(n, 3, generator=g).to(cuda),
        albedo=torch.rand(n, 3, generator=g).to(cuda),
        steps=torch.randint(0, 100, (n,), generator=g, dtype=torch.int32).to(cuda),
        obj=torch.randint(-1, count, (n,), generator=g, dtype=torch.int32).to(cuda))


def _clone(best):
    return None if best is None else composite.HitResult(*(x.clone() for x in best))


def _slots(group, o, d, cand, best, obj_base, stages, kw):
    return composite._race_slots(group, o, d, *cand, _clone(best), obj_base, dda.MAX_STEPS,
                                 *stages, dda_kernel.intersect_volume_local, kw)


GLUE = (composite._local_rays, composite._record)
C1 = (kernels.to_local, kernels.record)


def _check(group, o, d, k, kw, what, best=None, obj_base=3):
    """The race on (o, d) with the prepass's K candidates, fresh and merged
    into ``best`` (default: a random running record), against the slot loop
    on the glue and on C1; returns the fresh race."""
    cand = kernels.topk(group, o, d, k)
    n = o.shape[0]
    if best is None:
        best = _running(n, group.grid.shape[0] + obj_base, o.device, n + k)
    out = None
    for run in (None, best):
        before = dda_kernel.KERNEL_LAUNCHES["dda_race"]
        got = dda_kernel.race(group, o, d, *cand, _clone(run), obj_base=obj_base, **kw)
        assert dda_kernel.KERNEL_LAUNCHES["dda_race"] == before + (1 if n else 0)
        tag = f"{what} {'fresh' if run is None else 'merged'}"
        assert_same(got, _slots(group, o, d, cand, run, obj_base, GLUE, kw), f"{tag} glue")
        assert_same(got, _slots(group, o, d, cand, run, obj_base, C1, kw), f"{tag} C1")
        out = got if run is None else out
    return out


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("count", range(2, 9))
@pytest.mark.parametrize("k", range(1, 9))
def test_race_matches_the_slots(cuda, mode, count, k):
    group = _group(count, cuda, seed=100 * count + k, mode=mode)
    n = 20_001
    o, d = _rays(group, n, cuda, seed=count + 10 * k)
    race = _check(group, o, d, k, _modes(mode, group, n, cuda, count * k),
                  f"{mode} O={count} K={k}")
    hit = race.t < BIG_F32
    assert hit.sum() > n // 50 and (~hit).sum() > n // 50     # hits and misses
    assert (race.obj[~hit] == -1).all()


def test_race_where_every_candidate_misses(cuda):
    group = _group(4, cuda, seed=1)
    o, d = _rays(group, 10_000, cuda, seed=1)
    far = o + 100.0                            # every box behind or beside these rays
    race = _check(group, far, d, 4, {}, "all miss")
    assert (race.t == BIG_F32).all() and (race.steps == 0).all()


@pytest.mark.parametrize("mode", MODES)
def test_race_on_tied_slab_entries(cuda, mode):
    """Objects 1 and 3 at one transform: equal entry t in two slots, the
    later slot dead once the earlier one hits."""
    group = _group(4, cuda, seed=9, mode=mode, same=(1, 3))
    n = 40_000
    o, d = _rays(group, n, cuda, seed=9)
    t, ids = kernels.topk(group, o, d, 4)
    tied = ((ids == 1).any(1) & (ids == 3).any(1)).sum()
    assert tied > 100
    _check(group, o, d, 4, _modes(mode, group, n, cuda, 9), f"tie {mode}")


@pytest.mark.parametrize("mode", MODES)
def test_race_on_broadcast_directions(cuda, mode):
    group = _group(5, cuda, seed=5, mode=mode)
    n = 30_000
    o, d = _rays(group, n, cuda, seed=5)
    for row in (d[3], torch.tensor([0.0, -1.0, 0.0], device=cuda)):
        dirs = row.expand(n, 3)
        assert dirs.stride(0) == 0
        _check(group, o, dirs, 3, _modes(mode, group, n, cuda, 5), f"broadcast {row.tolist()}")


@pytest.mark.parametrize("n", [0, 1, 127, 129, 4097])
def test_race_small_batches(cuda, n):
    group = _group(3, cuda, seed=n)
    o, d = _rays(group, max(n, 1), cuda, seed=n)
    _check(group, o[:n], d[:n], 2, _modes("shadow", group, n, cuda, n), f"N={n}")


def test_race_with_the_bitmap_in_global_memory(cuda, monkeypatch):
    monkeypatch.setattr(dda_kernel, "GLOBAL_BITMAP", True)
    group = _group(6, cuda, seed=6)
    n = 30_000
    o, d = _rays(group, n, cuda, seed=6)
    _check(group, o, d, 4, _modes("ignore", group, n, cuda, 6), "global bitmap")


def test_race_refuses_more_slots_than_it_holds(cuda):
    group = _group(3, cuda, seed=2)
    o, d = _rays(group, 64, cuda, seed=2)
    cand = (torch.full((64, 9), BIG_F32, device=cuda),
            torch.zeros((64, 9), dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="outside 1..8"):
        dda_kernel.race(group, o, d, *cand)


def test_race_never_synchronizes(cuda):
    group = _group(4, cuda, seed=11, mode="shadow")
    n = 10_000
    o, d = _rays(group, n, cuda, seed=11)
    kw = _modes("shadow", group, n, cuda, 11)
    cand = kernels.topk(group, o, d, 4)
    best = _running(n, 4, cuda, 11)
    dda_kernel.race(group, o, d, *cand, _clone(best), **kw)    # built, tables derived
    torch.cuda.synchronize()
    before = dda_kernel.KERNEL_LAUNCHES["dda_race"]
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = dda_kernel.race(group, o, d, *cand, _clone(best), **kw)
        fresh = dda_kernel.race(group, o, d[5].expand(n, 3), *cand, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    assert dda_kernel.KERNEL_LAUNCHES["dda_race"] == before + 2
    assert_same(got, _slots(group, o, d, cand, best, 0, C1, kw), "no sync")
    assert fresh.t.shape == (n,)


def _digest(x):
    return hashlib.sha256(x.contiguous().cpu().numpy().tobytes()).hexdigest()


def _slot_loop(group, origins, dirs, cand_t, cand_id, best=None, obj_base=0,
               max_steps=dda.MAX_STEPS, **kw):
    """`dda_kernel.race`'s signature on the slot loop with C1 around D1:
    the K passes the race replaces."""
    return composite._race_slots(group, origins, dirs, cand_t, cand_id, best, obj_base,
                                 max_steps, *C1, dda_kernel.intersect_volume_local, kw)


def test_game_frame_equals_the_frame_on_the_slot_loop(cuda, monkeypatch):
    """The cell's frame at orbit position 21 (1280x720, 8 bounces, 8 glass
    reflections; the drones where the cell flies them), each output field
    hash-equal with the race and with the slot loop forced; one race a
    prepass call; with spans on, the rays handed to D1 and the rays kept
    equal on the two frames, so the races' ``kept`` is the candidate
    spans' total."""
    raw, _host, sd, drones = game_scene(SEED, cuda, CELL_CONFIG)
    j = 21
    sd = sd.with_transforms(dict(zip(drones, drone_scene.transforms(raw, j, 63))))
    cfg = CELL_CONFIG["render"]
    pos, target = drone_scene.pose(raw, j, 63, 3.2, 1.2)
    cam = Camera.create(pos, target, cfg["width"] / cfg["height"])

    def frame():
        kernels.reset_launch_counts()
        dda_kernel.reset_launch_counts()
        with profiling.recording():
            out = Renderer(RenderConfig(**cfg), device=cuda).render(sd, cam, frame=0)
        recs = profiling.take_spans()
        return out, dict(kernels.KERNEL_LAUNCHES), dict(dda_kernel.KERNEL_LAUNCHES), recs

    out, counts, d1_counts, recs = frame()
    assert counts["composite_topk"] > 0 and counts["composite_glue"] == 0
    assert d1_counts["dda_race"] == counts["composite_topk"]
    assert not any(r["name"] == "candidate" for r in recs)
    monkeypatch.setattr(dda_kernel, "race", _slot_loop)
    ref, ref_counts, ref_d1, ref_recs = frame()
    assert ref_d1["dda_race"] == 0 and ref_counts["composite_topk"] == counts["composite_topk"]
    assert d1_counts["dda_rays"] == ref_d1["dda_rays"]
    cands = [r for r in ref_recs if r["name"] == "candidate"]
    assert len(cands) == 4 * counts["composite_topk"]
    rays, kept, _rows = bench_spans.kept_rays(recs)
    ref_rays, ref_kept, ref_rows = bench_spans.kept_rays(ref_recs)
    assert (rays, kept) == (ref_rays, ref_kept)
    # each race is the first d1 span after its prepass
    races = [next(x for x in recs[i + 1:] if x["name"] == "d1")
             for i, r in enumerate(recs) if r["name"] == "topk"]
    assert [sum(r["attrs"][a] for r in races) for a in ("rays", "kept")] == \
        ref_rows["candidate"]
    assert ref_rows["candidate"][1] > 0
    assert set(out) == set(ref)
    for key in out:
        if isinstance(out[key], torch.Tensor):
            assert _digest(out[key]) == _digest(ref[key]), key
