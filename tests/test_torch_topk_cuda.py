"""The top-K slab prepass kernel (`ops/cuda/composite.topk`, C2 in
`csrc/composite.cu`) against its plain version `composite._topk`, on the
card.

Marked `cuda`: each test skips when no CUDA device is present (decided in
the test, never at import).  Run on a machine with an NVIDIA GPU:

    python -m pytest --noconftest -q -p no:cacheprovider tests/test_torch_topk_cuda.py

Every (t, ids) pair is held to the plain version's with `torch.equal`, and
t bit for bit as well once zeros are given one sign (`_same`: the plain
version's torch.amax decides the sign of a zero entry by its order):

- K = 1..8 over stacked groups of O = 2..8 volumes at random rotations,
  positions and vpu; rays that hit, miss every box, have zero direction
  components, or start exactly on a slab plane; broadcast (stride-0)
  direction rows; N = 0, 1 and N not a multiple of the block;
- two objects at the same transform (a tie: the earlier object first);
- the game cell's four drones (`port_bench/configs/drone_scene_720p.json`)
  at random transforms;
- no synchronize inside the prepass (PyTorch's sync debug mode), and
  `KERNEL_LAUNCHES["composite_topk"]` counting its launches;
- the game cell's frame at its first orbit position: every output field
  hash-equal to the same frame with the plain prepass.
"""

import hashlib

import numpy as np
import pytest
import torch

from test_torch_composite_glue import _rot, _shell
from test_torch_game_scene import CELL_CONFIG, game_scene

from port_bench.scenes import drone_scene

from voxel_tracer_tpu_torch.models.camera import Camera
from voxel_tracer_tpu_torch.models.scene import Scene
from voxel_tracer_tpu_torch.models.volume import VoxelVolume
from voxel_tracer_tpu_torch.ops import composite
from voxel_tracer_tpu_torch.ops.cuda import composite as kernels
from voxel_tracer_tpu_torch.ops.math3d import BIG_F32
from voxel_tracer_tpu_torch.renderer import RenderConfig, Renderer

pytestmark = pytest.mark.cuda

SEED = 2 ** 31 + 7


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _same(out, ref, what=""):
    """The kernel's (t, ids) equal the plain version's: `torch.equal`, and
    t's bits once -0 reads +0."""
    assert out[0].shape == ref[0].shape and out[1].shape == ref[1].shape, what
    assert out[0].dtype == torch.float32 and out[1].dtype == torch.int32, what
    assert torch.equal(out[1], ref[1]), f"{what}: {(out[1] != ref[1]).sum().item()} ids differ"
    assert torch.equal(out[0], ref[0]), f"{what}: {(out[0] != ref[0]).sum().item()} t differ"
    bits = [(x + 0.0).view(torch.int32) for x in (out[0], ref[0])]
    assert torch.equal(*bits), what


def _group(count, cuda, seed, same=None):
    """A stacked group of ``count`` 16^3 shells at random rotations,
    positions and vpu; ``same`` (i, j): object j at object i's transform."""
    rng = np.random.RandomState(seed)
    pal = (rng.rand(256, 3) * 0.8 + 0.1).astype(np.float32)
    tr = [(_rot(rng.randn(3), rng.uniform(0, np.pi)),
           rng.uniform(-1.0, 1.0, 3).astype(np.float32),
           float(rng.choice([8.0, 12.5, 20.0]))) for _ in range(count)]
    if same is not None:
        tr[same[1]] = tr[same[0]]
    vols = [VoxelVolume(_shell((16, 16, 16), 30 + k, 40), pal, pos=p, rot=r, vpu=v)
            for k, (r, p, v) in enumerate(tr)]
    groups = Scene(volumes=vols).data(cuda).groups
    assert len(groups) == 1
    return groups[0]


def _rays(group, n, cuda, seed):
    """Rays from a box around the group toward points near its objects:
    some miss every box (aimed away), every 5th has a zero x direction, every
    7th zero y and z, every 11th starts on a face of object 0 (a local
    coordinate 0 or the box's size, to rounding; exactly on a face in
    `test_topk_on_slab_planes_and_zero_directions`)."""
    g = torch.Generator().manual_seed(seed)
    pos = group.pos.cpu()
    centre = pos[torch.randint(0, pos.shape[0], (n,), generator=g)]
    o = centre + (torch.rand(n, 3, generator=g) * 6.0 - 3.0)
    d = centre + (torch.rand(n, 3, generator=g) - 0.5) - o
    away = torch.rand(n, generator=g) < 0.2
    d = torch.where(away[:, None], -d, d)
    d = d / torch.linalg.norm(d, dim=1, keepdim=True)
    d[::5, 0] = 0.0
    d[::7, 1:] = 0.0
    # on a slab plane of object 0: p = pos + R (l - pivot) with l on a face
    rot, piv = group.rot[0].cpu(), group.pivot[0].cpu()
    size = torch.tensor(group.grid.shape[-3:][::-1], dtype=torch.float32) / group.vpu[0].cpu()
    rows = torch.arange(0, n, 11)
    local = torch.rand(len(rows), 3, generator=g) * size
    axis = torch.randint(0, 3, (len(rows),), generator=g)
    face = torch.where(torch.rand(len(rows), generator=g) < 0.5, 0.0, size[axis])
    local[torch.arange(len(rows)), axis] = face
    o[rows] = pos[0] + (rot @ (local - piv).T).T
    return o.contiguous().to(cuda), d.contiguous().to(cuda)


def _check(group, o, d, k, what):
    before = kernels.KERNEL_LAUNCHES["composite_topk"]
    out = kernels.topk(group, o, d, k)
    assert kernels.KERNEL_LAUNCHES["composite_topk"] == before + (1 if o.shape[0] else 0)
    _same(out, composite._topk(group, o, d, k), what)
    return out


@pytest.mark.parametrize("count", range(2, 9))
@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_topk_matches_plain(cuda, count, k):
    group = _group(count, cuda, seed=100 * count + k)
    o, d = _rays(group, 50_001, cuda, seed=count + 10 * k)
    t, ids = _check(group, o, d, k, f"O={count} K={k}")
    assert (t[:, 0] < BIG_F32).any() and (t[:, 0] == BIG_F32).any()   # hits and misses
    if k > 1:
        assert (t[:, 1] < BIG_F32).any()                               # a second candidate


@pytest.mark.parametrize("k", [5, 8])
def test_topk_matches_plain_up_to_the_bound(cuda, k):
    group = _group(8, cuda, seed=k)
    o, d = _rays(group, 70_001, cuda, seed=k)
    _check(group, o, d, k, f"K={k}")


@pytest.mark.parametrize("n", [0, 1, 255, 257])
def test_topk_small_batches(cuda, n):
    group = _group(3, cuda, seed=n)
    o, d = _rays(group, max(n, 1), cuda, seed=n)
    _check(group, o[:n], d[:n], 2, f"N={n}")


def test_topk_on_slab_planes_and_zero_directions(cuda):
    """An axis-aligned object at dyadic coordinates: origins exactly on its
    faces, with direction components 0 (0 * inf: the NaN guards), along
    and across each face."""
    rng = np.random.RandomState(3)
    pal = (rng.rand(256, 3) * 0.8 + 0.1).astype(np.float32)
    vols = [VoxelVolume(_shell((16, 16, 16), 30, 40), pal, pos=(0.5, 0.25, -0.75), vpu=8.0),
            VoxelVolume(_shell((16, 16, 16), 31, 40), pal, pos=(0.5, 0.25, -0.25), vpu=8.0)]
    group = Scene(volumes=vols).data(cuda).groups[0]
    n = 4096
    g = torch.Generator().manual_seed(4)
    local = torch.floor(torch.rand(n, 3, generator=g) * 17) / 8.0    # 0 .. 2 by 1/8: faces too
    o = local - 1.0 + torch.tensor([0.5, 0.25, -0.75])
    d = torch.randint(-1, 2, (n, 3), generator=g).float()
    d[d.abs().sum(1) == 0] = torch.tensor([0.0, 0.0, 1.0])
    o, d = o.to(cuda), d.to(cuda)
    lo = composite._to_local(group.rot[0], group.pos[0], group.pivot[0], o, d)[0]
    assert ((lo == 0) | (lo == 2.0)).any(dim=1).float().mean() > 0.1
    t, _ids = _check(group, o, d, 2, "slab planes")
    assert (t[:, 0] == 0).any()


def test_topk_broadcast_directions(cuda):
    group = _group(5, cuda, seed=5)
    o, d = _rays(group, 30_000, cuda, seed=5)
    for row in (d[7], torch.tensor([0.0, -1.0, 0.0], device=cuda)):
        dirs = row.expand(o.shape[0], 3)
        assert dirs.stride(0) == 0
        _check(group, o, dirs, 3, f"broadcast {row.tolist()}")


def test_topk_tie_keeps_the_earlier_object(cuda):
    group = _group(4, cuda, seed=9, same=(1, 3))
    o, d = _rays(group, 40_000, cuda, seed=9)
    t, ids = _check(group, o, d, 4, "tie")
    both = (ids == 1).any(1) & (ids == 3).any(1)
    assert both.sum() > 100
    first = (ids == 1).int().argmax(1)
    assert (first[both] < (ids == 3).int().argmax(1)[both]).all()


@pytest.mark.parametrize("j", [0, 17, 40])
def test_topk_over_the_game_drones(cuda, j):
    """The game cell's drone group, moved to random transforms (random yaw,
    pitch and roll, positions around the box) by `with_transforms`."""
    raw, _host, sd, drones = game_scene(SEED, cuda, CELL_CONFIG)
    rng = np.random.RandomState(j)
    c = np.float32(drone_scene.BOX_POS)
    tr = [(_rot(rng.randn(3), rng.uniform(0, np.pi)),
           c + rng.uniform(-1.5, 1.5, 3).astype(np.float32)) for _ in drones]
    moved = sd.with_transforms(dict(zip(drones, tr)))
    group = next(g for g in moved.groups if g.grid.shape[0] == 4)
    o, d = _rays(group, 200_003, cuda, seed=j)
    t, _ids = _check(group, o, d, 4, f"drones {j}")
    assert (t[:, 0] < BIG_F32).sum() > 1000


def test_topk_never_synchronizes(cuda):
    group = _group(4, cuda, seed=11)
    o, d = _rays(group, 10_000, cuda, seed=11)
    kernels.topk(group, o, d, 4)              # the library is built and loaded
    torch.cuda.synchronize()
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = composite._slab_prepass_topk(group, o, d, 4, True)
        kernels.topk(group, o, d[3].expand(o.shape[0], 3), 2)
    finally:
        torch.cuda.set_sync_debug_mode(prev)
    _same(out, composite._topk(group, o, d, 4), "no sync")


def _digest(x):
    return hashlib.sha256(x.contiguous().cpu().numpy().tobytes()).hexdigest()


def test_game_frame_equals_the_frame_on_the_plain_prepass(cuda, monkeypatch):
    """The cell's frame at orbit position 0 (1280x720, 8 bounces, 8 glass
    reflections; the drones where the cell flies them), each output field
    hash-equal with the prepass on the kernel and on `_topk`."""
    raw, _host, sd, drones = game_scene(SEED, cuda, CELL_CONFIG)
    sd = sd.with_transforms(dict(zip(drones, drone_scene.transforms(raw, 0, 63))))
    cfg = CELL_CONFIG["render"]
    pos, target = drone_scene.pose(raw, 0, 63, 3.2, 1.2)
    cam = Camera.create(pos, target, cfg["width"] / cfg["height"])

    def frame():
        kernels.reset_launch_counts()
        out = Renderer(RenderConfig(**cfg), device=cuda).render(sd, cam, frame=0)
        return out, dict(kernels.KERNEL_LAUNCHES)

    out, counts = frame()
    assert counts["composite_topk"] > 0 and counts["composite_glue"] == 0
    monkeypatch.setattr(kernels, "topk", lambda group, o, d, k: composite._topk(group, o, d, k))
    ref, ref_counts = frame()
    assert ref_counts["composite_topk"] == 0
    assert {k: v for k, v in counts.items() if k != "composite_topk"} == \
        {k: v for k, v in ref_counts.items() if k != "composite_topk"}
    assert set(out) == set(ref)
    for k in out:
        if isinstance(out[k], torch.Tensor):
            assert _digest(out[k]) == _digest(ref[k]), k
