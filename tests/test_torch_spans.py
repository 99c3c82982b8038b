"""The program's spans and counters (`utils/profiling.annotate`,
`take_spans`, D1's `dda_rays` / `dda_tables`) on the CPU:
a frame is bit-equal with spans on and off, the span tree, nothing
recorded while off, the rays handed to D1 and the share of them whose
result is kept, and the spans' times against the profiler's events."""

import math

import numpy as np
import pytest
import torch

from voxel_tracer_tpu_torch.models.camera import Camera
from voxel_tracer_tpu_torch.ops import composite
from voxel_tracer_tpu_torch.ops.cuda import dda as d1
from voxel_tracer_tpu_torch.ops.math3d import BIG_F32
from voxel_tracer_tpu_torch.renderer import RenderConfig, Renderer
from voxel_tracer_tpu_torch.utils import profiling

W, H = 32, 18
NAMES = {"frame", "raygen", "sky", "tonemap", "intersect", "topk", "candidate", "d1",
         "shade", "shade.bounce", "shade.diffuse", "shade.glass", "shade.glass.march",
         "shade.glass.scan", "shade.continue"}


@pytest.fixture(scope="module")
def glass_box():
    merged, scene = profiling.glass_box_scene(32)
    return np.asarray(merged.pos, np.float64), scene.data("cpu")


def _camera(centre, angle, away=False):
    pos = (centre[0] + 3.2 * math.cos(angle), centre[1] + 1.2,
           centre[2] + 3.2 * math.sin(angle))
    target = tuple(2 * p - c for p, c in zip(pos, centre)) if away else tuple(centre)
    return Camera.create(pos, target, W / H)


def _render(scene, camera, spans, **cfg):
    """One frame with spans on or off: (outputs, records, D1's counter
    deltas, the rays each D1 call was handed)."""
    handed = []
    plain = d1.intersect_volume_local

    def counted(grid, brick_occ, origin_l, *args, **kw):
        handed.append(origin_l.shape[0])
        return plain(grid, brick_occ, origin_l, *args, **kw)

    renderer = Renderer(RenderConfig(width=W, height=H, glass_reflections=2, **cfg),
                        device="cpu")
    before = dict(d1.KERNEL_LAUNCHES)
    d1.intersect_volume_local = counted
    try:
        with profiling.recording() if spans else _off():
            out = renderer.render(scene, camera, frame=0)
    finally:
        d1.intersect_volume_local = plain
    deltas = {k: v - before[k] for k, v in d1.KERNEL_LAUNCHES.items()}
    return out, profiling.take_spans(), deltas, handed


class _off:
    def __enter__(self):
        self.prev = profiling.spans(False)

    def __exit__(self, *exc):
        profiling.spans(self.prev)


@pytest.fixture(scope="module")
def whitted(glass_box):
    """A full frame from a view through the glass box, spans off then on."""
    centre, scene = glass_box
    cam = _camera(centre, 2 * math.pi * 21 / 63)
    return _render(scene, cam, False), _render(scene, cam, True)


def test_frame_is_bit_equal_with_spans_on_and_off(whitted):
    (off, recs_off, _d, _h), (on, recs_on, _d2, _h2) = whitted
    assert set(off) == set(on)
    for k in off:
        assert torch.equal(off[k], on[k]), k
    assert recs_off == [] and len(recs_on) > 50


def test_span_tree(whitted):
    _off_run, (_out, recs, _d, _h) = whitted
    by_id = {r["id"]: r for r in recs}
    root = recs[0]
    assert root["name"] == "frame" and root["parent"] is None
    assert root["attrs"] == {"width": W, "height": H, "shading": "full"}
    assert {r["name"] for r in recs} <= NAMES
    assert {"shade.glass.march", "shade.glass.scan", "shade.diffuse", "shade.continue"} \
        <= {r["name"] for r in recs}
    for r in recs[1:]:
        parent = by_id[r["parent"]]
        assert r["frame"] == root["frame"]
        assert parent["start_ns"] <= r["start_ns"] <= r["end_ns"] <= parent["end_ns"]
    # every D1 call sits in a traversal, every traversal in a stage or the root
    for r in recs:
        if r["name"] == "d1":
            assert by_id[r["parent"]]["name"] in ("intersect", "candidate")
        if r["name"] == "intersect":
            assert by_id[r["parent"]]["name"] in ("frame", "shade.diffuse",
                                                  "shade.glass.march", "shade.glass.scan",
                                                  "shade.continue")
    kinds = {r["attrs"]["kind"] for r in recs if r["name"] == "intersect"}
    assert kinds == {"primary", "shadow", "interior", "scan"}
    bounces = [r["attrs"]["bounce"] for r in recs if r["name"] == "shade.bounce"]
    assert bounces == list(range(8))


def test_frame_ids_count_render_calls(glass_box):
    centre, scene = glass_box
    renderer = Renderer(RenderConfig(width=8, height=4, shading="flat"), device="cpu")
    with profiling.recording():
        for _ in range(3):
            renderer.render(scene, _camera(centre, 0.0), frame=0)
    recs = profiling.take_spans()
    roots = [r for r in recs if r["parent"] is None]
    assert [r["frame"] for r in roots] == [1, 2, 3] == list(range(1, renderer.renders + 1))
    assert {r["frame"] for r in recs} == {1, 2, 3}


def test_spans_off_record_nothing_and_enter_no_record_function(glass_box, monkeypatch):
    centre, scene = glass_box

    def refuse(*_a, **_k):
        raise AssertionError("record_function entered with spans off")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    renderer = Renderer(RenderConfig(width=8, height=4, max_bounces=2), device="cpu")
    assert profiling.annotate("shade") is profiling.annotate("shade")
    assert profiling.annotate("d1", rays=3) is profiling.annotate("intersect", kind="scan")
    with torch.autograd.profiler.profile(use_cpu=True, use_kineto=True):
        renderer.render(scene, _camera(centre, 0.0), frame=0)
    assert profiling.take_spans() == []
    # the same window with spans on does reach record_function
    with torch.autograd.profiler.profile(use_cpu=True, use_kineto=True):
        with profiling.recording(), pytest.raises(AssertionError, match="spans off"):
            renderer.render(scene, _camera(centre, 0.0), frame=0)
    profiling.take_spans()


def test_dda_rays_count_the_rays_handed_to_d1(whitted):
    for _out, recs, deltas, handed in whitted:
        assert deltas["dda_rays"] == sum(handed) > 0
        assert deltas["dda"] == 0 and deltas["dda_tables"] == 0     # CPU: no launch
    _off_run, (_out, recs, _d, handed) = whitted
    assert [r["attrs"]["rays"] for r in recs if r["name"] == "d1"] == handed


def _kept(recs, **where):
    """Kept rays of the d1 spans under a parent span matching ``where``."""
    by_id = {r["id"]: r for r in recs}

    def under(r):
        while r["parent"] is not None:
            r = by_id[r["parent"]]
            if all(r["name"] == v if k == "name" else r["attrs"].get(k) == v
                   for k, v in where.items()):
                return True
        return False
    return [r["attrs"]["kept"] for r in recs if r["name"] == "d1" and under(r)]


def test_kept_rays_where_every_ray_misses(glass_box):
    """Facing away from the scene: the primary traversal keeps its rays,
    every later one (3 shadow rays a bounce, 7 continuations) keeps 0."""
    centre, scene = glass_box
    out, recs, deltas, handed = _render(scene, _camera(centre, 0.0, away=True), True)
    n = W * H
    assert bool((out["depth"] >= BIG_F32).all())
    kept = [r["attrs"]["kept"] for r in recs if r["name"] == "d1"]
    assert handed == [n] * (1 + 8 * 3 + 7)
    assert kept == [n] + [0] * (8 * 3 + 7)
    assert _kept(recs, name="shade.diffuse") == [0] * 24


def test_kept_rays_of_a_flat_frame(glass_box):
    centre, scene = glass_box
    _out, recs, deltas, handed = _render(scene, _camera(centre, 1.0), True, shading="flat")
    assert handed == [W * H] and deltas["dda_rays"] == W * H
    assert [r["attrs"]["kept"] for r in recs if r["name"] == "d1"] == [W * H]


def test_kept_rays_of_the_first_diffuse_stage(whitted):
    """Bounce 0's three shadow traversals each keep the primary hits that
    are diffuse: a hit that is neither glass (row 0), mirror (row 1) nor
    unlit (row 15, id 255)."""
    _off_run, (out, recs, _d, _h) = whitted
    mat = out["material"].flatten()
    row = torch.div(mat - 1, 8, rounding_mode="floor")
    diffuse = (out["depth"].flatten() < BIG_F32) & (row != 0) & (row != 1) \
        & (row != 15) & (mat != 255)
    kept = _kept(recs, name="shade.diffuse", bounce=0)
    assert kept == [int(diffuse.sum())] * 3 and 0 < kept[0] < W * H
    total = sum(r["attrs"]["kept"] for r in recs if r["name"] == "d1")
    assert 0 < total < sum(r["attrs"]["rays"] for r in recs if r["name"] == "d1")


def test_kept_rays_of_candidates_in_a_group():
    """Two volumes in one group: each candidate slot keeps the rows whose
    candidate can still beat the nearest hit so far."""
    from voxel_tracer_tpu_torch.models.scene import Scene
    from voxel_tracer_tpu_torch.models.volume import VoxelVolume

    g = np.zeros((8, 8, 8), np.uint8)
    g[2:6, 2:6, 2:6] = 30
    scene = Scene(volumes=[VoxelVolume(g, pos=(0.0, 0.0, 0.0), vpu=8.0),
                           VoxelVolume(g, pos=(0.0, 0.0, 3.0), vpu=8.0)]).data("cpu")
    n = 64
    o = torch.zeros((n, 3))
    o[:, 2] = -3.0
    o[:, 0] = torch.linspace(-0.6, 0.6, n)
    d = torch.tensor([[0.0, 0.0, 1.0]]).repeat(n, 1)
    with profiling.recording():
        with profiling.annotate("frame", frame_id=0):
            hit = composite.intersect_scene(scene, o, d, 2)
    recs = profiling.take_spans()
    cands = [r for r in recs if r["name"] == "candidate"]
    assert [r["attrs"]["slot"] for r in cands] == [0, 1]
    assert any(r["name"] == "topk" and r["attrs"] == {"objects": 2, "k": 2, "fused": False}
               for r in recs)
    kept = [r["attrs"]["kept"] for r in recs if r["name"] == "d1"]
    # slot 0 keeps every ray whose line meets the boxes' bounds; slot 1
    # those of them that the first box's solid voxels let through
    in_box = int((o[:, 0].abs() <= 0.5).sum())
    hits = int((hit.t < BIG_F32).sum())
    assert 0 < hits < in_box < n
    assert kept == [in_box, in_box - hits]


def test_span_times_match_the_profilers_events():
    """Each span's start and end lie within 1 ms of its record_function
    event in a CPU profiler window (both on CLOCK_REALTIME)."""
    with torch.autograd.profiler.profile(use_cpu=True, use_kineto=True):
        with torch.autograd.profiler.record_function("warm"):
            pass
    with torch.autograd.profiler.profile(use_cpu=True, use_kineto=True) as prof:
        with profiling.recording():
            with profiling.annotate("frame", frame_id=7):
                with profiling.annotate("sky"):
                    torch.ones(64).sum()
                with profiling.annotate("tonemap"):
                    torch.ones(64).cumsum(0)
    recs = profiling.take_spans()
    events = {e.name(): e for e in prof.kineto_results.events() if e.is_user_annotation()}
    assert [r["name"] for r in recs] == ["frame", "sky", "tonemap"]
    for r in recs:
        e = events[r["name"]]
        assert abs(e.start_ns() - r["start_ns"]) < 1e6, r["name"]
        assert abs(e.end_ns() - r["end_ns"]) < 1e6, r["name"]


def test_annotate_decorates_and_the_buffer_is_bounded(monkeypatch):
    @profiling.annotate("shade")
    def f(x):
        return x + 1

    assert f(1) == 2 and profiling.take_spans() == []
    with pytest.raises(TypeError):
        profiling.annotate("shade", bounce=0)(f)
    monkeypatch.setattr(profiling, "MAX_SPANS", 3)
    with profiling.recording():
        for _ in range(5):
            assert f(1) == 2
    recs = profiling.take_spans()
    assert [r["name"] for r in recs] == ["shade"] * 3 and recs.dropped == 2
    assert profiling.take_spans() == [] and profiling.take_spans().dropped == 0
