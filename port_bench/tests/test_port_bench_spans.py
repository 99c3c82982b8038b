"""`spans.py`: the attribution of host time, device events and idle gaps to
the program's spans, on synthetic event lists, and a whole span round on
the CPU at a tiny size."""

import pytest

from port_bench import harness, spans
from port_bench.tests.conftest import SMALL

US = 1000      # ns


def _span(i, name, a, b, parent=None, **attrs):
    return {"id": i, "name": name, "parent": parent, "frame": 1, "start_ns": a * US,
            "end_ns": b * US, "attrs": attrs}


# frame > shade.diffuse > intersect[shadow] > d1, and frame > tonemap
SPANS = [_span(0, "frame", 0, 1000),
         _span(1, "shade.diffuse", 100, 600, 0, bounce=0),
         _span(2, "intersect", 150, 500, 1, kind="shadow"),
         _span(3, "d1", 200, 450, 2, rays=10, kept=4),
         _span(4, "tonemap", 700, 800, 0)]
# (correlation id, runtime call's start) and (name, start, end, correlation id)
RUNTIME = [(1, 120 * US), (2, 210 * US), (3, 300 * US), (4, 520 * US), (5, 710 * US),
           (6, 5 * US), (7, 1100 * US), (8, 1900 * US)]
DEVICE = [("void at::native::elementwise_kernel<128, 2>", 130 * US, 180 * US, 1),
          ("void at::native::index_elementwise_kernel<128, 4>", 220 * US, 260 * US, 2),
          ("void (anonymous namespace)::dda_kernel<true>(DdaArgs)", 310 * US, 400 * US, 3),
          ("Memcpy DtoH (Device -> Pageable)", 530 * US, 540 * US, 4),
          ("void at::native::vectorized_elementwise_kernel<4>", 720 * US, 760 * US, 5),
          ("void at::native::fill_kernel", 10 * US, 20 * US, 6),
          ("void at::native::after_the_frame", 1200 * US, 1300 * US, 7),
          ("void at::native::outside", 2000 * US, 2100 * US, 8)]


def test_host_self_time_by_layer_across_nested_spans():
    layers, rows = spans.host_times(SPANS, 1)
    # frame 1000 - 500 - 100, tonemap 100; shade.diffuse 500 - 350;
    # intersect 350 - 250, d1 250 (us)
    assert layers == pytest.approx({"root": 0.5, "shading": 0.15, "composite": 0.35})
    assert sum(layers.values()) == pytest.approx(rows["frame"]["host_ms"])
    assert rows["intersect[shadow]"] == pytest.approx({"n": 1, "host_ms": 0.35,
                                                       "self_ms": 0.1})


def test_device_events_and_gaps_by_span_and_layer():
    dev = spans.attribute(SPANS, RUNTIME, DEVICE, 1)
    # the elementwise kernel and the memcpy were launched in shade.diffuse,
    # the gather in d1 (composite's glue), D1's kernel is D1's wherever it
    # ran; the fill and the tonemap kernel are the entry point's
    assert dev["device_ms"] == pytest.approx({"shading": 0.06, "composite": 0.04, "D1": 0.09,
                                              "root": 0.05 + 0.1 + 0.1})
    assert dev["rows"]["shade.diffuse"]["launches"] == 2
    assert dev["rows"]["d1"]["device_ms"] == pytest.approx(0.13)
    # two events launched outside every span
    assert dev["unattributed"] == 2 and dev["events"] == 8
    # gaps: 20-130 (frame), 180-220 and 260-310 (d1), 400-530 (intersect),
    # 540-720 (frame), 760-1200 (frame), 1300-2000 (outside)
    assert dev["idle_ms"] == pytest.approx({"root": 0.11 + 0.18 + 0.44, "composite": 0.22,
                                            spans.OUTSIDE: 0.7})
    assert dev["rows"]["frame"]["idle_ms"] == pytest.approx(0.73)
    assert sum(dev["device_ms"].values()) == pytest.approx(dev["busy_ms"])


def test_kept_rays_roll_up_to_every_enclosing_span():
    rays, kept, rows = spans.kept_rays(SPANS)
    assert (rays, kept) == (10, 4)
    assert rows == {"d1": [10, 4], "intersect[shadow]": [10, 4], "shade.diffuse": [10, 4],
                    "frame": [10, 4]}


def test_spans_take_the_profilers_times_where_the_counts_agree():
    ann = [("frame", 1 * US, 999 * US), ("d1", 201 * US, 449 * US),
           ("d1", 3000 * US, 3100 * US)]
    moved = {r["name"]: r for r in spans.on_trace_clock(SPANS, ann)}
    assert (moved["frame"]["start_ns"], moved["frame"]["end_ns"]) == (1 * US, 999 * US)
    assert moved["d1"]["start_ns"] == 200 * US          # two events for one span
    assert moved["tonemap"] == SPANS[4]


def test_innermost_span_at_each_time():
    found = spans._innermost(SPANS, [250 * US, 50 * US, 650 * US, 2000 * US, 150 * US])
    assert [f and f["name"] for f in found] == ["d1", "frame", "frame", None, "intersect"]


def _ctx(cell):
    _wl, config, mix, _lim = harness.cell_files(harness.benchmark(), cell)
    for d, key in ((config, "config"), (mix, "mix")):
        d.update(SMALL[cell][key])
    return {"config": config, "mix": mix}


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_span_round_on_the_cpu(cell, capsys):
    """The round runs through the readers on the CPU: no device numbers,
    host times and counts; flat frames hand D1 one ray a pixel and keep all."""
    ctx = _ctx(cell)
    read = {m: harness.reader(m)(ctx) for m in (
        "shade_ms.frame", "shade_host_ms.frame", "composite_ms.frame",
        "composite_host_ms.frame", "d1_rays.frame", "d1_useful.frame")}
    assert read["shade_ms.frame"] is None and read["composite_ms.frame"] is None
    assert read["composite_host_ms.frame"] > 0
    pixels = ctx["config"]["render"]["width"] * ctx["config"]["render"]["height"]
    if cell.endswith("flat_orbit"):
        assert read["d1_rays.frame"] == pixels and read["d1_useful.frame"] == 100.0
        assert read["shade_host_ms.frame"] is None
    else:
        assert read["d1_rays.frame"] > pixels and 0 < read["d1_useful.frame"] < 100
        assert read["shade_host_ms.frame"] > 0
    err = capsys.readouterr().err
    assert "spans over 2 traced units" in err and "d1" in err


def test_a_program_without_spans_reads_nothing(monkeypatch):
    from voxel_tracer_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "take_spans")
    ctx = _ctx("glass_box_720p.flat_orbit")
    assert harness.reader("d1_rays.frame")(ctx) is None
    assert harness.reader("composite_host_ms.frame")(ctx) is None
    assert ctx["spans"] is None
