"""The cell `drone_scene_720p.game` on the CPU at a tiny size, through the
port's plain paths: a whole run agrees with the reference of rigid
volumes, a seed gives the same scene, transforms and checked frames, the
span round reads the cell's own metrics, the bfloat16 control fails, and
the scene and the reference load nothing of the program."""

import json
import subprocess
import sys

import numpy as np
import pytest

from port_bench import control, harness

CELL = "drone_scene_720p.game"
SEED = 2 ** 31 + 17      # larger than 32 signed bits hold
# the cell cut down so that a run takes seconds on the CPU
GAME = {"config": {"grid": 32, "drone_grid": 4, "render": {
    "width": 48, "height": 32, "shading": "full", "max_steps": 256, "max_candidates": 4,
    "max_bounces": 2, "glass_reflections": 2, "tonemapper": "aces", "ambient": 0.2,
    "accumulate": False, "compact": False}},
    "mix": {"orbit_positions": 4, "check_frames": 2, "check_laps": 1, "warmup_frames": 1,
            "trace_positions": 2, "trace_repeats": 1}}


def _files():
    _wl, config, mix, limits = harness.cell_files(harness.benchmark(), CELL)
    for d, key in ((config, "config"), (mix, "mix")):
        d.update(GAME[key])
    return config, mix, limits


def test_cell_runs_and_agrees():
    result, compared = harness.run_cell(CELL, SEED, 0.2, False, "cpu", overrides=GAME)
    assert result["correct"] and result["attempted"] >= 1
    assert set(compared) == set(_files()[2])
    assert all(v == 0.0 for v, _lim in compared.values())
    assert set(result["metrics"]) == {"frame_ms", "frame_ms_p95", "setup_s"}
    assert all(m["value"] > 0 for m in result["metrics"].values())


def test_same_seed_same_scene_transforms_and_frames():
    from port_bench.drivers.renderer_game import Cell
    config, mix, _lim = _files()
    a, b = (Cell(config, mix, SEED, "cpu") for _ in range(2))
    assert a.keeps == b.keeps and a.movers == b.movers
    for va, vb in zip(a.raw["volumes"], b.raw["volumes"]):
        assert all(np.array_equal(va[k], vb[k]) for k in ("grid", "palette", "pos", "rot"))
    for i in a.keeps:
        for (ra, pa), (rb, pb) in zip(a.view(i)[3], b.view(i)[3]):
            assert np.array_equal(ra, rb) and np.array_equal(pa, pb)
        fa, fb = a.frame(i), b.frame(i)
        assert all(np.array_equal(fa[k].numpy(), fb[k].numpy()) for k in ("image", "depth"))
    other = Cell(config, mix, SEED + 1, "cpu")
    assert not np.array_equal(a.raw["volumes"][1]["palette"], other.raw["volumes"][1]["palette"])


def test_every_volume_has_its_own_palette_and_the_drones_turn():
    from port_bench.scenes import drone_scene
    raw = drone_scene.build(_files()[0], SEED)
    pals = [v["palette"] for v in raw["volumes"]]
    assert len({p.tobytes() for p in pals}) == 5
    yaws = {round(float(np.arctan2(r[0, 2], r[0, 0])), 4)
            for j in range(3) for r, _p in drone_scene.transforms(raw, j, 63)}
    assert len(yaws) == 12


def test_span_round_reads_the_cells_metrics(capsys):
    config, mix, _lim = _files()
    ctx = {"config": config, "mix": mix}
    read = {m: harness.reader(m)(ctx) for m in (
        "topk_ms.frame", "topk_host_ms.frame", "scene_update_host_ms.frame",
        "dda_tables.frame", "d1_rays.frame")}
    assert read["topk_ms.frame"] is None              # no device numbers on the CPU
    assert read["topk_host_ms.frame"] > 0 and read["scene_update_host_ms.frame"] > 0
    assert read["dda_tables.frame"] == 0
    assert read["d1_rays.frame"] > 48 * 32
    err = capsys.readouterr().err
    assert "topk" in err and "scene.update" in err


def test_control_fails():
    readings, _notes = control.control_numbers(CELL, SEED, "cpu", GAME)
    limits = _files()[2]
    assert any(readings["bf16"][k] > limits[k] for k in limits), readings


@pytest.mark.parametrize("module", ["port_bench.scenes.drone_scene",
                                    "port_bench.reference.rigid"])
def test_scene_and_reference_load_nothing_of_the_program(module):
    code = (f"import json, sys; import {module}; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, check=True).stdout
    assert not set(json.loads(out)) & {"voxel_tracer_tpu_torch", "voxel_tracer_tpu", "jax"}
