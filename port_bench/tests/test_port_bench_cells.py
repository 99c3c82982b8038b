"""Each cell runs whole on the CPU at a tiny size, through the port's plain
paths: set-up, window, traced readings where the CPU has any, and the
check, in which the reference agrees with the program."""

import json
import subprocess
import sys

import pytest

from port_bench import harness
from port_bench.tests.conftest import SMALL

SEED = 2 ** 31 + 17      # larger than 32 signed bits hold


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_cell_runs_and_agrees(cell):
    result, compared = harness.run_cell(cell, SEED, 0.2, False, "cpu", overrides=SMALL[cell])
    assert result["correct"] and result["attempted"] >= 1
    assert list(result)[-1] == "compared" and set(compared) == set(result["compared"])
    assert all(v == 0.0 or v < 1e-6 for v, _lim in compared.values())
    bench = harness.benchmark()
    wanted = {m["name"] for m in bench["end_to_end"] if cell in m.get("workloads", [cell])}
    assert set(result["metrics"]) == wanted
    assert all(m["value"] > 0 for m in result["metrics"].values())


def test_same_seed_same_inputs():
    """A seed gives the same scene and the same checked frames."""
    from port_bench.drivers.renderer_render import Cell
    cell = "glass_box_720p.flat_orbit"
    _wl, config, mix, _lim = harness.cell_files(harness.benchmark(), cell)
    for d, key in ((config, "config"), (mix, "mix")):
        d.update(SMALL[cell][key])
    a, b = (Cell(config, mix, SEED, "cpu") for _ in range(2))
    assert a.keeps == b.keeps
    assert all((a.raw[k] == b.raw[k]).all() for k in ("grid", "palette", "pos", "sky"))


def test_run_loads_no_forbidden_module():
    """A whole run, in a process of its own, leaves no module of JAX or of
    the JAX package loaded (top-level names compared whole)."""
    code = ("import json; from port_bench import harness; "
            "from port_bench.tests.conftest import SMALL; "
            "harness.run_cell('glass_box_720p.flat_orbit', 3, 0.1, False, 'cpu', "
            "overrides=SMALL['glass_box_720p.flat_orbit']); "
            "import sys; print(json.dumps([harness.forbidden_modules(), "
            "'voxel_tracer_tpu_torch' in sys.modules]))")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, check=True, timeout=300).stdout
    assert json.loads(out.strip().splitlines()[-1]) == [[], True]


@pytest.mark.parametrize("seed", [0, 7, SEED])
def test_checked_frames_spread_over_the_orbit(seed):
    """One checked frame in each equal stretch of the orbit, in an early lap."""
    from port_bench.drivers.renderer_render import checked_frames
    keeps = checked_frames(seed, 63, 3, 2)
    assert sorted(k % 63 // 21 for k in keeps) == [0, 1, 2] and max(keeps) < 2 * 63


def test_traced_frames_do_not_follow_the_seed():
    """The traced readings render the same frames on every seed."""
    from port_bench.drivers.renderer_render import Cell
    cell = "glass_box_720p.whitted_orbit"
    _wl, config, mix, _lim = harness.cell_files(harness.benchmark(), cell)
    for d, key in ((config, "config"), (mix, "mix")):
        d.update(SMALL[cell][key])
    units = {tuple(Cell(config, mix, s, "cpu").trace_units) for s in (1, SEED)}
    assert units == {(0, 2)}
