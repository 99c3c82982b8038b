"""The benchmark's files: every name in BENCHMARK.json resolves to its file,
the file keeps the contract's shapes, and the reference imports nothing of
the program."""

import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from port_bench import harness

HERE = Path(harness.__file__).resolve().parent
ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["port_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all(not w.startswith("/") and ".." not in w for w in BENCH["command"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves(cell):
    wl, config, mix, limits = harness.cell_files(BENCH, cell)
    assert set(wl) == {"name", "config", "traffic", "chips", "why"}
    assert wl["chips"] == 1 and len(wl["why"]) <= 200
    assert config["name"] == wl["config"]
    assert (HERE / "drivers" / f"{mix['driver']}.py").is_file()
    assert (HERE / "scenes" / f"{config['scene']}.py").is_file()
    assert limits and all(v > 0 for v in limits.values())


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    path = ROOT / entry["file"]
    assert path.parent == HERE / "configs" and path.is_file()
    config = json.loads(path.read_text())
    assert config["name"] == entry["name"] and config["reduced"] == entry["reduced"]
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_reader(metric):
    assert callable(harness.reader(metric["name"]))
    moves = {m["name"]: m for m in BENCH["end_to_end"]}[metric["moves"]]
    assert set(metric["workloads"]) <= set(moves["workloads"])


def test_names_units_and_bounds():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["name"] for w in BENCH["workloads"]] + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & {"voxel_tracer_tpu_torch", "voxel_tracer_tpu", "jax", "jaxlib", "flax"}


def test_reference_loads_nothing_of_the_program():
    code = ("import json, sys; import port_bench.reference.render; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True).stdout
    assert not set(json.loads(out)) & {
        "voxel_tracer_tpu_torch", "voxel_tracer_tpu", "jax"}


def test_forbidden_names_are_whole():
    assert harness.forbidden_modules(["voxel_tracer_tpu_torch.ops", "jaxtyping", "torch"]) == []
    assert harness.forbidden_modules(["jax.numpy", "voxel_tracer_tpu.ops"]) == [
        "jax", "voxel_tracer_tpu"]


def test_command_refuses_the_cpu(monkeypatch, capsys):
    from port_bench import run
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    rc = run.main(["--workload", BENCH["workloads"][0]["name"], "--seed", "2147483649",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""


@pytest.mark.cuda
def test_checkout_without_the_program_fails(tmp_path, card):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files the command exits non-zero and prints no result."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run(BENCH["command"] + ["--workload", BENCH["workloads"][0]["name"],
                                           "--seed", "5", "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, capture_output=True, text=True, timeout=600)
    assert p.returncode != 0 and p.stdout.strip() == ""
