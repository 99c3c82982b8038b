"""One run of one cell: set-up, the measured window, the traced readings,
the check against the reference, and the result line.

Everything a cell needs is found by name from `BENCHMARK.json`: its
configuration (`configs/<config>.json`), its traffic mix
(`mixes/<traffic>.json`, which names the driver, `drivers/<driver>.py`),
the limits of the numbers its check compares (`limits/<cell>.json`) and
each per-layer metric's reader (`metrics/<metric>.py`).
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

import torch

from port_bench import loop, profile

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names the run must not have loaded, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "voxel_tracer_tpu")


def load_json(*parts):
    with open(HERE.joinpath(*parts)) as f:
        return json.load(f)


def benchmark():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def cell_files(bench, name):
    """(workload entry, configuration, mix, limits) of the cell ``name``."""
    wl = {w["name"]: w for w in bench["workloads"]}[name]
    return (wl, load_json("configs", f"{wl['config']}.json"),
            load_json("mixes", f"{wl['traffic']}.json"), load_json("limits", f"{name}.json"))


def reader(metric):
    """The `read` function of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"port_bench.metrics.{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _applies(metric, name, reported):
    if "workloads" in metric:
        return name in metric["workloads"]
    return metric.get("moves", metric["name"]) in reported


def forbidden_modules(modules=None):
    """The forbidden top-level names among the loaded modules."""
    tops = {m.split(".")[0] for m in (sys.modules if modules is None else modules)}
    return sorted(tops & set(FORBIDDEN))


def traced(cell, mix):
    """The per-layer readings' context, all taken over the cell's fixed
    trace units (the same for every seed): their ms a unit with the
    profiler off, a device-only window of ``trace_repeats`` rounds of them,
    one round with host ops for the idle gaps, and their host syncs."""
    units, reps = cell.trace_units, mix["trace_repeats"]
    n = reps * len(units)

    def rounds():
        for _ in range(reps):
            cell.run(units)

    loop.sync(cell.device)
    t0 = time.perf_counter()
    rounds()
    unit_ms = (time.perf_counter() - t0) / n * 1e3
    wall_ms, events = profile.device_window(rounds)
    split = profile.split_events(events, n) if events else None
    _w, dev, host = profile.device_window(lambda: cell.run(units), with_host=True)
    gaps = profile.idle_gaps(dev, host) if dev else []
    syncs = profile.count_host_syncs(lambda: cell.run(units))
    return {"split": split, "unit_ms": unit_ms, "syncs": syncs / len(units),
            "window_s": wall_ms / 1e3, "gaps": gaps}


def run_cell(name, seed, seconds, trace, device="cuda", t0=None, overrides=None):
    """One run of cell ``name``: (result dict, {number: (value, limit)}).
    ``overrides`` updates the configuration and mix (small sizes for the
    CPU tests)."""
    t0 = time.perf_counter() if t0 is None else t0
    bench = benchmark()
    wl, config, mix, limits = cell_files(bench, name)
    for d, key in ((config, "config"), (mix, "mix")):
        d.update((overrides or {}).get(key, {}))
    driver = importlib.import_module(f"port_bench.drivers.{mix['driver']}")
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    cell = driver.Cell(config, mix, seed, device)
    setup_s = time.perf_counter() - t0
    gc.collect()
    gc.freeze()
    units, e2e = cell.window(seconds)
    gc.unfreeze()
    e2e["setup_s"] = setup_s
    phase_s = {"setup": setup_s, "window": time.perf_counter() - t0 - setup_s}
    phase_s.update({f"setup.{k}": v for k, v in getattr(cell, "setup_phases", {}).items()})
    ctx = traced(cell, mix) if trace else None
    dev_info = {"platform": "gpu" if cuda else "cpu",
                "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                "count": wl["chips"],
                "memory_peak_bytes": torch.cuda.max_memory_allocated() if cuda else 0}
    t1 = time.perf_counter()
    phase_s["trace"] = t1 - t0 - phase_s["setup"] - phase_s["window"]
    cell.release()
    numbers, work = cell.check(trace)
    phase_s["check"] = time.perf_counter() - t1
    compared = {k: (numbers[k], limits[k]) for k in limits}
    correct = all(v <= lim for v, lim in compared.values())
    result = {"correct": correct, "attempted": units, "failed": 0 if correct else 1}
    if trace:
        ctx.update(work=work, config=config, mix=mix)
        metrics = {}
        for m in bench["per_layer"]:
            if _applies(m, name, e2e):
                v = reader(m["name"])(ctx)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        split = ctx["split"]
        dev_info.update(busy_s=split["window_busy_s"] if split else 0.0,
                        window_s=ctx["window_s"])
        result["metrics"] = metrics
        result["device"] = dev_info
        result["breakdown"] = {"device_ops": split["device_ops"] if split else [],
                               "idle_gaps": ctx["gaps"]}
    else:
        result["metrics"] = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                             for m in bench["end_to_end"] if _applies(m, name, e2e)}
        result["device"] = dev_info
    result["phase_s"] = phase_s
    result["compared"] = {k: {"value": v, "limit": lim} for k, (v, lim) in compared.items()}
    return result, compared
