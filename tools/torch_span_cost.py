"""What the port's spans cost a frame: a benchmark cell's frames with spans
off and on, in turns, on one card.

Each turn renders whole laps of the cell's orbit one frame at a time (each
ended by a synchronize, as the benchmark's closed loop does), with
`utils/profiling` spans off or on; turns go off, on, on, off, and so on,
so both sides see the same frames and the card's drift falls on both.
Prints one JSON line: per cell and side the mean ms a frame of each turn,
their median, the p95 of all frames, and the on / off ratio of the
medians, with the card's name and power limit.  Beside them, the host
time of one span site with spans off (a loop of ``--site-calls``), the
spans a frame opens, and their product: what the span sites cost a frame
when spans are off.

    python3 tools/torch_span_cost.py [--cells whitted_orbit:1,flat_orbit:30]
        [--rounds 2] [--seed 3] [--out span_cost.json]

``--cells`` names each cell of `BENCHMARK.json` (without its
configuration's prefix) and the orbit laps of one turn.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def laps(cell, n, spans, profiling):
    """ms of each frame of ``n`` laps of the cell's orbit, and the spans
    they recorded."""
    import torch

    out = []
    ctx = profiling.recording() if spans else _Off()
    with ctx:
        for i in range(n * cell.positions):
            a = time.perf_counter()
            cell.frame(i)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - a) * 1e3)
    return out, len(profiling.take_spans())


def off_site_us(profiling, calls):
    """Host us of one span site with spans off (with an attribute, as the
    traversal sites have)."""
    t0 = time.perf_counter()
    for _ in range(calls):
        with profiling.annotate("intersect", kind="scan"):
            pass
    return (time.perf_counter() - t0) / calls * 1e6


class _Off:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


def main(argv=None):
    p = argparse.ArgumentParser(prog="torch_span_cost")
    p.add_argument("--cells", default="whitted_orbit:1,flat_orbit:30")
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--seed", type=int, default=3)
    p.add_argument("--config", default="glass_box_720p")
    p.add_argument("--site-calls", type=int, default=1_000_000)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import torch

    from port_bench import harness, loop, profile
    from port_bench.drivers.renderer_render import Cell
    from voxel_tracer_tpu_torch.utils import profiling

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    site_us = off_site_us(profiling, args.site_calls)
    result = {"device": torch.cuda.get_device_name(0), "power_limit_w": profile.power_limit_w(),
              "off_site_us": site_us, "cells": {}}
    for item in args.cells.split(","):
        name, n = item.split(":")
        full = f"{args.config}.{name}"
        _wl, config, mix, _lim = harness.cell_files(harness.benchmark(), full)
        cell = Cell(config, mix, args.seed, "cuda")
        sides = {"off": [], "on": []}
        frames = {"off": [], "on": []}
        recorded = 0
        for _ in range(args.rounds):
            for side in ("off", "on", "on", "off"):
                ms, count = laps(cell, int(n), side == "on", profiling)
                sides[side].append(statistics.fmean(ms))
                frames[side] += ms
                recorded += count
        cell.release()
        med = {s: statistics.median(v) for s, v in sides.items()}
        per_frame = recorded / len(frames["on"])
        result["cells"][full] = {
            "laps_a_turn": int(n), "turns": sides, "median_ms": med,
            "p95_ms": {s: loop.p95(v) for s, v in frames.items()},
            "on_over_off": med["on"] / med["off"], "spans_a_frame": per_frame,
            "off_sites_ms_a_frame": per_frame * site_us / 1e3}
        print(full, json.dumps(result["cells"][full]), file=sys.stderr)
    line = json.dumps(result)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
