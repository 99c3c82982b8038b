"""The command line of one run (see the package docstring)."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def parse(argv):
    p = argparse.ArgumentParser(prog="python -m port_bench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _environment():
    """The port reads its .vox and noise assets only where the asset
    variable names them, so both sides use the procedural stand-ins."""
    os.environ.pop("VOXEL_TRACER_ASSET_DIR", None)


def main(argv=None, t0=None):
    t0 = time.perf_counter() if t0 is None else t0
    args = parse(argv)
    _environment()
    import torch

    from port_bench import harness

    wl = {w["name"]: w for w in harness.benchmark()["workloads"]}.get(args.workload)
    if wl is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print(f"{args.workload} needs {wl['chips']} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, compared = harness.run_cell(args.workload, args.seed, args.seconds,
                                        bool(args.trace), "cuda", t0)
    print(f"device {torch.cuda.get_device_name(0)}, power limit "
          f"{harness.profile.power_limit_w()} W; peaks 3.35 TB/s, 67 TFLOP/s float32; "
          f"phases {json.dumps(result['phase_s'])}", file=sys.stderr)
    bad = harness.forbidden_modules()
    if bad:
        print(f"the run loaded forbidden modules: {', '.join(bad)}", file=sys.stderr)
        return 3
    for k, (v, lim) in compared.items():
        print(f"{k} {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0
