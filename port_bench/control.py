"""Readings that set the limits of `correct` (not run by the benchmark).

    python -m port_bench.control --workload <cell> --seeds 1,2,3 \
        [--program] [--seconds 2]

For each seed, in one process: the cell's control, the reference
computed in bfloat16 storage (`reference.render.bf16`: every stage's
float outputs rounded to bfloat16) put in the program's place and
compared with the float32 reference by the cell's own numbers, on the
frames the seed checks.  With ``--program`` it reads the program's own
numbers instead: a whole run of the cell (`harness.run_cell`) with a
``--seconds`` window on each seed.
One JSON line a seed.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys

import torch

from port_bench import compare, harness
from port_bench.reference.render import bf16


def control_numbers(name, seed, device="cuda", overrides=None):
    """({"bf16": {number: value}}: the control on one seed as a run reads
    it, each number's worst over the seed's checked frames; {note:
    value}: the control by checked frame)."""
    _wl, config, mix, _limits = harness.cell_files(harness.benchmark(), name)
    for d, key in ((config, "config"), (mix, "mix")):
        d.update((overrides or {}).get(key, {}))
    driver = importlib.import_module(f"port_bench.drivers.{mix['driver']}")
    cell = driver.Cell(config, mix, seed, device)
    frames = [compare.frame_numbers(cell.reference(i, q=bf16)[0], cell.reference(i)[0])
              for i in cell.keeps]
    return {"bf16": compare.worst(frames)}, {"bf16_by_frame": dict(zip(cell.keeps, frames))}


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m port_bench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--program", action="store_true")
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        if args.program:
            result, _ = harness.run_cell(args.workload, seed, args.seconds, False)
            line = {"seed": seed, "program": {k: v["value"]
                                              for k, v in result["compared"].items()},
                    "correct": result["correct"]}
        else:
            readings, notes = control_numbers(args.workload, seed)
            line = {"seed": seed, **readings, **notes}
        line["workload"] = args.workload
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
