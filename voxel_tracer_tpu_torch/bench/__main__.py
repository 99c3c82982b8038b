"""Command line of the suite (the counterpart of `bench_suite.py:609-650`).

    python -m voxel_tracer_tpu_torch.bench [--one NAME] [--seed S] [--out PATH]
                                           [--rounds R] [--profile-frames F]
                                           [--one-process]

With no ``--one`` it runs every workload of `workloads.WORKLOADS`, each in
its own subprocess, one after the other, and prints each one's JSON line
as it ends; ``--one NAME`` runs one workload in this process.  ``--out``
also writes the list of lines to PATH as JSON.  Each line carries the
seconds its workload took, with its own process's start where it has
one (`process_s`).
``--rounds`` sets the timed rounds of each frame count (default
`measure.ROUNDS`) and ``--profile-frames`` the frames of the profiler
window (default `measure.PROFILE_FRAMES`); ``--one-process`` runs every
workload in this process, one after the other, so that only the first
line's `setup_s` includes loading the kernels.  `chip_smoke.py` uses all
three to check every workload within its time limit.  The exit
code is non-zero if any workload raises or reads ``correct: false``, and
without a CUDA device, where nothing runs: a time taken on the CPU is not
a device metric.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time
import traceback

import torch

from voxel_tracer_tpu_torch.bench import measure
from voxel_tracer_tpu_torch.bench.workloads import WORKLOADS

CHILD_TIMEOUT_S = 1800


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


def run_one(name, seed, rounds, profile_frames):
    """One workload in this process: its JSON line (an error line if it
    raised)."""
    try:
        return measure.measure_workload(WORKLOADS[name], seed, rounds, profile_frames,
                                        log=lambda m: _log(f"[{name}] {m}"))
    except Exception:
        _log(traceback.format_exc())
        return {"metric": name, "correct": False,
                "error": traceback.format_exc(limit=3)[-600:]}


def run_child(name, seed, rounds, profile_frames):
    """One workload in a subprocess of its own: its JSON line (an error
    line if the process failed or printed none)."""
    cmd = [sys.executable, "-m", "voxel_tracer_tpu_torch.bench", "--one", name,
           "--seed", str(seed), "--rounds", str(rounds), "--profile-frames",
           str(profile_frames)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=CHILD_TIMEOUT_S, env=dict(os.environ))
        out, err, rc = proc.stdout, proc.stderr, proc.returncode
    except subprocess.TimeoutExpired as e:
        out, err, rc = e.stdout or "", f"timed out after {CHILD_TIMEOUT_S} s", None
        out = out.decode() if isinstance(out, bytes) else out
    line = None
    for text in reversed(out.strip().splitlines()):
        try:
            line = json.loads(text)
            break
        except ValueError:
            continue
    if line is None or rc != 0:
        _log(f"[{name}] exit code {rc}:\n{(err or '')[-3000:]}")
    if line is None:
        line = {"metric": name, "correct": False,
                "error": f"exit code {rc}: {(err or out)[-300:]}"}
    return line


def run_all(seed, rounds, profile_frames, one_process=False):
    """Every workload in order, each in a subprocess of its own (or all in
    this one); the kernels are built here once first, so no two
    processes build them."""
    from voxel_tracer_tpu_torch.ops.cuda import _build
    _build.build()
    lines = []
    for name in WORKLOADS:
        t0 = time.perf_counter()
        if one_process:
            line = run_one(name, seed, rounds, profile_frames)
            gc.collect()
            torch.cuda.empty_cache()
        else:
            line = run_child(name, seed, rounds, profile_frames)
        line["process_s"] = time.perf_counter() - t0
        lines.append(line)
        print(json.dumps(line), flush=True)
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--one", choices=list(WORKLOADS), help="run this workload only")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", help="also write the JSON lines to this file")
    ap.add_argument("--rounds", type=int, default=measure.ROUNDS,
                    help="timed rounds of each frame count")
    ap.add_argument("--profile-frames", type=int, default=measure.PROFILE_FRAMES,
                    help="frames of the profiler window")
    ap.add_argument("--one-process", action="store_true",
                    help="run every workload in this process")
    args = ap.parse_args(argv)
    if args.rounds < 1 or args.profile_frames < 1:
        ap.error("--rounds and --profile-frames must be at least 1")
    if not torch.cuda.is_available():
        print("voxel_tracer_tpu_torch.bench: no CUDA device; the suite measures the card "
              "and does not run on the CPU", file=sys.stderr)
        return 2
    if args.one:
        lines = [run_one(args.one, args.seed, args.rounds, args.profile_frames)]
        print(json.dumps(lines[0]), flush=True)
    else:
        lines = run_all(args.seed, args.rounds, args.profile_frames, args.one_process)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(lines, f, indent=1)
    return 0 if all(ln.get("correct") is True for ln in lines) else 1


if __name__ == "__main__":
    sys.exit(main())
