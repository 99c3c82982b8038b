"""How the suite measures a workload on the card (`measure_workload`).

- Set-up: the workload function and one warm-up frame or step (which
  loads the kernels), on the host clock: `setup_s`.  Peak device memory
  from `torch.cuda.reset_peak_memory_stats` before the set-up to the end
  of the timed rounds: `peak_mem_bytes`.
- Eager time, what a caller of the entry point gets: K serialized frames
  on one stream between two CUDA events (`cuda_ms`), at two counts, K / 4
  and K, in alternating rounds (`alternating_rounds`).  Host-bound frames
  move with the host by 10-20 % from one second to the next, so the two
  counts sample the same stretch of host time; a pair of means that
  disagrees by more than `SLOPE_RTOL` is measured again.  `ms` is the
  median and quartiles of the K-frame rounds' ms per frame; `value`
  derives from the median.
- One-launch time (workloads with a `graph_frame`): K frames captured in
  one `torch.cuda.CUDAGraph`, each frame's camera taking the previous
  frame's first pixel x 1e-38, replayed at two counts: `graph_*`.
- The first timed frame or step is held against the plain version on the
  same inputs (the workload's `check`).
- Split of device time: 8 frames in a profiler window
  (`kernel_split`): busy time, kernels a frame, device ms a frame of each
  hand-written kernel by its symbol (`KERNEL_LABELS`), the rest as glue
  with its five longest kernels.  End-to-end times come from the
  unprofiled rounds only, and so does the idle share: 1 - busy / the
  median ms, unclamped (a kernel-bound frame's spans can outlast its
  CUDA-event time by a few microseconds, and then it reads below 0).
  The window is `utils.timer.device_window`.  The profiler slows the
  host, the more the more launches a frame has (`profiled_wall_ms`).
- Host syncs of one frame (`count_host_syncs`) and the card's identity
  (`device_identity`).

Every function that measures needs a CUDA device and raises without one
(`require_cuda`): a time taken on the CPU is not a device metric.
"""

from __future__ import annotations

import re
import subprocess
import time
import warnings
from typing import Callable, NamedTuple

import numpy as np
import torch

from voxel_tracer_tpu_torch.utils.timer import busy_ms as _busy_ms, device_window

SLOPE_RTOL = 0.10       # per-frame times at two frame counts agree within this
ROUNDS = 5              # rounds of each frame count
ATTEMPTS = 3            # pairs of means measured before a disagreement is reported
PROFILE_FRAMES = 8
PROFILE_WINDOWS = 3     # windows tried before device time is "not measured"
GRAPH_FRAMES = 64
GRAPH_REPLAYS = (1, 4)
TOP_GLUE = 5
NOT_MEASURED = "not measured"
SYNC_WARNING = "called a synchronizing CUDA operation"   # PyTorch's sync debug mode

# the hand-written kernels by the symbol the profiler prints, and the
# TPU kernel (B) or XLA loop (D) each replaces (PERF.md's tables); D1's
# passes share its label (pass 1 a template on where the block reads the
# brick bitmap from); D2's templates (on the float4 record, on the plain
# grids) share D2's, and so does the record's pack (the forward launches
# it; D3 reads the same record)
KERNEL_LABELS = {
    "mega_camera_kernel": "B1",
    "mega_rays_kernel": "B2",
    "indep_camera_kernel": "B3",
    "indep_rays_kernel": "B4",
    "coherent_kernel": "B5",
    "integrate_kernel<false>": "B6",
    "integrate_kernel<true>": "B7",
    "dda_kernel<true>": "D1",
    "dda_kernel<false>": "D1",
    "dda_exhaust_kernel": "D1",
    "diff_fwd_kernel<true>": "D2",
    "diff_fwd_kernel<false>": "D2",
    "diff_pack_kernel": "D2",
    "diff_bwd_kernel": "D3",
}
# a kernel's symbol as the profiler prints it, e.g.
# "void (anonymous namespace)::integrate_kernel<true>((anonymous namespace)::Params)"
_SYMBOL = re.compile(r"(?<!\w)(" + "|".join(re.escape(k) for k in KERNEL_LABELS)
                     + r")(?![\w<])")


def require_cuda():
    """Raise unless a CUDA device is present."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the suite measures the card and does "
                           "not run on the CPU")


def nvidia_smi() -> str:
    """The card's name and power limit, as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def device_identity() -> dict:
    """{"name", "count", "power_limit_w"} of the card (power limit from
    nvidia-smi; null where it prints none)."""
    require_cuda()
    m = re.search(r"([\d.]+)\s*W", nvidia_smi())
    return {"name": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
            "power_limit_w": float(m.group(1)) if m else None}


def cuda_ms(fn, reps):
    """Device time per call of ``fn(i)`` over ``reps`` serialized calls."""
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for i in range(reps):
        fn(i)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


class Rounds(NamedTuple):
    per: tuple          # ([ms a frame of each round at counts[0]], [... at counts[1]])
    ms: list            # each count's mean ms a frame over its rounds
    agree: bool         # the two means within SLOPE_RTOL
    attempts: int       # pairs of means measured


def alternating_rounds(frame, counts, rounds, attempts=ATTEMPTS, clock=cuda_ms, log=None):
    """Per-frame ms of ``frame(i)`` at two frame counts, ``rounds`` rounds
    each, the counts in turns and in alternating order; each count's mean
    over its rounds, and whether they agree within SLOPE_RTOL.  A pair that
    disagrees is measured again, up to ``attempts`` pairs.  ``clock(frame,
    n)`` gives ms a frame over n serialized frames (`cuda_ms`)."""
    for attempt in range(1, attempts + 1):
        per = ([], [])
        for r in range(rounds):
            for j in ((0, 1) if r % 2 == 0 else (1, 0)):
                per[j].append(clock(frame, counts[j]))
        ms = [float(np.mean(p)) for p in per]
        agree = abs(ms[1] - ms[0]) <= SLOPE_RTOL * ms[1]
        if agree:
            break
        if log is not None:
            log(f"timing {ms[0]:.4f} vs {ms[1]:.4f} ms/frame disagree (rounds "
                f"{[round(v, 1) for v in per[0]]} and {[round(v, 1) for v in per[1]]}); "
                "again")
    return Rounds(per, ms, agree, attempt)


def quartiles(samples) -> dict:
    """Median, first and third quartile and count of ``samples``."""
    q1, med, q3 = np.percentile(np.asarray(samples, np.float64), [25, 50, 75])
    return {"median": float(med), "q1": float(q1), "q3": float(q3), "n": len(samples)}


def label_of(kernel_name: str):
    """The label (B1-B7, D1-D3) of a profiler kernel name, or None for glue."""
    m = _SYMBOL.search(kernel_name)
    return KERNEL_LABELS[m.group(1)] if m else None


def split_events(events, frames, wall_ms) -> dict:
    """The per-frame split of one profiler window's device events, given
    as (name, start us, end us): busy time (the union of the spans,
    `utils.timer.busy_ms`), idle share against ``wall_ms`` for the
    ``frames`` frames (below 0 where the spans outlast ``wall_ms``),
    events a frame, device ms a frame by label, the rest as glue and its
    TOP_GLUE longest kernels by total device time."""
    busy_ms = _busy_ms(events)
    by_label, glue = {}, {}
    for name, a, b in events:
        label = label_of(name)
        into = by_label if label else glue
        key = label or name
        into[key] = into.get(key, 0.0) + (b - a) / 1e3
    top = sorted(glue.items(), key=lambda kv: -kv[1])[:TOP_GLUE]
    kernel_ms = {k: v / frames for k, v in sorted(by_label.items())}
    return {"device_busy_ms": busy_ms / frames, "idle_share": 1.0 - busy_ms / wall_ms,
            "kernels_per_frame": len(events) / frames, "kernel_ms": kernel_ms,
            "glue_ms": (busy_ms - sum(by_label.values())) / frames,
            "top_glue": [{"name": n, "ms": v / frames} for n, v in top]}


def kernel_split(fn, frames, frame_ms, windows=PROFILE_WINDOWS) -> dict:
    """`split_events` of ``fn()`` (which runs ``frames`` frames) in a
    `device_window`, its idle share against ``frame_ms`` a frame measured
    with the profiler off; a window without device events is profiled
    again, up to ``windows`` windows, and every figure reads NOT_MEASURED
    if none shows any."""
    require_cuda()
    for _ in range(windows):
        wall_ms, events = device_window(fn)
        if events:
            return dict(split_events(events, frames, frames * frame_ms),
                        profiled_wall_ms=wall_ms / frames)
    return {k: NOT_MEASURED for k in ("device_busy_ms", "idle_share", "kernels_per_frame",
                                      "kernel_ms", "glue_ms", "top_glue")}


def count_host_syncs(fn):
    """Host syncs of ``fn()`` on a CUDA device: the synchronizing calls
    PyTorch's sync debug mode reports (device-to-host copies, `nonzero`,
    `.item()`), each as a "called a synchronizing CUDA operation" warning.
    The mode's own notice on first use ("... does not yet detect all
    synchronizing operations") is no sync."""
    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode(1)
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    return sum(SYNC_WARNING in str(c.message) for c in caught)


def _timed(wl, rounds, log):
    """Alternating rounds of ``wl``'s frames; returns (Rounds, the first
    timed frame's output, the state it started from)."""
    state = wl.snapshot()
    first = []

    def frame(i):
        out = wl.frame(i)
        if not first:
            first.append(out)
        return out

    r = alternating_rounds(frame, (max(1, wl.frames // 4), wl.frames), rounds, log=log)
    return r, first[0], state


def _timing_fields(wl, r, prefix=""):
    stats = quartiles(r.per[1])
    ms = stats["median"]
    return {f"{prefix}ms": stats, f"{prefix}frames_per_round": [max(1, wl.frames // 4),
                                                                 wl.frames],
            f"{prefix}means_ms": r.ms, f"{prefix}counts_agree": r.agree,
            f"{prefix}attempts": r.attempts}, wl.work / (ms / 1e3)


def graph_time(graph_frame, work, rounds, frames=GRAPH_FRAMES, log=None) -> dict:
    """One-launch time: ``frames`` calls of ``graph_frame(i, c)`` captured
    in one CUDA graph, each taking the previous one's result ``c`` (a
    0-dim tensor, one more a frame), replayed at GRAPH_REPLAYS counts in
    alternating rounds.  A capture that fails raises."""
    require_cuda()
    c0 = torch.zeros((), device="cuda")
    g = torch.cuda.CUDAGraph()
    torch.cuda.synchronize()
    with torch.cuda.graph(g):
        c = c0
        for i in range(frames):
            c = graph_frame(i, c)
    g.replay()
    torch.cuda.synchronize()
    if abs(float(c) - frames) > 1e-3 * frames:
        raise RuntimeError(f"the graph's {frames} frames returned {float(c)}")
    r = alternating_rounds(lambda i: g.replay(), GRAPH_REPLAYS, rounds, log=log)
    stats = quartiles([v / frames for v in r.per[1]])
    return {"graph_ms": stats, "graph_frames": frames, "graph_replays": list(GRAPH_REPLAYS),
            "graph_counts_agree": r.agree, "graph_value": work / (stats["median"] / 1e3)}


def _merge_check(line, name, chk):
    """Add one check to the line: `correct` holds only if every check
    does; `worst` is the figure nearest its limit over all checks."""
    line.setdefault("checks", {})[name] = chk
    line["correct"] = line.get("correct", True) and chk["correct"]
    if "worst" not in line or chk["worst"]["ratio"] > line["worst"]["ratio"]:
        line["worst"] = dict(chk["worst"], check=name)


def measure_workload(make: Callable, seed: int = 0, rounds: int = ROUNDS,
                     profile_frames: int = PROFILE_FRAMES, log=None) -> dict:
    """The workload ``make(device, seed)`` builds, on the card: the JSON
    line's fields (module docstring), with the host seconds of each step
    of the measurement (`phase_s`)."""
    require_cuda()
    phase_s = {}
    clock = [time.perf_counter()]

    def lap(step):
        now = time.perf_counter()
        phase_s[step] = now - clock[0]
        clock[0] = now

    torch.cuda.reset_peak_memory_stats()
    wl = make("cuda", seed)
    for w in (wl, *wl.subs.values()):
        w.frame(0)                                  # warm-up: loads the kernels
    torch.cuda.synchronize()
    lap("setup")
    line = {"metric": wl.metric, "jax_metric": wl.jax_metric, "seed": seed,
            "setup_s": phase_s["setup"]}
    r, first, state = _timed(wl, rounds, log)
    fields, value = _timing_fields(wl, r)
    line.update(value=value, unit=wl.unit, **fields)
    line["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    lap("timing")
    _merge_check(line, wl.metric, wl.check(0, state, first))
    del first, state
    lap("check")
    for sub_name, sub in wl.subs.items():
        r, first, state = _timed(sub, rounds, log)
        fields, value = _timing_fields(sub, r, prefix=f"{sub_name}_")
        line[sub_name] = value
        line.update(fields)
        _merge_check(line, sub_name, sub.check(0, state, first))
        del first, state
    lap("subs")
    if wl.graph_frame is not None:
        gt = graph_time(wl.graph_frame, wl.work, rounds, log=log)
        line["graph_rays_per_s"] = gt.pop("graph_value")
        line.update(gt)
    lap("graph")
    line.update(kernel_split(lambda: [wl.frame(i) for i in range(profile_frames)],
                             profile_frames, line["ms"]["median"]))
    line["profile_frames"] = profile_frames
    lap("profile")
    line["host_syncs_per_frame"] = count_host_syncs(lambda: wl.frame(0))
    lap("syncs")
    line.update(wl.info)
    line["device"] = device_identity()
    line["phase_s"] = phase_s
    return line
