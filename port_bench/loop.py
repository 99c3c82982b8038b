"""The closed loop of a frame cell, and the statistics of its window."""

from __future__ import annotations

import math
import sys
import time

import torch


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def closed_loop(frame, seconds, last, store, device):
    """Frames ``frame(i)`` one at a time, each ended by a synchronize,
    until ``seconds`` have passed and frame ``last`` has run; each frame's
    index and output go to ``store``, which keeps what it checks.  Returns
    (frames, window seconds, each frame's latency in s)."""
    lat = []
    sync(device)
    t0 = time.perf_counter()
    i = 0
    while True:
        a = time.perf_counter()
        out = frame(i)
        sync(device)
        b = time.perf_counter()
        lat.append(b - a)
        store(i, out)
        i += 1
        if b - t0 >= seconds and i > last:
            return i, b - t0, lat


def p95(values):
    """The 95th percentile by nearest rank."""
    s = sorted(values)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


def chunk_ms(lat, chunk_s=5.0):
    """Mean ms of each ``chunk_s`` stretch of a window's units, for the
    run's log: whether its time drifts within the window."""
    out, acc, n = [], 0.0, 0
    for x in lat:
        acc, n = acc + x, n + 1
        if acc >= chunk_s:
            out.append(round(acc / n * 1e3, 3))
            acc, n = 0.0, 0
    return out + ([round(acc / n * 1e3, 3)] if n else [])


def frame_metrics(frames, window_s, lat):
    print(f"window: {frames} frames, ms a frame by 5 s: {chunk_ms(lat)}", file=sys.stderr)
    return {"frame_ms": window_s / frames * 1e3, "frame_ms_p95": p95(lat) * 1e3}
