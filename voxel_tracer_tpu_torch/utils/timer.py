"""Timing utilities (template/precomp.h:162-173 Timer + dev/gui.cpp EMA FPS
analog), plus a device timer for benchmarks.

Counterpart of `voxel_tracer_tpu/utils/timer.py`.  PyTorch returns from a
CUDA call before the card has run it, so `_force_sync` waits for the
card, `device_time` times serialized calls with CUDA events, and
`device_busy` reads the card's busy time from a profiler window that
records the card's activity only (`device_window`, `busy_ms`).
"""

from __future__ import annotations

import time

import torch


class Timer:
    """Elapsed-seconds timer (Timer analog)."""

    def __init__(self):
        self.start = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self.start

    def reset(self) -> float:
        now = time.perf_counter()
        dt, self.start = now - self.start, now
        return dt


class EmaFps:
    """Exponential-moving-average frame-rate tracker (dev/gui.cpp:35-48)."""

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self.frame_time = None

    def update(self, dt: float) -> float:
        if self.frame_time is None:
            self.frame_time = dt
        else:
            self.frame_time = (1 - self.alpha) * self.frame_time + self.alpha * dt
        return self.fps

    @property
    def fps(self) -> float:
        return 1.0 / self.frame_time if self.frame_time else 0.0


def _first_tensor(out):
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, dict):
        out = list(out.values())
    for x in out if isinstance(out, (list, tuple)) else ():
        t = _first_tensor(x)
        if t is not None:
            return t
    return None


def _force_sync(out):
    """Wait until the work that produced ``out`` (a tensor, or a dict,
    list or tuple holding tensors) has finished: `torch.cuda.synchronize`
    on the device of its first tensor if that is a CUDA tensor.  Returns
    that tensor's first element on the host (None if there is none)."""
    t = _first_tensor(out)
    if t is None:
        return None
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    return t.reshape(-1)[0].item() if t.numel() else None


def device_time(fn, *args, warmup: int = 2, iters: int = 10):
    """Seconds per call of ``fn(*args)`` and its last output, after
    ``warmup`` calls.  Where the output lies on a CUDA device: CUDA
    events around ``iters`` serialized calls; elsewhere the host clock
    around them."""
    out = fn(*args)
    for _ in range(warmup - 1):
        out = fn(*args)
    _force_sync(out)
    t = _first_tensor(out)
    if t is None or not t.is_cuda:
        clock = Timer()
        for _ in range(iters):
            out = fn(*args)
            _force_sync(out)
        return clock.elapsed() / iters, out
    with torch.cuda.device(t.device):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            out = fn(*args)
        end.record()
        end.synchronize()
    return start.elapsed_time(end) / 1e3 / iters, out


def busy_ms(events) -> float:
    """Device-busy ms of (name, start us, end us) events: the length of
    the union of their spans."""
    busy, end = 0.0, -float("inf")
    for a, b in sorted((a, b) for _n, a, b in events):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3


def _device_events(results):
    """(name, start us, end us) of the kernels, copies and sets the card
    ran in a profiler window, read from its raw Kineto results (cheap: no
    FunctionEvent tree is built); GPU user annotations (an optimizer's
    step range, say) are spans over other events and left out."""
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for e in results.events():
        if e.device_type() == cuda and not e.is_user_annotation():
            a = e.start_ns() / 1e3
            out.append((e.name(), a, a + e.duration_ns() / 1e3))
    return out


def device_window(fn):
    """(host ms, device events) of ``fn()`` in one profiler window that
    records the card's activity only: no host op events, which would slow
    the host and the window.  It is the autograd profiler that
    `torch.profiler.profile` wraps, whose first start would import the
    compiler stack (several seconds a process)."""
    from torch.autograd.profiler import profile
    torch.cuda.synchronize()
    with profile(use_device="cuda", use_cpu=False, use_kineto=True) as prof:
        clock = Timer()
        fn()
        torch.cuda.synchronize()
        wall = clock.elapsed() * 1e3
    return wall, _device_events(prof.kineto_results)


def device_busy(fn):
    """(wall ms, device-busy ms or None, device events) of ``fn()`` in one
    `device_window` (None where it shows no device events)."""
    wall, events = device_window(fn)
    return wall, (busy_ms(events) if events else None), len(events)
