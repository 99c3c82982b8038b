"""Device time from a profiler window, host syncs and the card's identity.

Frozen copies of the port's suite helpers (`bench/measure.py`,
`utils/timer.py` as of the benchmark's first version): a window of the
autograd profiler that records the card's activity only
(`device_window`), busy time as the union of the device spans
(`busy_ms`), the split of a window by kernel label (`split_events`,
`KERNEL_LABELS`), PyTorch's sync debug mode (`count_host_syncs`) and the
card's name and power limit (`device_identity`).  `idle_gaps` adds a
window with host ops, to name what the host did while the card idled.
"""

from __future__ import annotations

import re
import subprocess
import time
import warnings

import torch

# the hand-written kernels by the symbol the profiler prints, and the TPU
# kernel (B) or XLA loop (D) each replaces
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
_SYMBOL = re.compile(r"(?<!\w)(" + "|".join(re.escape(k) for k in KERNEL_LABELS)
                     + r")(?![\w<])")
SYNC_WARNING = "called a synchronizing CUDA operation"
TOP = 10
NAME_CHARS = 160


def label_of(name):
    """B1-B7 / D1-D3 of a profiler kernel name, or None for glue."""
    m = _SYMBOL.search(name)
    return KERNEL_LABELS[m.group(1)] if m else None


def busy_ms(events):
    """The length of the union of (name, start us, end us) spans, in ms."""
    busy, end = 0.0, -float("inf")
    for a, b in sorted((a, b) for _n, a, b in events):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3


def _events(results, device_type):
    out = []
    for e in results.events():
        if e.device_type() == device_type and not e.is_user_annotation():
            a = e.start_ns() / 1e3
            out.append((e.name(), a, a + e.duration_ns() / 1e3))
    return out


def device_window(fn, with_host=False):
    """(host ms, device events[, host events]) of ``fn()`` in one window of
    the autograd profiler, events as (name, start us, end us); host op
    events only with ``with_host``, since they slow the host."""
    from torch.autograd.profiler import profile
    torch.cuda.synchronize()
    with profile(use_device="cuda", use_cpu=with_host, use_kineto=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    dev = _events(prof.kineto_results, torch.autograd.DeviceType.CUDA)
    if with_host:
        return wall, dev, _events(prof.kineto_results, torch.autograd.DeviceType.CPU)
    return wall, dev


def split_events(events, units):
    """A window's device events a unit (frame or step): busy ms, events,
    device ms by kernel label, the rest as glue, and the TOP ops by time
    (name, seconds in the window)."""
    by_label, ops = {}, {}
    for name, a, b in events:
        label = label_of(name)
        if label:
            by_label[label] = by_label.get(label, 0.0) + (b - a) / 1e3
        ops[name] = ops.get(name, 0.0) + (b - a) / 1e3
    busy = busy_ms(events)
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_ms": busy / units, "events": len(events) / units,
            "kernel_ms": {k: v / units for k, v in sorted(by_label.items())},
            "glue_ms": (busy - sum(by_label.values())) / units,
            "window_busy_s": busy / 1e3,
            "device_ops": [[n[:NAME_CHARS], ms / 1e3] for n, ms in top]}


def idle_gaps(device_events, host_events):
    """The card's idle gaps between its first and last event, each named by
    the innermost host op running at the gap's middle ("python" where no
    op runs), summed by name: the TOP names as [name, seconds]."""
    spans = sorted((a, b) for _n, a, b in device_events)
    gaps, end = [], None
    for a, b in spans:
        if end is not None and a > end:
            gaps.append((end, a))
        end = b if end is None else max(end, b)
    host = sorted(host_events, key=lambda e: e[1])
    by_name, active, i = {}, [], 0
    for g0, g1 in gaps:                      # in time order: one sweep
        mid = (g0 + g1) / 2
        while i < len(host) and host[i][1] <= mid:
            active.append(host[i])
            i += 1
        active = [e for e in active if e[2] >= mid]
        name = max(active, key=lambda e: e[1])[0] if active else "python"
        by_name[name] = by_name.get(name, 0.0) + (g1 - g0) / 1e6
    return [[n[:NAME_CHARS], s] for n, s in sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]]


def count_host_syncs(fn):
    """Synchronizing calls of ``fn()`` that PyTorch's sync debug mode
    reports (device-to-host copies, `nonzero`, `.item()`)."""
    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode(1)
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    return sum(SYNC_WARNING in str(c.message) for c in caught)


def power_limit_w():
    """The card's power limit from nvidia-smi, or None where it prints none."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    m = re.search(r"([\d.]+)\s*W", out)
    return float(m.group(1)) if m else None
