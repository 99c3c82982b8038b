"""The program's own spans and counters over a cell's traced units.

The port records a span at each layer boundary of its frame
(`voxel_tracer_tpu_torch.utils.profiling.annotate`: `frame`, `raygen`,
`sky`, `tonemap`; `shade` and its stages; `intersect`, `topk`,
`candidate`; `d1`) and counts what it hands D1 (`KERNEL_LAUNCHES` of
`ops/cuda/dda`: `dda_rays`), with the rays each stage keeps of its
traversals (a `d1` span's ``kept``).  `of(ctx)` reads them the first time
a metric asks and keeps the result in ``ctx["spans"]``: it sets the
cell's program up again (the harness has released it), with the palette
of ``SEED`` (nothing read here depends on the palette), and renders the
cell's fixed trace units three more times with spans on:

1. without the profiler: each span's host time, its self time (less
   its children's) summed by layer, the rays handed to D1 and the rays
   kept;
2. in one profiler window with host events: each device event goes to
   the innermost span that holds its launching runtime event (matched by
   correlation id), and each idle gap of the card to the innermost span
   at the gap's middle;
3. in PyTorch's sync debug mode: each synchronizing call to the
   innermost open span.

Layers, by span name: `shade*` is ops/shading, `intersect`, `topk`,
`candidate` and `d1` are ops/composite (D1's wrapper with them), the rest
(`frame`, `raygen`, `sky`, `tonemap`) the entry point; a device event
whose kernel has a label (`profile.label_of`) is that kernel's, wherever
it was launched.  It prints a per-span table to standard error.  A
program without spans (no `take_spans`) gives None, and every reader of
these numbers then reports nothing.
"""

from __future__ import annotations

import importlib
import sys
import time
import traceback
import warnings

import torch

from port_bench import profile

SEED = 0
SHADING, COMPOSITE, ROOT = "shading", "composite", "root"
COMPOSITE_SPANS = ("intersect", "topk", "candidate", "d1")
OUTSIDE = "(outside)"
RUNTIME_PREFIX = "cu"          # the CUDA runtime and driver calls (cudaLaunchKernel, ...)


def layer_of(name):
    """The layer of a span name."""
    if name == "shade" or name.startswith("shade."):
        return SHADING
    return COMPOSITE if name in COMPOSITE_SPANS else ROOT


def key_of(rec):
    """A span's row in the table: its name, and its kind where it has one."""
    kind = rec["attrs"].get("kind")
    return f"{rec['name']}[{kind}]" if kind else rec["name"]


def _innermost(spans, times):
    """For each of ``times`` (ns), the innermost span holding it (start <=
    t < end), or None: one sweep over the spans' starts and ends."""
    marks = sorted([(r["start_ns"], 1, i) for i, r in enumerate(spans)]
                   + [(r["end_ns"], 0, i) for i, r in enumerate(spans)])
    order = sorted(range(len(times)), key=times.__getitem__)
    out, stack, j = [None] * len(times), [], 0
    for q in order:
        t = times[q]
        while j < len(marks) and marks[j][0] <= t:
            _t, opens, i = marks[j]
            if opens:
                stack.append(i)
            elif stack and stack[-1] == i:
                stack.pop()
            elif i in stack:
                stack.remove(i)
            j += 1
        out[q] = spans[stack[-1]] if stack else None
    return out


def host_times(spans, units):
    """Host ms a unit of each span's time and self time (its time less its
    children's): ({layer: self ms}, {key: {"n", "host_ms", "self_ms"}})."""
    child = {}
    for r in spans:
        if r["parent"] is not None:
            child[r["parent"]] = child.get(r["parent"], 0) + r["end_ns"] - r["start_ns"]
    layers, rows = {}, {}
    for r in spans:
        dur = r["end_ns"] - r["start_ns"]
        own = (dur - child.get(r["id"], 0)) / 1e6 / units
        layer = layer_of(r["name"])
        layers[layer] = layers.get(layer, 0.0) + own
        row = rows.setdefault(key_of(r), {"n": 0, "host_ms": 0.0, "self_ms": 0.0})
        row["n"] += 1 / units
        row["host_ms"] += dur / 1e6 / units
        row["self_ms"] += own
    return layers, rows


def kept_rays(spans):
    """(rays handed to D1, rays kept) in all, and by the key of each span
    that holds a `d1` span (the d1 span's own row included)."""
    by_id = {r["id"]: r for r in spans}
    rays = kept = 0
    rows = {}
    for r in spans:
        if r["name"] != "d1":
            continue
        n, k = r["attrs"]["rays"], r["attrs"].get("kept", r["attrs"]["rays"])
        rays, kept = rays + n, kept + k
        a, seen = r, set()
        while a is not None:
            key = key_of(a)
            if key not in seen:
                seen.add(key)
                row = rows.setdefault(key, [0, 0])
                row[0] += n
                row[1] += k
            a = by_id.get(a["parent"])
    return rays, kept, rows


def attribute(spans, runtime, device, units):
    """Device events and the card's idle gaps by span and layer, a unit.

    ``spans``: records on the trace's clock; ``runtime``: [(correlation id,
    start ns)] of the host's runtime calls; ``device``: [(name, start ns,
    end ns, correlation id)].  A device event goes to its label's kernel
    (`profile.label_of`) or else to the layer of the innermost span that
    holds its runtime call; one whose call lies outside every span, or
    that no call launched, is counted in ``unattributed``.  Each gap
    between the device events' union goes to the innermost span at its
    middle (``OUTSIDE`` where none is open)."""
    launch = dict(runtime)
    starts = [launch.get(c) for _n, _a, _b, c in device]
    found = _innermost(spans, [s if s is not None else -1 for s in starts])
    device_ms, rows, unattributed = {}, {}, 0
    for (name, a, b, _c), s, span in zip(device, starts, found):
        ms = (b - a) / 1e6 / units
        if s is None or span is None:
            unattributed += 1
        label = profile.label_of(name)
        layer = label or (layer_of(span["name"]) if span is not None else ROOT)
        device_ms[layer] = device_ms.get(layer, 0.0) + ms
        if span is not None:
            row = rows.setdefault(key_of(span), {"device_ms": 0.0, "launches": 0.0,
                                                 "idle_ms": 0.0})
            row["device_ms"] += ms
            row["launches"] += 1 / units
    gaps, end = [], None
    for a, b in sorted((a, b) for _n, a, b, _c in device):
        if end is not None and a > end:
            gaps.append((end, a))
        end = b if end is None else max(end, b)
    idle_ms = {}
    for (g0, g1), span in zip(gaps, _innermost(spans, [(g0 + g1) / 2 for g0, g1 in gaps])):
        ms = (g1 - g0) / 1e6 / units
        where = layer_of(span["name"]) if span is not None else OUTSIDE
        idle_ms[where] = idle_ms.get(where, 0.0) + ms
        if span is not None:
            row = rows.setdefault(key_of(span), {"device_ms": 0.0, "launches": 0.0,
                                                 "idle_ms": 0.0})
            row["idle_ms"] += ms
    busy = profile.busy_ms([(n, a / 1e3, b / 1e3) for n, a, b, _c in device]) / units
    return {"device_ms": device_ms, "busy_ms": busy, "idle_ms": idle_ms, "rows": rows,
            "events": len(device), "unattributed": unattributed}


def _kineto(results):
    """(annotations [(name, start, end)], runtime [(corr, start)], device
    [(name, start, end, corr)]) of a window, in ns."""
    ann, runtime, device = [], [], []
    for e in results.events():
        a = e.start_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation():
                device.append((e.name(), a, a + e.duration_ns(), e.correlation_id()))
        elif e.is_user_annotation():
            ann.append((e.name(), a, a + e.duration_ns()))
        elif e.name().startswith(RUNTIME_PREFIX):
            runtime.append((e.correlation_id(), a))
    return ann, runtime, device


def on_trace_clock(spans, annotations):
    """The spans with the times of their `record_function` events, matched
    name by name in the order they started where the counts agree (the
    program stamps its own times a few microseconds apart from them)."""
    by_name = {}
    for name, a, b in sorted(annotations, key=lambda x: x[1]):
        by_name.setdefault(name, []).append((a, b))
    out, mine = [], {}
    for r in spans:
        mine.setdefault(r["name"], []).append(r)
    for name, recs in mine.items():
        theirs = by_name.get(name, [])
        if len(theirs) == len(recs):
            out += [dict(r, start_ns=a, end_ns=b) for r, (a, b) in zip(recs, theirs)]
        else:
            out += recs
    return sorted(out, key=lambda r: r["id"])


def _syncs(run, profiling):
    """Synchronizing calls of ``run()`` by the key of the innermost open
    span, as PyTorch's sync debug mode reports them."""
    counts = {}

    def hook(message, *_args, **_kw):
        if profile.SYNC_WARNING in str(message):
            rec = profiling.current_span()
            key = key_of(rec) if rec else OUTSIDE
            counts[key] = counts.get(key, 0) + 1

    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode(1)
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    return counts


def measure(cell, units, profiling):
    """The three rounds over ``units`` on a set-up cell (module docstring)."""
    from torch.autograd.profiler import profile as window

    cuda = torch.device(cell.device).type == "cuda"
    d1 = importlib.import_module("voxel_tracer_tpu_torch.ops.cuda.dda").KERNEL_LAUNCHES
    n = len(units)
    profiling.take_spans()
    before = dict(d1)
    with profiling.recording():
        cell.run(units)
    plain = profiling.take_spans()
    after = dict(d1)
    layers, rows = host_times(plain, n)
    rays, kept, kept_rows = kept_rays(plain)
    with window(use_device="cuda" if cuda else None, use_cpu=True, use_kineto=True) as prof:
        with profiling.recording():
            cell.run(units)
    ann, runtime, device = _kineto(prof.kineto_results)
    traced = on_trace_clock(profiling.take_spans(), ann)
    dev = attribute(traced, runtime, device, n) if device else None
    syncs = {}
    if cuda:
        with profiling.recording():
            syncs = _syncs(lambda: cell.run(units), profiling)
        profiling.take_spans()
    return {"units": n, "host_ms": layers, "rows": rows, "device": dev,
            "syncs": {k: v / n for k, v in syncs.items()},
            "d1_rays": (after["dda_rays"] - before["dda_rays"]) / n,
            "dda_tables": (after["dda_tables"] - before["dda_tables"]) / n,
            "rays": rays, "kept": kept, "kept_rows": kept_rows,
            "dropped": plain.dropped}


def table(sp):
    """The per-span table, a unit, as lines of text."""
    dev = sp["device"] or {"rows": {}, "device_ms": {}, "idle_ms": {}, "busy_ms": 0.0,
                           "events": 0, "unattributed": 0}
    head = (f"{'span':<28}{'n':>6}{'host':>9}{'self':>9}{'device':>9}{'launches':>9}"
            f"{'idle':>9}{'syncs':>7}{'rays':>12}{'kept%':>7}")
    lines = [f"spans over {sp['units']} traced units, a unit (ms; host without the profiler, "
             f"device, launches and idle in one profiler window, syncs in the sync debug "
             f"mode; rays handed to D1 beneath the span and the share kept):", head]
    keys = sorted(set(sp["rows"]) | set(dev["rows"]),
                  key=lambda k: -sp["rows"].get(k, {}).get("host_ms", 0.0))
    for k in keys:
        h, d = sp["rows"].get(k, {}), dev["rows"].get(k, {})
        r = sp["kept_rows"].get(k)
        rays = f"{r[0] / sp['units']:12.0f}{100 * r[1] / r[0]:7.1f}" if r and r[0] else ""
        lines.append(f"{k:<28}{h.get('n', 0):6.0f}{h.get('host_ms', 0):9.3f}"
                     f"{h.get('self_ms', 0):9.3f}{d.get('device_ms', 0):9.3f}"
                     f"{d.get('launches', 0):9.0f}{d.get('idle_ms', 0):9.3f}"
                     f"{sp['syncs'].get(k, 0):7.1f}{rays}")
    if OUTSIDE in sp["syncs"]:
        lines.append(f"{OUTSIDE:<28} syncs {sp['syncs'][OUTSIDE]:.1f}")

    def fmt(d):
        return ", ".join(f"{k} {v:.3f}" for k, v in sorted(d.items()))
    idle = sum(dev["idle_ms"].values())
    root_idle = dev["rows"].get("frame", {}).get("idle_ms", 0.0)
    lines += [f"host self ms by layer: {fmt(sp['host_ms'])}",
              f"device ms by layer: {fmt(dev['device_ms'])} (sum "
              f"{sum(dev['device_ms'].values()):.3f}; busy {dev['busy_ms']:.3f})",
              f"idle ms by layer: {fmt(dev['idle_ms'])}; in the root span's own time "
              f"{root_idle:.3f} ({100 * root_idle / idle if idle else 0:.1f} % of {idle:.3f})",
              f"device events a unit {dev['events'] / sp['units']:.0f}, unattributed "
              f"{dev['unattributed']}; D1 rays a unit {sp['d1_rays']:.0f}, kept "
              f"{100 * sp['kept'] / max(sp['rays'], 1):.2f} %; table derivations a unit "
              f"{sp['dda_tables']:.2f}; spans dropped {sp['dropped']}"]
    return lines


def of(ctx):
    """The span readings of a traced run, measured on the first call and
    kept in ``ctx["spans"]``; None where the program records no spans."""
    if "spans" in ctx:
        return ctx["spans"]
    ctx["spans"] = None
    from voxel_tracer_tpu_torch.utils import profiling
    if not hasattr(profiling, "take_spans"):
        return None
    driver = importlib.import_module(f"port_bench.drivers.{ctx['mix']['driver']}")
    device = "cuda" if torch.cuda.is_available() else "cpu"
    t0 = time.perf_counter()
    try:
        cell = driver.Cell(ctx["config"], ctx["mix"], SEED, device)
        try:
            sp = measure(cell, cell.trace_units, profiling)
        finally:
            cell.release()
    except Exception:       # the run's other readings stand; this one reports nothing
        traceback.print_exc()
        print("span rounds failed: their metrics are left out", file=sys.stderr)
        return None
    print("\n".join(table(sp)), file=sys.stderr)
    print(f"span rounds: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    ctx["spans"] = sp
    return sp
