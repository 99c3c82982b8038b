"""Device ms a frame, over the traced frames, of the kernels launched inside
the program's `topk` spans (ops/composite's slab prepass that picks each
ray's nearest candidate objects of a stacked group): `spans.py`'s
profiler round.  None where the program records no `topk` span."""

from port_bench import spans


def read(ctx):
    sp = spans.of(ctx)
    row = sp["device"]["rows"].get("topk") if sp and sp["device"] else None
    return row["device_ms"] if row else None
