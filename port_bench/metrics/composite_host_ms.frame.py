"""Host self ms a frame, over the traced frames, of the program's
`intersect`, `topk`, `candidate` and `d1` spans (ops/composite and D1's
wrapper, its launch included), with spans on and the profiler off
(`spans.py`'s first round)."""

from port_bench import spans


def read(ctx):
    sp = spans.of(ctx)
    return sp["host_ms"].get(spans.COMPOSITE) if sp else None
