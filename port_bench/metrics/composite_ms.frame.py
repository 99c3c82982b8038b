"""Device ms a frame, over the traced frames, of the kernels other than the
hand-written ones whose launch lies innermost in an `intersect`, `topk`,
`candidate` or `d1` span of the program: ops/composite's traversal glue
around D1 (`spans.py`'s profiler round)."""

from port_bench import spans


def read(ctx):
    sp = spans.of(ctx)
    return sp["device"]["device_ms"].get(spans.COMPOSITE) if sp and sp["device"] else None
