"""Host self ms a frame, over the traced frames, of the program's `shade*`
spans (ops/shading): each span's time less its children's, with spans on
and the profiler off (`spans.py`'s first round)."""

from port_bench import spans


def read(ctx):
    sp = spans.of(ctx)
    return sp["host_ms"].get(spans.SHADING) if sp else None
