"""Host self ms a frame, over the traced frames, of the program's `topk`
spans (ops/composite's slab prepass over a stacked group), with spans on
and the profiler off (`spans.py`'s first round).  None where the program
records no `topk` span."""

from port_bench import spans


def read(ctx):
    sp = spans.of(ctx)
    row = sp["rows"].get("topk") if sp else None
    return row["self_ms"] if row else None
