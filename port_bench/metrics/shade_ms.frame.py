"""Device ms a frame, over the traced frames, of the kernels other than the
hand-written ones whose launch lies innermost in a `shade*` span of the
program (ops/shading's `shade_full`, its bounces and stages):
`spans.py`'s profiler round."""

from port_bench import spans


def read(ctx):
    sp = spans.of(ctx)
    return sp["device"]["device_ms"].get(spans.SHADING) if sp and sp["device"] else None
