"""The share of the rays handed to D1, over the traced frames, whose result
the calling stage keeps (each `d1` span's ``kept``: the rows of the
enclosing stages' ``keep`` masks), in %."""

from port_bench import spans


def read(ctx):
    sp = spans.of(ctx)
    return 100.0 * sp["kept"] / sp["rays"] if sp and sp["rays"] else None
