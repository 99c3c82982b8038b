"""D1's table derivations a frame over the traced frames: the program's
counter `KERNEL_LAUNCHES["dda_tables"]` of `ops/cuda/dda` (a grid whose
tables are not kept from an earlier frame derives them anew), in
`spans.py`'s first round."""

from port_bench import spans


def read(ctx):
    sp = spans.of(ctx)
    return sp["dda_tables"] if sp else None
