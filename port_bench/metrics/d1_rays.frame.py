"""Rays a frame handed to D1 (`ops/cuda/dda.intersect_volume_local`), over
the traced frames: the program's counter `KERNEL_LAUNCHES["dda_rays"]`."""

from port_bench import spans


def read(ctx):
    sp = spans.of(ctx)
    return sp["d1_rays"] if sp else None
