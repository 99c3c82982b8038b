"""Device ms a frame in kernels outside KERNEL_LABELS over the traced frames:
the shading, composite and tensor glue around the hand-written kernels."""


def read(ctx):
    return ctx["split"]["glue_ms"] if ctx["split"] else None
