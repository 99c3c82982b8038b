"""Device ms a frame of D1's kernels (`dda_kernel`, `dda_exhaust_kernel`) over
the traced frames."""


def read(ctx):
    split = ctx["split"]
    return split["kernel_ms"].get("D1") if split else None
