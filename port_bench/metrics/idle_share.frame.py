"""The card's idle share of a frame over the traced frames: 1 - their busy ms
a frame (device-only profiler window) over their ms a frame with the
profiler off, in %."""


def read(ctx):
    split = ctx["split"]
    return 100.0 * (1.0 - split["busy_ms"] / ctx["unit_ms"]) if split else None
