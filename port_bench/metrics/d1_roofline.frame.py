"""D1's share of its roofline a frame, over the traced frames: the least time
of the reference's own traversal calls of those frames
(`roofline.dda_least_ms`), a frame, over D1's device ms a frame of the same
frames."""

from port_bench import roofline


def read(ctx):
    split = ctx["split"]
    ms = split["kernel_ms"].get("D1") if split else None
    calls = ctx["work"].get("d1_calls")
    if not ms or not calls:
        return None
    return 100.0 * roofline.dda_least_ms(calls) / ctx["work"]["units"] / ms
