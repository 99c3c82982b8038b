"""Host ms a frame, over the traced frames, of the program's `scene.update`
spans (`SceneData.with_transforms`: the moved objects' new transforms
uploaded), with spans on and the profiler off (`spans.py`'s first round).
None where the program records no such span."""

from port_bench import spans


def read(ctx):
    sp = spans.of(ctx)
    row = sp["rows"].get("scene.update") if sp else None
    return row["host_ms"] if row else None
