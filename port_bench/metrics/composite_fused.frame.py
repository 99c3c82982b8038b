"""The share of the program's traversal calls (`ops/composite`'s
`intersect_scene`, `is_occluded`, `march_interior`) that ran their glue
around D1 on the two kernels of `ops/cuda/composite.py` rather than as
tensor glue, over the cell's process: 100 * composite_fused /
(composite_fused + composite_glue) of that module's `KERNEL_LAUNCHES`, in
%.  None where the program has no such counters."""

import importlib


def read(ctx):
    try:
        mod = importlib.import_module("voxel_tracer_tpu_torch.ops.cuda.composite")
    except ImportError:
        return None
    counts = getattr(mod, "KERNEL_LAUNCHES", {})
    fused, glue = counts.get("composite_fused", 0), counts.get("composite_glue", 0)
    return 100.0 * fused / (fused + glue) if fused + glue else None
