"""The least time a kernel's work needs on the card, counted from the
reference's own work, never from the program's.

Peaks: NVIDIA's published H100 SXM figures, 3.35 TB/s of HBM and
67 TFLOP/s in float32 outside the tensor cores.  A kernel's least time is
the larger of its bytes over the byte rate and its operations over the
operation rate; its roofline share is that time over its device time.

Counting conventions (PERF.md, "XLA loops the port runs as kernels"):

- D1, the DDA, a traversal call: each ray's inputs (24 bytes of origin
  and direction, plus 4 for a per-ray vpu, 8 for an object index, 4 for
  a medium, 4 for an ignored id, 8 for a shadow seed) read once and its
  42 bytes of outputs written once; of the int32 grid and brick tables
  one 32-byte sector a step, never more than the two tables; 80
  operations a ray and 8 a step.
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
SECTOR = 32

DDA_IN_BYTES = 24
DDA_OUT_BYTES = 42
DDA_MODE_BYTES = {"oid": 8, "medium": 4, "ignore": 4, "shadow_seed": 8}
DDA_PER_RAY_VPU_BYTES = 4
DDA_OPS_PER_RAY = 80
DDA_OPS_PER_STEP = 8


def least_ms(nbytes, ops):
    """The least ms for moving ``nbytes`` and doing ``ops`` operations."""
    return max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_FP32_PER_S) * 1e3


def dda_call(rays, steps, modes, per_ray_vpu, table_bytes):
    """(bytes, operations) of one DDA traversal call."""
    per_ray = DDA_IN_BYTES + DDA_OUT_BYTES + sum(DDA_MODE_BYTES.get(m, 0) for m in modes)
    per_ray += DDA_PER_RAY_VPU_BYTES if per_ray_vpu else 0
    nbytes = rays * per_ray + min(SECTOR * steps, table_bytes)
    return nbytes, rays * DDA_OPS_PER_RAY + steps * DDA_OPS_PER_STEP


def dda_least_ms(calls):
    """The least ms of a frame's traversal calls (`reference.render`'s
    `scene.calls` records), summed call by call."""
    return sum(least_ms(*dda_call(c["rays"], c["steps"], c["modes"], c["per_ray_vpu"],
                                  c["table_bytes"])) for c in calls)
