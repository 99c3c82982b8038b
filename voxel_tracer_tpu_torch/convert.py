"""Carry scene state from the JAX package into the port.

Both functions read the attributes of the JAX objects as numpy arrays and
never import the JAX package, so the port stays free of it; tests use
them to render one scene through both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from voxel_tracer_tpu_torch.models.camera import Camera
from voxel_tracer_tpu_torch.models.volume import VoxelVolume


def volume_from_jax(vol) -> VoxelVolume:
    """Port `VoxelVolume` of a JAX `VoxelVolume`: grid, palette, pos, rot
    and vpu are copied; pivot, size and brick occupancy are derived."""
    return VoxelVolume(np.array(vol.grid, np.uint8),
                       palette=np.array(vol.palette, np.float32),
                       pos=np.array(vol.pos, np.float32),
                       rot=np.array(vol.rot, np.float32),
                       vpu=float(vol.vpu))


def camera_from_jax(cam) -> Camera:
    """Port `Camera` with the same fields as a JAX `Camera`."""
    return Camera(*(torch.tensor(np.asarray(f), dtype=torch.float32)
                    for f in cam))
