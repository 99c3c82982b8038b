"""Carry scene and training state from the JAX package into the port.

The functions read the attributes of the JAX objects as numpy arrays and
never import the JAX package, so the port stays free of it; tests use
them to render one scene through both packages, and a training run
started with the JAX trainer resumes in the port's (`Trainer.load_state`).
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


def params_from_jax(params, device="cuda"):
    """{"sigma", "albedo"} of a JAX trainer as float32 tensors on ``device``."""
    return {k: torch.tensor(np.asarray(params[k]), dtype=torch.float32,
                            device=device) for k in ("sigma", "albedo")}


def adam_state_from_jax(opt_state, params):
    """optax's `ScaleByAdamState` (count, mu, nu) -> the `torch.optim.Adam`
    state (step, exp_avg, exp_avg_sq) of each parameter, in the layout of
    `Trainer.state()["opt_state"]`.

    opt_state: the state of `optax.adam` (a chain whose first element is
    the `ScaleByAdamState`) or that element itself.  params: the port's
    parameters ({name: tensor}), whose devices and dtypes the moments take.
    """
    adam = opt_state
    if not hasattr(adam, "mu"):
        adam = next(s for s in opt_state if hasattr(s, "mu"))
    step = float(np.asarray(adam.count))
    return {k: {"step": step,
                "exp_avg": torch.tensor(np.asarray(adam.mu[k])).to(p),
                "exp_avg_sq": torch.tensor(np.asarray(adam.nu[k])).to(p)}
            for k, p in params.items()}
