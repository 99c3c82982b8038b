"""Checkpoint / resume.

Counterpart of `voxel_tracer_tpu/utils/checkpoint.py`:

- `save_camera` / `load_camera`: the camera pose as a small .npz;
- `CheckpointManager`: training state (voxel parameters + optimizer
  state) as `ckpt_%08d.pkl` files, published atomically with
  `os.replace` and garbage-collected to the newest `max_to_keep`.

The pickle holds numpy arrays and Python numbers only: tensors are moved
to the host first, so no `torch` object is pickled and the files of
either package hold the same kind of payload.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from voxel_tracer_tpu_torch.models.camera import Camera


def save_camera(path: str, camera: Camera):
    np.savez(path, pos=camera.pos.numpy(), target=camera.target.numpy())


def load_camera(path: str, aspect: float = 16.0 / 9.0) -> Camera | None:
    if not os.path.exists(path):
        return None
    z = np.load(path)
    return Camera.create(z["pos"], z["target"], aspect)


def _to_host(tree):
    """Nested dicts, lists and tuples with every tensor as a numpy array."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


class CheckpointManager:
    """Minimal durable checkpointing of nested state + a step counter."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = directory
        self.max_to_keep = max_to_keep
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step:08d}.pkl")

    def save(self, step: int, state):
        tmp = self._path(step) + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump({"step": step, "state": _to_host(state)}, f)
        os.replace(tmp, self._path(step))  # atomic publish
        self._gc()

    def latest_step(self) -> int | None:
        steps = sorted(self._all_steps())
        return steps[-1] if steps else None

    def restore(self, step: int | None = None):
        """(step, state) of the given or newest checkpoint, or None.
        Unpickles only files this manager wrote into its directory."""
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        with open(self._path(step), "rb") as f:
            payload = pickle.load(f)
        return payload["step"], payload["state"]

    def _all_steps(self):
        return [int(name[5:13]) for name in os.listdir(self.directory)
                if name.startswith("ckpt_") and name.endswith(".pkl")]

    def _gc(self):
        steps = sorted(self._all_steps())
        for s in steps[: -self.max_to_keep]:
            os.remove(self._path(s))
