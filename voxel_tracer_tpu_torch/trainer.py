"""Inverse rendering: optimize a density/albedo grid from posed images.

Counterpart of `voxel_tracer_tpu/trainer.py` (BASELINE.json config 5:
optimize a 128^3 density + albedo grid from 32 posed target images).  Two
backends, named for what runs the march:

- ``"wavefront"`` (the JAX package's ``"xla"``, accepted as an alias):
  `ops/diff.render_density`, the lock-step PyTorch march with its replay
  backward, in `parallel.sharding.make_train_step` over a ray mesh: under
  an initialized process group each rank trains on its contiguous block
  of every batch and the gradients are averaged over the ranks;
- ``"kernel"`` (the JAX package's ``"pallas"``, accepted as an alias):
  `ops/cuda/diffint.render_density_mega` on the integrate kernels B6/B7,
  or `render_density_slabs` when ``n_slabs > 1``, on one device (the JAX
  kernel step never uses the mesh either).  Batches are contiguous
  1024-ray tiles, so datasets should be in `tile_order`.

`torch.optim.Adam(lr)` takes the place of `optax.adam(lr)`: both add
eps = 1e-8 to sqrt(v_hat), so their updates match.  `fit` draws batches
with the JAX trainer's host sampler (`np.random.RandomState(0)`), padded
to a multiple of the ranks, so both packages, and every world size, train
on the same rays.  Only rank 0 writes metrics and checkpoints.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from voxel_tracer_tpu_torch.models.camera import Camera, rays_for_image
from voxel_tracer_tpu_torch.ops import diff
from voxel_tracer_tpu_torch.ops.cuda import diffint
from voxel_tracer_tpu_torch.parallel import mesh as pmesh
from voxel_tracer_tpu_torch.parallel.sharding import make_train_step
from voxel_tracer_tpu_torch.utils.checkpoint import CheckpointManager
from voxel_tracer_tpu_torch.utils.logging import MetricsLogger

BACKENDS = ("wavefront", "kernel")
# the JAX package's names for the same backends (its TrainConfig.backend)
BACKEND_ALIASES = {"xla": "wavefront", "pallas": "kernel"}
KERNEL_T_EPS = 1e-4     # transmittance floor of the kernel backend
TILE = 1024             # rays per contiguous batch tile (kernel backend)
PARAM_NAMES = ("sigma", "albedo")


@dataclasses.dataclass
class TrainConfig:
    grid_size: tuple = (64, 64, 64)        # (Z, Y, X)
    vpu: float = 64.0                      # grid spans [0, ~1]^3
    lr: float = 0.15
    steps: int = 200
    rays_per_batch: int = 8192
    march_steps: int = 192
    sigma_init: float = 0.1
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 100
    metrics_path: Optional[str] = None     # JSONL metrics stream
    backend: str = "wavefront"             # or "kernel"; "xla" / "pallas" alias them
    # kernel backend: 0 = auto, which is one call for the whole grid on
    # the card (the JAX rule split grids to fit a 16 MB VMEM budget);
    # n > 1 runs the z-slab sequencer with n slabs
    n_slabs: int = 0


def init_params(cfg: TrainConfig, device="cuda"):
    z, y, x = cfg.grid_size
    return {
        "sigma": torch.full((z, y, x), cfg.sigma_init, device=device),
        "albedo": torch.full((z, y, x, 3), 0.5, device=device),
    }


def make_dataset(views, width: int, height: int, vpu: float, grid_size,
                 tile_order: bool = False):
    """Posed images -> flat numpy arrays of (local-space origins, dirs,
    pixels).

    views: list of (Camera, image (H, W, 3)).  Rays are moved into the
    grid's local frame (identity rotation, grid centred at the origin).
    tile_order: reorder each view into 32x32-pixel tile-major order (the
    coherent layout the kernel backend's batch sampler expects).
    """
    gz, gy, gx = grid_size
    pivot = np.array([gx, gy, gz], np.float32) / (2.0 * vpu)
    all_o, all_d, all_c = [], [], []
    for cam, img in views:
        o, d = rays_for_image(cam, width, height, device="cpu")
        o = o.numpy() + pivot                  # world -> local: translate only
        d = d.numpy()
        c = np.asarray(img, np.float32).reshape(-1, 3)
        if tile_order:
            o, d, c = (diffint.tile_raster(a, height, width) for a in (o, d, c))
        all_o.append(o)
        all_d.append(d)
        all_c.append(c)
    return (np.concatenate(all_o), np.concatenate(all_d),
            np.concatenate(all_c))


def draw_batch(rng, n: int, batch: int, backend: str):
    """Indices of one global batch from the host sampler: contiguous
    1024-ray tiles for the kernel backend, single rays otherwise."""
    if backend == "kernel":
        starts = rng.randint(0, max(n // TILE, 1), batch // TILE) * TILE
        return (starts[:, None] + np.arange(TILE)[None, :]).ravel()
    return rng.randint(0, n, batch)


class Trainer:
    """``mesh``: the ray mesh of the wavefront step; by default every rank
    of the process group when one is initialized, else this one device.
    ``Trainer(cfg, mesh)`` is JAX's call; ``device`` is keyword-only."""

    def __init__(self, cfg: TrainConfig, mesh=None, *, device="cuda"):
        backend = BACKEND_ALIASES.get(cfg.backend, cfg.backend)
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS} or their JAX "
                             f"names {tuple(BACKEND_ALIASES)}, not {cfg.backend!r}")
        if backend != cfg.backend:     # a JAX name: keep a copy under the port's
            cfg = dataclasses.replace(cfg, backend=backend)
        self.cfg = cfg
        self.device = torch.device(device)
        self.mesh = mesh if mesh is not None else pmesh.make_ray_mesh(device=self.device)
        if backend == "kernel" and self.mesh.size > 1:
            raise ValueError(
                f"the kernel backend trains on one device, not a mesh of "
                f"{self.mesh.size} ranks; use backend='wavefront' to shard rays")
        self.params = {k: v.requires_grad_() for k, v in
                       init_params(cfg, self.device).items()}
        self.optimizer = torch.optim.Adam(
            [self.params[k] for k in PARAM_NAMES], lr=cfg.lr)
        self.step_fn = (make_train_step(self.mesh, cfg.lr, cfg.vpu, cfg.march_steps)
                        if backend == "wavefront" else self._kernel_step)
        self.step = 0
        chief = self.mesh.coords[pmesh.RAYS] == 0
        self.ckpt = (CheckpointManager(cfg.checkpoint_dir)
                     if cfg.checkpoint_dir and chief else None)
        self.metrics = (MetricsLogger(cfg.metrics_path)
                        if cfg.metrics_path and chief else None)

    def _kernel_step(self, params, opt, o, d, c):
        cfg, p = self.cfg, params
        if cfg.n_slabs > 1:
            out = diffint.render_density_slabs(
                p["sigma"], p["albedo"], o, d, cfg.vpu, cfg.n_slabs,
                t_eps=KERNEL_T_EPS)
        else:
            out = diffint.render_density_mega(
                p["sigma"], p["albedo"], o, d, cfg.vpu, t_eps=KERNEL_T_EPS)
        loss = torch.mean((out["color"] - c) ** 2)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return params, opt, loss.detach()

    # -- state --------------------------------------------------------------

    def state(self):
        """{"params": {name: tensor}, "opt_state": {name: {"step",
        "exp_avg", "exp_avg_sq"}}}: what a checkpoint holds."""
        opt = {}
        for k in PARAM_NAMES:
            st = self.optimizer.state.get(self.params[k], {})
            opt[k] = {"step": float(st["step"]) if st else 0.0,
                      "exp_avg": st.get("exp_avg"),
                      "exp_avg_sq": st.get("exp_avg_sq")}
        return {"params": {k: self.params[k].detach() for k in PARAM_NAMES},
                "opt_state": opt}

    def load_state(self, step: int, state):
        """Restore the step counter, parameters and Adam moments from the
        layout of `state()` (arrays or tensors; `convert.py` maps a JAX
        trainer's state to it)."""
        with torch.no_grad():
            for k in PARAM_NAMES:
                self.params[k].copy_(torch.as_tensor(state["params"][k]))
        self.optimizer.state.clear()
        for k in PARAM_NAMES:
            st = state["opt_state"][k]
            if st["exp_avg"] is None:
                continue
            p = self.params[k]
            self.optimizer.state[p] = {
                "step": torch.tensor(float(st["step"]), dtype=torch.float32),
                "exp_avg": torch.as_tensor(st["exp_avg"]).to(p).clone(),
                "exp_avg_sq": torch.as_tensor(st["exp_avg_sq"]).to(p).clone()}
        self.step = int(step)

    def maybe_restore(self) -> bool:
        if self.ckpt is None:
            return False
        restored = self.ckpt.restore()
        if restored is None:
            return False
        self.load_state(*restored)
        return True

    # -- training -----------------------------------------------------------

    def fit(self, origins, dirs, targets, log_every: int = 50,
            log_fn: Callable = print):
        """Run optimization steps until `cfg.steps` over a ray dataset
        (numpy arrays on the host).  Returns the logged losses."""
        cfg = self.cfg
        batch = pmesh.pad_to_multiple(cfg.rays_per_batch, self.mesh.size)
        n = origins.shape[0]
        rng = np.random.RandomState(0)
        losses = []
        while self.step < cfg.steps:
            # every rank draws the global batch and takes its own block
            idx = pmesh.shard_rays(self.mesh, draw_batch(rng, n, batch, cfg.backend))
            o, d, c = (torch.as_tensor(np.asarray(a[idx], np.float32),
                                       device=self.device)
                       for a in (origins, dirs, targets))
            _, _, loss = self.step_fn(self.params, self.optimizer, o, d, c)
            self.step += 1
            if self.step % log_every == 0:
                value = float(loss)
                losses.append(value)
                log_fn(f"step {self.step}: loss {value:.6f}")
                if self.metrics is not None:
                    self.metrics.log(step=self.step, loss=value, rays=batch)
            if (self.ckpt is not None
                    and self.step % cfg.checkpoint_every == 0):
                self.ckpt.save(self.step, self.state())
        return losses

    @torch.no_grad()
    def render(self, camera: Camera, width: int, height: int, background=None):
        """(height, width, 3) numpy image of the current grid through the
        wavefront renderer."""
        gz, gy, gx = self.cfg.grid_size
        pivot = torch.from_numpy(np.array([gx, gy, gz], np.float32)
                                 / (2.0 * self.cfg.vpu)).to(self.device)
        o, d = rays_for_image(camera, width, height, device=self.device)
        out = diff.render_density(self.params["sigma"], self.params["albedo"],
                                  o + pivot, d, self.cfg.vpu,
                                  self.cfg.march_steps)
        color = out["color"]
        if background is not None:
            color = color + out["trans"][:, None] * torch.as_tensor(
                background, dtype=torch.float32, device=self.device)
        return color.cpu().numpy().reshape(height, width, 3)
