"""AOV display modes (src/dev/dev.{h,cpp} analog).

Counterpart of `voxel_tracer_tpu/utils/aov.py`.  The reference's debug
display modes — FINAL / ALBEDO / NORMALS / DEPTH / PRIMARY_STEPS /
SECONDARY_STEPS (dev.h:36-46, dev.cpp:22-54) — become pure functions
mapping the renderer's AOV dict (tensors on any device, or arrays) to
displayable numpy images.
"""

from __future__ import annotations

import numpy as np

DISPLAY_MODES = ("final", "albedo", "normals", "depth", "steps", "irradiance",
                 "material")


def _np(x) -> np.ndarray:
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def display(aovs: dict, mode: str = "final") -> np.ndarray:
    """AOV dict (from Renderer.render) -> (H, W, 3) float image in [0,1]."""
    mode = mode.lower()
    if mode == "final":
        return _np(aovs["image"])
    if mode == "albedo":
        return np.clip(_np(aovs["albedo"]), 0.0, 1.0)
    if mode == "normals":
        # dev.cpp: normals displayed as 0.5 + 0.5 * n
        return 0.5 + 0.5 * _np(aovs["normal"])
    if mode == "depth":
        d = _np(aovs["depth"])
        finite = d[d < 1e29]
        far = float(finite.max()) if finite.size else 1.0
        v = np.clip(1.0 - d / max(far, 1e-6), 0.0, 1.0)
        v[d >= 1e29] = 0.0
        return np.repeat(v[..., None], 3, axis=-1)
    if mode == "steps":
        # step heatmap (dev.cpp:46-48): green->red with cost
        s = _np(aovs["steps"]).astype(np.float32)
        v = np.clip(s / 128.0, 0.0, 1.0)
        img = np.zeros(v.shape + (3,), np.float32)
        img[..., 0] = v
        img[..., 1] = 1.0 - v
        return img
    if mode == "irradiance":
        return np.clip(_np(aovs["irradiance"]), 0.0, 1.0)
    if mode == "material":
        m = _np(aovs["material"]).astype(np.float32)
        v = np.clip(m / 255.0, 0, 1)
        return np.stack([v, np.mod(m / 64.0, 1.0), np.mod(m / 16.0, 1.0)],
                        axis=-1)
    raise ValueError(f"unknown display mode {mode!r}; one of {DISPLAY_MODES}")
