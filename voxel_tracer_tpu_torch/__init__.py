"""voxel_tracer_tpu_torch — the PyTorch / CUDA port of voxel_tracer_tpu.

The JAX package `voxel_tracer_tpu` is the reference; this package mirrors
its layout module for module (`models/camera.py` <-> `models/camera.py`,
`ops/pallas/mega.py` <-> `ops/cuda/mega.py`, ...).  Plain tensor code is
PyTorch; every Pallas TPU kernel on a ported path becomes a hand-written
CUDA kernel for Hopper (`csrc/`), built with `nvcc` at first use.  Each
kernel wrapper keeps a plain PyTorch version of the same function beside
it: the wrapper runs that version for CPU tensors only, and for CUDA
tensors launches the kernel or raises.

This package imports `torch` and numpy, never `jax` or `voxel_tracer_tpu`.
"""

__version__ = "0.1.0"

from voxel_tracer_tpu_torch.models.camera import Camera
from voxel_tracer_tpu_torch.models.scene import Scene
from voxel_tracer_tpu_torch.models.volume import VoxelVolume
from voxel_tracer_tpu_torch.models.vox import load_vox
from voxel_tracer_tpu_torch.renderer import RenderConfig, Renderer

__all__ = ["Camera", "Renderer", "RenderConfig", "Scene", "VoxelVolume",
           "load_vox"]
