"""Compute ops: 3D math, slab test and DDA traversal, tonemap, the
world-to-local transform, and the CUDA kernels under `ops/cuda/`."""
