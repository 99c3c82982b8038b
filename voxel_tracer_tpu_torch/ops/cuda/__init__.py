"""Hand-written CUDA kernels for Hopper (sm_90a) and their host wrappers.

Sources live in `voxel_tracer_tpu_torch/csrc/`; `_build.py` compiles them
with `nvcc` at first use.  Importing this package builds nothing."""
