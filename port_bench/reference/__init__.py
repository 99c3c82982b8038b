"""The plain reference: plain PyTorch and numpy that imports nothing of
the program (`voxel_tracer_tpu_torch`) and nothing of JAX."""
