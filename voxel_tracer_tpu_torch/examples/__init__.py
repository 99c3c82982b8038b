"""Command-line demos of the port (`python -m voxel_tracer_tpu_torch.examples.<name>`)."""
