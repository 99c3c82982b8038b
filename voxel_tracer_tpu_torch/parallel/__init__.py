"""Scale-out on `torch.distributed`: device meshes of process groups,
the ray- and grid-sharded render and train steps, and the process
bootstrap.

Counterpart of `voxel_tracer_tpu/parallel/`: one process drives one
device, and a mesh axis is a set of process subgroups, where JAX's
`shard_map` runs one program over a `jax.sharding.Mesh`.  A rank holds
only its shard of a sharded array; the collectives that `shard_map`
places (`pmean`, `all_gather` and their transposes) are explicit calls
here, and those on the backward path are `torch.autograd.Function`s."""
