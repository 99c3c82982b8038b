"""Headless game layer: the arcade-demo logic of the reference
(src/game/) without GLFW — drives dynamic voxel edits, laser paths and
per-frame transforms against the renderer.

Counterpart of `voxel_tracer_tpu/game/`: host-side numpy on this
package's `Camera`, `Scene` and `VoxelVolume`."""
