"""Engine services: physics world, collision (GJK/SAT), object pools.

Counterpart of `voxel_tracer_tpu/engine/` (src/engine/): host-side numpy
simulation feeding the renderer's per-frame transforms (the reference
keeps PhyWorld dormant, renderer.h:83-86; `game/` imports none of it).
"""
