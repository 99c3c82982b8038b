"""Brick-sharded grid mode: the scene's model-parallel axis.

Counterpart of `voxel_tracer_tpu/parallel/grid_shard.py`.  For grids too
large to replicate per device, the voxel grid is split into brick-aligned
z-slabs over the mesh's GRID axis: rank (i, j) traces ray shard i against
slab j (a local two-level DDA clipped to its slab), and the per-slab
candidate hits resolve with one all_gather over GRID and a nearest-hit
fold, so rays crossing slab boundaries are resolved by the reduction,
not by halo cells.  Each rank marches only its own slab.

Slab boundaries are multiples of 8 voxels, so each slab packs its own
intact brickmap.  Agreement with the replicated trace is exact up to
float boundary flips: a ray crossing into the next slab enters it through
its z face, which gives the z-step normal the full-volume march gives.
`steps` differs (per-slab budgets).
"""

from __future__ import annotations

import numpy as np
import torch

from voxel_tracer_tpu_torch.models.volume import BRICK, VolumeData, VoxelVolume
from voxel_tracer_tpu_torch.ops import composite
from voxel_tracer_tpu_torch.parallel.mesh import GRID, Mesh, make_ray_grid_mesh

__all__ = ["GRID", "make_ray_grid_mesh", "split_volume_z", "local_slab",
           "make_grid_sharded_trace"]


def split_volume_z(vol: VoxelVolume, g: int, device="cuda") -> VolumeData:
    """Split one volume into g brick-aligned z-slabs, stacked on axis 0.

    Each slab is a self-contained volume (its own grid block, brickmap and
    pivot-adjusted position) placed so that the slabs tile the original
    volume exactly."""
    gz, gy, gx = vol.grid.shape
    bz = (gz + BRICK - 1) // BRICK
    per = (bz + g - 1) // g * BRICK           # slab depth in voxels
    slabs = []
    for j in range(g):
        z0 = j * per
        block = np.zeros((per, gy, gx), np.uint8)
        if z0 < gz:
            src = vol.grid[z0: min(z0 + per, gz)]
            block[: src.shape[0]] = src
        sv = VoxelVolume(block, vol.palette, vpu=vol.vpu)
        # slab j's local origin sits z0 voxels further along the volume's
        # local +z; the world position moves by R @ (offset from the pivot)
        off_l = np.array([0.0, 0.0, z0 / vol.vpu], np.float32) \
            + sv.pivot - vol.pivot
        sv.pos = (vol.pos + vol.rot @ off_l).astype(np.float32)
        sv.rot = vol.rot.copy()
        slabs.append(sv.data(device))
    return VolumeData(*(torch.stack(f) for f in zip(*slabs)))


def local_slab(mesh: Mesh, slabs: VolumeData) -> VolumeData:
    """This rank's slab of a stack from `split_volume_z`, as a stack of
    one (the block `P(GRID)` places on a device)."""
    j = mesh.coords[GRID]
    return VolumeData(*(f[j:j + 1] for f in slabs))


def _min_reduce_hits(h: composite.HitResult, g: int) -> composite.HitResult:
    """Nearest hit across the leading gather axis (g, N): fold `nearer`."""
    best = composite.HitResult(*(x[0] for x in h))
    for j in range(1, g):
        best = best.nearer(composite.HitResult(*(x[j] for x in h)))
    return best


def make_grid_sharded_trace(mesh: Mesh, max_steps: int = 256):
    """Trace fn over a (rays, grid) mesh: fn(slab, o, d) takes this rank's
    slab (`local_slab`) and ray shard, traces them, gathers the HitResult
    fields over GRID and returns the nearest hit of each of its rays."""
    g = mesh.shape[GRID]

    def trace(slab: VolumeData, o, d):
        hit = composite.intersect_group(slab, o, d, max_steps=max_steps)
        gathered = composite.HitResult(*(mesh.all_gather(GRID, x) for x in hit))
        return _min_reduce_hits(gathered, g)

    return trace
