"""Voxel volume: dense grid + brickmap occupancy + rigid transform.

Counterpart of `voxel_tracer_tpu/models/volume.py` (OVoxelVolume,
src/graphics/primitives/vv.{h,cpp}).  The host-side `VoxelVolume` owns a
mutable numpy grid (dynamic edits = `set_voxel`, vv.cpp:377-432);
`data(device)` uploads it as a tensor `VolumeData` for the wavefront path
and `ops/cuda/mega.MegaVolume` packs it for the kernels.  The brickmap
mirrors `Brick512::voxcnt` (vv.h:23-38) as an 8^3-reduced occupancy-count
array.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from voxel_tracer_tpu_torch.models.vox import VoxModel, load_vox
from voxel_tracer_tpu_torch.ops.math3d import noise3d

BRICK = 8


class VolumeData(NamedTuple):
    """Device-side volume.  Scene composition stacks volumes of one grid
    shape, giving every field a leading object axis."""

    grid: torch.Tensor       # (Z, Y, X) int32 material ids, 0 = air
    brick_occ: torch.Tensor  # (BZ, BY, BX) int32 solid count per brick
    palette: torch.Tensor    # (256, 3) float32 albedo
    rot: torch.Tensor        # (3, 3) float32 rotation (local -> world)
    pos: torch.Tensor        # (3,) float32 world position of pivot
    pivot: torch.Tensor      # (3,) float32 local pivot
    vpu: torch.Tensor        # () float32 voxels per unit


def compute_brick_occ(grid: np.ndarray) -> np.ndarray:
    """8^3 brick occupancy counts (Brick512::voxcnt analog)."""
    gz, gy, gx = grid.shape
    bz, by, bx = (math.ceil(s / BRICK) for s in (gz, gy, gx))
    pad = np.zeros((bz * BRICK, by * BRICK, bx * BRICK), np.uint8)
    pad[:gz, :gy, :gx] = grid != 0
    return (
        pad.reshape(bz, BRICK, by, BRICK, bx, BRICK)
        .sum(axis=(1, 3, 5))
        .astype(np.int32)
    )


class VoxelVolume:
    """Host-side voxel volume with dynamic edits (OVoxelVolume analog)."""

    def __init__(
        self,
        grid: np.ndarray,
        palette: Optional[np.ndarray] = None,
        pos=(0.0, 0.0, 0.0),
        rot: Optional[np.ndarray] = None,
        vpu: float = 20.0,  # reference default (vv.h:106)
    ):
        self.grid = np.ascontiguousarray(grid, np.uint8)
        gz, gy, gx = self.grid.shape
        self.grid_size = (gx, gy, gz)
        self.vpu = float(vpu)
        self.size = np.array([gx, gy, gz], np.float32) / self.vpu
        self.pos = np.asarray(pos, np.float32)
        self.rot = (np.eye(3, dtype=np.float32) if rot is None
                    else np.asarray(rot, np.float32))
        self.pivot = self.size * 0.5  # center pivot (vv.cpp:36)
        self.palette = (
            np.ones((256, 3), np.float32) if palette is None
            else np.asarray(palette, np.float32)
        )
        self.brick_occ = compute_brick_occ(self.grid)

    # -- constructors -------------------------------------------------------

    @staticmethod
    def from_vox(path: str, pos=(0, 0, 0), model_id: int = 0,
                 vpu: float = 20.0) -> "VoxelVolume":
        """Load from .vox (OVoxelVolume(.vox) ctor analog, vv.cpp:12-54)."""
        return VoxelVolume.from_model(load_vox(path, model_id), pos=pos,
                                      vpu=vpu)

    @staticmethod
    def from_model(model: VoxModel, pos=(0, 0, 0), vpu: float = 20.0) -> "VoxelVolume":
        return VoxelVolume(model.grid, model.palette_f32, pos=pos, vpu=vpu)

    @staticmethod
    def noise_filled(grid_size, pos=(0, 0, 0), vpu: float = 20.0,
                     threshold: float = 0.09, material: int = 16) -> "VoxelVolume":
        """Perlin-noise-filled test volume (vv.cpp:88-117 analog)."""
        nx, ny, nz = grid_size
        z, y, x = np.meshgrid(
            np.arange(nz), np.arange(ny), np.arange(nx), indexing="ij"
        )
        n = noise3d(x / nx * 4.0, y / ny * 4.0, z / nz * 4.0)
        grid = np.where(n > threshold, material, 0).astype(np.uint8)
        return VoxelVolume(grid, pos=pos, vpu=vpu)

    # -- dynamic edits (set_voxel analog, vv.cpp:377-432) -------------------

    def set_voxel(self, x: int, y: int, z: int, value: int):
        gx, gy, gz = self.grid_size
        if not (0 <= x < gx and 0 <= y < gy and 0 <= z < gz):
            raise IndexError(f"voxel ({x}, {y}, {z}) outside {self.grid_size}")
        old = self.grid[z, y, x]
        if old == value:
            return
        self.grid[z, y, x] = value
        b = (z // BRICK, y // BRICK, x // BRICK)
        if old == 0 and value != 0:
            self.brick_occ[b] += 1
        elif old != 0 and value == 0:
            self.brick_occ[b] -= 1

    def get_voxel(self, x: int, y: int, z: int) -> int:
        return int(self.grid[z, y, x])

    def to_grid(self, p_world) -> np.ndarray:
        """World position -> integer voxel coords (vv.cpp:872-874 analog)."""
        p_local = self.rot.T @ (np.asarray(p_world, np.float32) - self.pos) + self.pivot
        return np.floor(p_local * self.vpu).astype(np.int32)

    # -- transforms ---------------------------------------------------------

    def set_position(self, pos):
        self.pos = np.asarray(pos, np.float32)

    def set_rotation(self, rot3):
        self.rot = np.asarray(rot3, np.float32)

    def get_aabb(self):
        """Conservative world AABB via component-wise |R| (obb.cpp:37-46)."""
        half = self.size * 0.5
        center = self.rot @ (half - self.pivot) + self.pos
        extent = np.abs(self.rot) @ half
        return center - extent, center + extent

    # -- device upload ------------------------------------------------------

    def data(self, device="cuda") -> VolumeData:
        def f32(v):
            return torch.tensor(np.asarray(v, np.float32), device=device)
        return VolumeData(
            grid=torch.tensor(self.grid.astype(np.int32), device=device),
            brick_occ=torch.tensor(self.brick_occ, device=device),
            palette=f32(self.palette),
            rot=f32(self.rot),
            pos=f32(self.pos),
            pivot=f32(self.pivot),
            vpu=f32(self.vpu),
        )
