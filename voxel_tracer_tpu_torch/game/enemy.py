"""Enemy drones: boids-ish steering + laser damage with voxel carving
(src/game/enemy.{h,cpp} analog)."""

from __future__ import annotations

import numpy as np

from voxel_tracer_tpu_torch.models.volume import VoxelVolume

ENEMY_SPEED = 10.0
PLAYER_WEIGHT = 2.0
ENEMY_WEIGHT = 2.0


def _yaw_matrix(yaw: float) -> np.ndarray:
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)


class Enemy:
    def __init__(self, model: VoxelVolume, rng: np.random.RandomState,
                 reload_fn=None):
        self.model = model
        self.rng = rng
        self.reload_fn = reload_fn     # called on death to restore the grid
        self.pos = rng.rand(3) * 32.0 - 16.0
        self.velocity = np.zeros(3)
        self.health = 32
        self.yaw = 0.0

    def respawn(self):
        self.pos = self.rng.rand(3) * 32.0 - 16.0

    def tick(self, dt: float, player_pos, enemies) -> bool:
        """Steer toward the player, separate from flock-mates; move the
        model transform.  Returns True when close enough to 'catch' the
        player (enemy.cpp:10-43)."""
        target = (player_pos - self.pos)
        target = target / max(np.linalg.norm(target), 1e-9) * PLAYER_WEIGHT
        for other in enemies:
            ext = self.pos - other.pos
            dist = np.linalg.norm(ext)
            if dist == 0:
                continue
            factor = max((5.0 - dist) / 5.0, 0.0) * ENEMY_WEIGHT
            target = target + factor * (ext / dist)
        target = target / max(np.linalg.norm(target), 1e-9)

        self.velocity = self.velocity + target * dt * ENEMY_SPEED
        self.velocity = self.velocity * (0.3 ** dt)
        self.pos = self.pos + self.velocity * dt

        look = self.velocity / max(np.linalg.norm(self.velocity), 1e-9)
        self.yaw = float(np.arctan2(look[0], look[2]))
        self.model.set_position(self.pos)
        self.model.set_rotation(_yaw_matrix(self.yaw))

        return bool(np.linalg.norm(player_pos - self.pos) < 1.0)

    def process_hit(self, hit_point, hit_normal) -> bool:
        """Laser hit: carve the struck voxel (set_voxel 0), decrement
        health, respawn + restore grid on death (enemy.cpp:45-65).
        Returns True when the enemy died."""
        p = np.asarray(hit_point) - np.asarray(hit_normal) * 0.001
        vx, vy, vz = self.model.to_grid(p)
        gx, gy, gz = self.model.grid_size
        if 0 <= vx < gx and 0 <= vy < gy and 0 <= vz < gz:
            self.model.set_voxel(int(vx), int(vy), int(vz), 0)
        self.health -= 1
        if self.health <= 0:
            self.respawn()
            self.velocity = np.zeros(3)
            self.health = 32
            if self.reload_fn is not None:
                self.reload_fn(self.model)
            return True
        return False
