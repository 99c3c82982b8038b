"""Headless arcade game (src/game/game.{h,cpp} analog).

State machine MENU / GAME / GAMEOVER (game.h:8-12), player + enemy ticks,
laser path -> capsule segments -> enemy damage with voxel carving
(game.cpp:28-98), score keeping.  Rendering is delegated to the
renderer; this module owns only simulation state and dynamic scene edits —
the per-frame flow mirrors SURVEY.md §3.2.

The laser path follows next_path_ray semantics (materials.cpp:50-69):
mirror rows reflect, glass rows continue the SAME ray with the medium id
set (the medium-aware interior march then finds the first differing voxel
or the exit into air, vv.cpp:166-232), diffuse terminates.  An exit into
air (material 0) falls through next_path_ray's default case and ends the
path at the glass back face, exactly as the reference does.
"""

from __future__ import annotations

import enum

import numpy as np

from voxel_tracer_tpu_torch.game.enemy import Enemy
from voxel_tracer_tpu_torch.game.player import Input, Player
from voxel_tracer_tpu_torch.models.scene import Scene
from voxel_tracer_tpu_torch.models.volume import VoxelVolume
from voxel_tracer_tpu_torch.ops.math3d import BIG_F32


class GameState(enum.Enum):
    MENU = 0
    GAME = 1
    GAME_OVER = 2


def _material_row(mat: int) -> int:
    return int(np.floor((mat - 1) / 8.0)) if mat > 0 else -1


class Game:
    """Owns player, enemies, scene; ticks the simulation each frame."""

    MAX_SEGMENTS = 8  # laser bounce cap (renderer.cpp:137)

    def __init__(self, scene: Scene, enemies: list[Enemy],
                 intersect_fn=None, aspect: float = 16.0 / 9.0):
        """intersect_fn(origin (3,), dir (3,), medium=0) -> (t, mat,
        normal) queries the current scene; supplied by the app layer
        (a kernel trace or the CPU oracle, `ops/oracle.py`).  ``medium`` requests the
        interior exit march for rays travelling inside a glass material
        (Ray::medium_id, vv.cpp:166-232); providers without medium
        support may ignore the kwarg (the laser then degrades to
        pass-through)."""
        self.scene = scene
        self.enemies = enemies
        self.player = Player()
        self.state = GameState.MENU
        self.score = 0
        self.time = 0.0
        self.aspect = aspect
        self.intersect_fn = intersect_fn
        self.laser_path: list[np.ndarray] = []

    def start(self):
        self.state = GameState.GAME
        self.score = 0
        self.time = 0.0
        for e in self.enemies:
            e.respawn()

    def tick(self, dt: float, inp: Input):
        """One frame of simulation (game.cpp:28-98 flow). Returns the
        camera for rendering."""
        if self.state != GameState.GAME:
            return self.player.camera(self.aspect)

        self.time += dt

        # Enemy steering (may catch the player -> game over)
        for e in self.enemies:
            caught = e.tick(dt, self.player.pos, self.enemies)
            if caught:
                self.state = GameState.GAME_OVER

        # Player movement
        pos, target, self.depth_delta = self.player.tick(dt, inp)

        # Laser: path through the scene, damage first enemy hit
        self.laser_path = []
        if inp.fire and self.intersect_fn is not None:
            self._fire_laser()

        return self.player.camera(self.aspect)

    def _fire_laser(self):
        """Trace the laser polyline (Renderer::path semantics,
        renderer.cpp:120-155) and apply damage at each diffuse hit."""
        rot = _yaw_pitch(self.player.yaw, self.player.pitch)
        origin = self.player.pos.astype(np.float32)
        direction = rot @ np.array([0, 0, -1.0], np.float32)
        medium = 0
        self.laser_path = [origin.copy()]

        for _ in range(self.MAX_SEGMENTS):
            try:
                t, mat, normal = self.intersect_fn(
                    origin, direction, medium=medium)
            except TypeError:     # legacy provider without medium support
                t, mat, normal = self.intersect_fn(origin, direction)
            if t >= BIG_F32 * 0.99:
                self.laser_path.append(origin + direction * 1000.0)
                break
            hit_point = origin + direction * t + normal * 1e-4
            self.laser_path.append(hit_point)
            row = _material_row(int(mat))
            if row == 1:      # mirror: reflect and continue (fresh ray
                direction = direction - 2.0 * (direction @ normal) * normal
                origin = hit_point
                medium = 0    # -> medium resets, materials.cpp:63-65)
                continue
            if row == 0:      # glass: continue the SAME ray inside the
                medium = int(mat)   # medium (materials.cpp:60-62); the
                continue            # next hit is the interior exit
            # diffuse: damage whichever enemy owns the hit voxel
            for e in self.enemies:
                vx, vy, vz = e.model.to_grid(hit_point - normal * 0.001)
                gx, gy, gz = e.model.grid_size
                if 0 <= vx < gx and 0 <= vy < gy and 0 <= vz < gz:
                    if e.process_hit(hit_point, normal):
                        self.score += 100   # kill
                    else:
                        self.score += 1     # chip damage
                    break
            break

    def hud_lines(self) -> list[str]:
        """Score/state text for the HUD overlay (game.cpp:134-143)."""
        if self.state == GameState.MENU:
            return ["MENU", "FIRE TO START"]
        if self.state == GameState.GAME_OVER:
            return ["GAME OVER", f"SCORE: {self.score}"]
        return [f"SCORE: {self.score}", f"TIME: {self.time:.1f}"]


def _yaw_pitch(yaw: float, pitch: float) -> np.ndarray:
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float32)
    rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]], np.float32)
    return ry @ rx
