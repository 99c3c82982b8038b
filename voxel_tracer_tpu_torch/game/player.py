"""Player drone flight (src/game/player.{h,cpp} analog, headless).

Input arrives as an `Input` struct instead of GLFW key polling; the returned
depth delta feeds temporal-reprojection depth compensation
(player.cpp:36-47, renderer.cpp:318).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from voxel_tracer_tpu_torch.models.camera import Camera


def _quat_axis_angle(axis, angle):
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    h = angle * 0.5
    return np.concatenate([[np.cos(h)], axis * np.sin(h)])


def _quat_mul(a, b):
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ])


def _quat_rot(q, v):
    w, x, y, z = q
    u = np.array([x, y, z])
    return (2 * (u @ v) * u + (w * w - u @ u) * np.asarray(v)
            + 2 * w * np.cross(u, v))


@dataclasses.dataclass
class Input:
    """One frame of input: movement in {-1,0,1}, mouse delta in pixels."""

    forward: float = 0.0   # W/S
    strafe: float = 0.0    # A/D
    up: float = 0.0        # Space/Shift
    mouse_dx: float = 0.0
    mouse_dy: float = 0.0
    fire: bool = False


class Player:
    """Drone flight: yaw/pitch from mouse, exp-damped velocity."""

    MOVE_SPEED = 20.0
    VMOVE_SPEED = 35.0

    def __init__(self, pos=(0.0, 0.0, -2.0)):
        self.pos = np.asarray(pos, np.float64)
        self.velocity = np.zeros(3)
        self.yaw = 0.0
        self.pitch = 0.0

    def tick(self, dt: float, inp: Input):
        """Returns (camera_pos, camera_target, depth_delta)."""
        self.yaw += inp.mouse_dx * 0.05 * dt
        self.pitch -= inp.mouse_dy * 0.05 * dt
        self.pitch = float(np.clip(self.pitch, -1.5, 0.4))   # player.cpp:18-19

        rot = _quat_mul(_quat_axis_angle((0, 1, 0), self.yaw),
                        _quat_axis_angle((1, 0, 0), self.pitch))
        up = _quat_rot(rot, (0, 1, 0))
        ahead = _quat_rot(rot, (0, 0, -1))
        side = _quat_rot(rot, (1, 0, 0))

        self.velocity += self.MOVE_SPEED * dt * (
            ahead * inp.forward + side * (-inp.strafe))
        self.velocity += self.VMOVE_SPEED * dt * up * inp.up
        self.velocity *= 0.3 ** dt                            # player.cpp:40
        prev = self.pos.copy()
        self.pos = self.pos + self.velocity * dt
        depth_delta = float(ahead @ self.pos - ahead @ prev)  # player.cpp:44
        return self.pos.copy(), self.pos + ahead, depth_delta

    def camera(self, aspect: float = 16.0 / 9.0) -> Camera:
        rot = _quat_mul(_quat_axis_angle((0, 1, 0), self.yaw),
                        _quat_axis_angle((1, 0, 0), self.pitch))
        ahead = _quat_rot(rot, (0, 0, -1))
        return Camera.create(self.pos, self.pos + ahead, aspect)
