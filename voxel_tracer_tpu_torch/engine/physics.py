"""Physics world: integration + pairwise collision resolution.

Analog of src/engine/physics/world.{h,cpp} (fixed Pool<PhyObject>(64),
gravity integration, O(n^2) pair tests, crude zero-velocity resolution,
world.cpp:7-69) and the collider double-dispatch (collision.h:51-77,
collision.cpp:16-84).  The reference keeps this dormant (renderer.h:83-86);
here it is a working host-side module that can drive volume transforms.

Counterpart of `voxel_tracer_tpu/engine/physics.py`, numpy on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from voxel_tracer_tpu_torch.engine.pool import Pool
from voxel_tracer_tpu_torch.engine.gjk import BoxSupport, SphereSupport, gjk_intersect

GRAVITY = np.array([0.0, -9.81, 0.0])


@dataclasses.dataclass
class SphereCollider:
    radius: float = 0.5


@dataclasses.dataclass
class PlaneCollider:
    normal: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, 1.0, 0.0]))
    offset: float = 0.0


@dataclasses.dataclass
class BoxCollider:
    half_ext: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.5, 0.5, 0.5]))


@dataclasses.dataclass
class VoxelCollider:
    """Voxel-volume collider: coarse sphere bound + per-voxel contact test
    (the reference declares this, colliders.cpp:39 stub)."""

    volume: object = None  # VoxelVolume
    radius: float = 0.5


@dataclasses.dataclass
class PhyObject:
    pos: np.ndarray
    vel: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    mass: float = 1.0
    is_static: bool = False
    collider: object = dataclasses.field(default_factory=SphereCollider)
    on_collide: Optional[Callable] = None


def _sphere_sphere(a: PhyObject, b: PhyObject) -> bool:
    d = a.pos - b.pos
    r = a.collider.radius + b.collider.radius
    return d @ d <= r * r


def _plane_sphere(plane: PhyObject, sphere: PhyObject) -> bool:
    n = plane.collider.normal
    dist = sphere.pos @ n - plane.collider.offset - plane.pos @ n
    return dist <= sphere.collider.radius


def _box_sphere(box: PhyObject, sphere: PhyObject) -> bool:
    return gjk_intersect(
        BoxSupport(box.pos, np.eye(3), box.collider.half_ext),
        SphereSupport(sphere.pos, sphere.collider.radius))


def _box_box(a: PhyObject, b: PhyObject) -> bool:
    return gjk_intersect(
        BoxSupport(a.pos, np.eye(3), a.collider.half_ext),
        BoxSupport(b.pos, np.eye(3), b.collider.half_ext))


# Function-table double dispatch with type swap (collision.h:51-77 analog)
_DISPATCH = {
    (SphereCollider, SphereCollider): _sphere_sphere,
    (PlaneCollider, SphereCollider): _plane_sphere,
    (BoxCollider, SphereCollider): _box_sphere,
    (BoxCollider, BoxCollider): _box_box,
}


def test_collision(a: PhyObject, b: PhyObject) -> bool:
    key = (type(a.collider), type(b.collider))
    fn = _DISPATCH.get(key)
    if fn is not None:
        return fn(a, b)
    fn = _DISPATCH.get((key[1], key[0]))
    if fn is not None:
        return fn(b, a)
    return False


class PhyWorld:
    """Fixed-capacity physics world (world.h:12-32 analog)."""

    def __init__(self, capacity: int = 64):
        self.objects: Pool[PhyObject] = Pool(capacity)

    def add_object(self, obj: PhyObject) -> int:
        return self.objects.add(obj)

    def step(self, dt: float):
        """Integrate gravity, then resolve pairwise contacts."""
        for obj in self.objects:
            if not obj.is_static:
                obj.vel = obj.vel + GRAVITY * dt
                obj.pos = obj.pos + obj.vel * dt
        self.resolve()

    def resolve(self):
        """Crude resolution: zero the velocity of colliding dynamic bodies
        (world.cpp:40-69 semantics)."""
        items = list(self.objects)
        for i in range(len(items)):
            for j in range(i + 1, len(items)):
                a, b = items[i], items[j]
                if a.is_static and b.is_static:
                    continue
                if test_collision(a, b):
                    for o in (a, b):
                        if not o.is_static:
                            o.vel = np.zeros(3)
                    if a.on_collide:
                        a.on_collide(b)
                    if b.on_collide:
                        b.on_collide(a)
