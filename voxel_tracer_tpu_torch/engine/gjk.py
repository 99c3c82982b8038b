"""GJK convex intersection test (src/engine/physics/collision/gjk.cpp:7-30 +
simplex.h analog): simplex evolution with line/triangle/tetrahedron cases.

Counterpart of `voxel_tracer_tpu/engine/gjk.py`, numpy on the host.
"""

from __future__ import annotations

import numpy as np


def _support(shape_a, shape_b, d):
    """Minkowski-difference support point."""
    return shape_a.furthest_point(d) - shape_b.furthest_point(-d)


class SphereSupport:
    def __init__(self, center, radius):
        self.center = np.asarray(center, np.float64)
        self.radius = float(radius)

    def furthest_point(self, d):
        n = np.linalg.norm(d)
        if n < 1e-12:
            return self.center
        return self.center + d / n * self.radius


class BoxSupport:
    def __init__(self, center, axes, half_ext):
        self.center = np.asarray(center, np.float64)
        self.axes = np.asarray(axes, np.float64)      # rows
        self.half_ext = np.asarray(half_ext, np.float64)

    def furthest_point(self, d):
        signs = np.sign(self.axes @ d)
        signs[signs == 0] = 1.0
        return self.center + (signs * self.half_ext) @ self.axes


class PointSupport:
    def __init__(self, p):
        self.p = np.asarray(p, np.float64)

    def furthest_point(self, d):
        return self.p


def gjk_intersect(shape_a, shape_b, max_iters: int = 32) -> bool:
    """True when the two convex shapes overlap."""
    d = np.array([1.0, 0.0, 0.0])
    simplex = [_support(shape_a, shape_b, d)]
    d = -simplex[0]
    for _ in range(max_iters):
        if np.linalg.norm(d) < 1e-12:
            return True
        a = _support(shape_a, shape_b, d)
        if a @ d < 0:
            return False
        simplex.append(a)
        hit, simplex, d = _next_simplex(simplex)
        if hit:
            return True
    return False


def _next_simplex(s):
    if len(s) == 2:
        return _line(s)
    if len(s) == 3:
        return _triangle(s)
    return _tetrahedron(s)


def _same_dir(a, b):
    return a @ b > 0


def _line(s):
    b, a = s[0], s[1]
    ab, ao = b - a, -a
    if _same_dir(ab, ao):
        d = np.cross(np.cross(ab, ao), ab)
    else:
        s = [a]
        d = ao
        return False, s, d
    return False, [b, a], d


def _triangle(s):
    c, b, a = s[0], s[1], s[2]
    ab, ac, ao = b - a, c - a, -a
    abc = np.cross(ab, ac)
    if _same_dir(np.cross(abc, ac), ao):
        if _same_dir(ac, ao):
            return False, [c, a], np.cross(np.cross(ac, ao), ac)
        return _line([b, a])
    if _same_dir(np.cross(ab, abc), ao):
        return _line([b, a])
    if _same_dir(abc, ao):
        return False, [c, b, a], abc
    return False, [b, c, a], -abc


def _tetrahedron(s):
    d0, c, b, a = s[0], s[1], s[2], s[3]
    ab, ac, ad, ao = b - a, c - a, d0 - a, -a
    abc = np.cross(ab, ac)
    acd = np.cross(ac, ad)
    adb = np.cross(ad, ab)
    if _same_dir(abc, ao):
        return _triangle([c, b, a])
    if _same_dir(acd, ao):
        return _triangle([d0, c, a])
    if _same_dir(adb, ao):
        return _triangle([b, d0, a])
    return True, s, np.zeros(3)
