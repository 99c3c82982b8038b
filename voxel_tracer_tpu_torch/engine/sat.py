"""Separating-axis tests (src/engine/physics/collision/sat.h analog).

Includes the 15-axis box-box SAT and the box-pyramid SAT that the reference
render path uses for coherent packet/BVH culling (sat.h:164-213,
bvh.cpp:310,350) — here used by the tile-frustum culling prepass.
NumPy, host-side (vectorized over boxes).

Counterpart of `voxel_tracer_tpu/engine/sat.py`.
"""

from __future__ import annotations

import numpy as np


def _project_box(center, axes, half_ext, n):
    """Interval of an OBB projected on axis n: (mid, radius)."""
    mid = center @ n
    r = np.abs((axes * half_ext[:, None]) @ n).sum(axis=-1)
    return mid, r


def box_box_sat(c1, axes1, he1, c2, axes2, he2) -> bool:
    """15-axis OBB-OBB overlap test (sat.h box_box analog).

    axes: (3, 3) rows = local axes; he: (3,) half extents.
    """
    tests = list(axes1) + list(axes2)
    for i in range(3):
        for j in range(3):
            cx = np.cross(axes1[i], axes2[j])
            ln = np.linalg.norm(cx)
            if ln > 1e-8:
                tests.append(cx / ln)
    for n in tests:
        m1, r1 = _project_box(c1, axes1, he1, n)
        m2, r2 = _project_box(c2, axes2, he2, n)
        if abs(m1 - m2) > r1 + r2:
            return False
    return True


def aabb_pyramid_sat(bmin, bmax, origin, corner_dirs, planes,
                     accurate: bool = True):
    """Box vs view-pyramid SAT returning conservative entry distance.

    Analog of box_pyramid_sat (sat.h:164-213): the pyramid is given by its
    origin, 4 far-corner directions, and 4 inward plane normals; returns
    (overlaps, entry_distance_along_forward).

    accurate=False tests only box axes + planes (7 axes, common.h:30
    ACCURATE_PYRAMID_TRACING=0); accurate=True adds edge cross products.
    """
    bmin = np.asarray(bmin, np.float32)
    bmax = np.asarray(bmax, np.float32)
    center = (bmin + bmax) * 0.5
    he = (bmax - bmin) * 0.5
    eye = np.eye(3, dtype=np.float32)

    far = 1e5
    pyr_pts = np.concatenate(
        [origin[None], origin[None] + np.asarray(corner_dirs) * far], axis=0)

    axes = [eye[0], eye[1], eye[2]] + [p[:3] for p in planes]
    if accurate:
        edges = [corner_dirs[i] for i in range(4)]
        for e in edges:
            for a in eye:
                cx = np.cross(e, a)
                ln = np.linalg.norm(cx)
                if ln > 1e-8:
                    axes.append(cx / ln)

    entry = -np.inf
    for n in axes:
        bm = center @ n
        br = np.abs(eye @ n * he).sum()
        pproj = pyr_pts @ n
        pmin, pmax = pproj.min(), pproj.max()
        if bm - br > pmax or bm + br < pmin:
            return False, np.inf
    # conservative entry distance along the pyramid forward direction
    fwd = np.asarray(corner_dirs).mean(axis=0)
    fwd = fwd / np.linalg.norm(fwd)
    entry = max(0.0, (center - origin) @ fwd - np.abs(eye @ fwd * he).sum())
    return True, float(entry)
