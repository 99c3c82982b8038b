"""Small 3D math on batched tensors with a trailing axis of size 3:
vectors, quaternions, rigid transforms.

Counterpart of `voxel_tracer_tpu/ops/math3d.py` (the reference template
math layer, `template/tmpl8math.h`).  Rigid transforms are a (3, 3)
rotation and a (3,) translation, as there.  Matrix-vector products are
written out elementwise in a fixed order, not as `torch.matmul`, so a
card and the CPU round them alike.  `noise3d` is host-side numpy and is
copied verbatim so the procedural grids match the JAX package bit for
bit.
"""

from __future__ import annotations

import numpy as np
import torch

BIG_F32 = 1e30  # reference: template/types.h:19


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched 3D dot product over the trailing axis."""
    return torch.sum(a * b, dim=-1)


def norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(dot(v, v))


def normalize(v: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """``v`` over its length; a non-zero ``eps`` is the least length
    divided by."""
    n = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
    if eps:
        n = torch.clamp(n, min=eps)
    return v / n


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def reflect(d: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Mirror reflection of direction ``d`` about unit normal ``n``."""
    return d - 2.0 * dot(d, n)[..., None] * n


def sign_dir(d: torch.Tensor) -> torch.Tensor:
    """Per-axis ray-direction sign (+1 / -1), positive for +0.

    The sign bit alone decides (src/graphics/rays/ray.h:80-97): d >= +0 ->
    +1, d < 0 including -0 -> -1.
    """
    return torch.where(torch.signbit(d), -1.0, 1.0).to(d.dtype)


def safe_rcp(d: torch.Tensor) -> torch.Tensor:
    """1/d with the IEEE inf behavior the slab/DDA math relies on."""
    return 1.0 / d


# ---------------------------------------------------------------------------
# Quaternions (w, x, y, z) — analog of template/tmpl8math.h:888-1030.
# ---------------------------------------------------------------------------

def quat_identity(device="cuda") -> torch.Tensor:
    return torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=torch.float32, device=device)


def quat_from_axis_angle(axis, angle, device="cuda") -> torch.Tensor:
    """Unit quaternion rotating by ``angle`` radians about ``axis``, on
    the device of whichever of the two is a tensor, else on ``device``."""
    like = next((x for x in (axis, angle) if torch.is_tensor(x)), None)
    device = like.device if like is not None else device
    axis = torch.as_tensor(axis, dtype=torch.float32, device=device)
    axis = axis / norm(axis)
    half = torch.as_tensor(angle, dtype=torch.float32, device=device) * 0.5
    return torch.cat([torch.cos(half)[None], axis * torch.sin(half)], dim=0)


def quat_mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-1)


def quat_to_mat3(q: torch.Tensor) -> torch.Tensor:
    """(…, 4) quaternion -> (…, 3, 3) rotation matrix."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def _mat3_apply(rot: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """R @ v over the trailing axis, elementwise in a fixed order."""
    return torch.stack([
        rot[..., 0, 0] * v[..., 0] + rot[..., 0, 1] * v[..., 1] + rot[..., 0, 2] * v[..., 2],
        rot[..., 1, 0] * v[..., 0] + rot[..., 1, 1] * v[..., 1] + rot[..., 1, 2] * v[..., 2],
        rot[..., 2, 0] * v[..., 0] + rot[..., 2, 1] * v[..., 1] + rot[..., 2, 2] * v[..., 2],
    ], dim=-1)


def _mat3_t_apply(rot: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """R^T @ v over the trailing axis, elementwise in a fixed order."""
    return torch.stack([
        rot[..., 0, 0] * v[..., 0] + rot[..., 1, 0] * v[..., 1] + rot[..., 2, 0] * v[..., 2],
        rot[..., 0, 1] * v[..., 0] + rot[..., 1, 1] * v[..., 1] + rot[..., 2, 1] * v[..., 2],
        rot[..., 0, 2] * v[..., 0] + rot[..., 1, 2] * v[..., 1] + rot[..., 2, 2] * v[..., 2],
    ], dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) ``v`` by quaternion ``q``."""
    return _mat3_apply(quat_to_mat3(q), v)


# ---------------------------------------------------------------------------
# Rigid transforms: world = R @ (local - pivot) + pos
# (analog of OBB model = T(pos) * R * T(-pivot), obb.cpp:26-35)
# ---------------------------------------------------------------------------

def rigid_forward(rot3, pos, pivot, p_local):
    """local -> world points."""
    return _mat3_apply(rot3, p_local - pivot) + pos


def rigid_inverse_point(rot3, pos, pivot, p_world):
    """world -> local points (rot3 orthonormal, so inverse = transpose)."""
    return _mat3_t_apply(rot3, p_world - pos) + pivot


def rigid_forward_vec(rot3, v_local):
    """local -> world directions."""
    return _mat3_apply(rot3, v_local)


def rigid_inverse_vec(rot3, v_world):
    """world -> local directions."""
    return _mat3_t_apply(rot3, v_world)


# ---------------------------------------------------------------------------
# Perlin-style value noise — analog of template/tmpl8math.cpp:60-112 noise3D,
# used by the procedurally filled volume constructor (vv.cpp:88-117).
# ---------------------------------------------------------------------------

_PERLIN_PERM = np.random.RandomState(1234).permutation(256)
_PERLIN_PERM = np.concatenate([_PERLIN_PERM, _PERLIN_PERM]).astype(np.int32)

_GRAD3 = np.array(
    [
        [1, 1, 0], [-1, 1, 0], [1, -1, 0], [-1, -1, 0],
        [1, 0, 1], [-1, 0, 1], [1, 0, -1], [-1, 0, -1],
        [0, 1, 1], [0, -1, 1], [0, 1, -1], [0, -1, -1],
    ],
    dtype=np.float32,
)


def noise3d(x, y, z):
    """Deterministic gradient noise in [-1, 1]; numpy, host-side scene setup."""
    x, y, z = np.asarray(x, np.float32), np.asarray(y, np.float32), np.asarray(z, np.float32)
    xi, yi, zi = np.floor(x).astype(np.int32) & 255, np.floor(y).astype(np.int32) & 255, np.floor(z).astype(np.int32) & 255
    xf, yf, zf = x - np.floor(x), y - np.floor(y), z - np.floor(z)

    def fade(t):
        return t * t * t * (t * (t * 6 - 15) + 10)

    u, v, w = fade(xf), fade(yf), fade(zf)
    perm = _PERLIN_PERM

    def grad_at(ix, iy, iz, fx, fy, fz):
        h = perm[perm[perm[ix] + iy] + iz] % 12
        g = _GRAD3[h]
        return g[..., 0] * fx + g[..., 1] * fy + g[..., 2] * fz

    n000 = grad_at(xi, yi, zi, xf, yf, zf)
    n100 = grad_at(xi + 1, yi, zi, xf - 1, yf, zf)
    n010 = grad_at(xi, yi + 1, zi, xf, yf - 1, zf)
    n110 = grad_at(xi + 1, yi + 1, zi, xf - 1, yf - 1, zf)
    n001 = grad_at(xi, yi, zi + 1, xf, yf, zf - 1)
    n101 = grad_at(xi + 1, yi, zi + 1, xf - 1, yf, zf - 1)
    n011 = grad_at(xi, yi + 1, zi + 1, xf, yf - 1, zf - 1)
    n111 = grad_at(xi + 1, yi + 1, zi + 1, xf - 1, yf - 1, zf - 1)

    def lerp(a, b, t):
        return a + t * (b - a)

    nx00 = lerp(n000, n100, u)
    nx10 = lerp(n010, n110, u)
    nx01 = lerp(n001, n101, u)
    nx11 = lerp(n011, n111, u)
    nxy0 = lerp(nx00, nx10, v)
    nxy1 = lerp(nx01, nx11, v)
    return lerp(nxy0, nxy1, w)
