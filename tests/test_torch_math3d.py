"""Parity of the port's math3d and tonemap helpers with the JAX package's.

Inputs are made with numpy from a seed and go through the JAX function and
its port.  Tolerances: the quaternion and rigid-transform helpers within
rtol 1e-6, atol 1e-6 (JAX's `@` is an XLA dot, the port's products are
written out elementwise, so the last bit may differ); `quat_identity`
equal; `norm`, `safe_rcp`, `normalize(eps=)` and `reinhard_extended`
within 1 ulp (rtol 1.2e-7).  `composite._to_local` runs through
`rigid_inverse_point` / `rigid_inverse_vec` and stays bit for bit what it
was: R^T (p - pos) + pivot and R^T d, written out in a fixed order.
"""

import numpy as np
import torch

import jax.numpy as jnp

from voxel_tracer_tpu.ops import math3d as jm
from voxel_tracer_tpu.ops import tonemap as jtonemap

from voxel_tracer_tpu_torch.ops import composite as tcomposite
from voxel_tracer_tpu_torch.ops import math3d as tm
from voxel_tracer_tpu_torch.ops import tonemap as ttonemap

torch.set_num_threads(1)

RTOL = ATOL = 1e-6
ULP_RTOL = 1.2e-7
N = 64


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(seed=0):
    """Unit axes, angles, points and vectors (|.| <= 10), one rotation
    each from JAX's quaternions, positions and pivots."""
    rng = np.random.RandomState(seed)
    axes = rng.randn(N, 3).astype(np.float32)
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    angles = rng.uniform(-np.pi, np.pi, N).astype(np.float32)

    def ball(n):
        v = rng.randn(n, 3)
        v *= rng.uniform(0, 10, (n, 1)) / np.linalg.norm(v, axis=1, keepdims=True)
        return v.astype(np.float32)

    quats = np.stack([np.asarray(jm.quat_from_axis_angle(a, float(t)))
                      for a, t in zip(axes, angles)])
    return dict(axes=axes, angles=angles, quats=quats,
                rots=np.asarray(jm.quat_to_mat3(jnp.asarray(quats))),
                p=ball(N), v=ball(N), pos=ball(N), pivot=ball(N))


def test_quaternions_match_jax():
    x = _inputs()
    got = torch.stack([tm.quat_from_axis_angle(_t(a), float(t))
                       for a, t in zip(x["axes"], x["angles"])])
    np.testing.assert_allclose(got.numpy(), x["quats"], rtol=RTOL, atol=ATOL)
    # a tuple axis and a float angle land on the device asked for
    q = tm.quat_from_axis_angle((0.3, 1, 0.2), 0.9, device="cpu")
    np.testing.assert_allclose(q.numpy(), np.asarray(jm.quat_from_axis_angle((0.3, 1, 0.2), 0.9)),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(tm.quat_identity(device="cpu").numpy(),
                                  np.asarray(jm.quat_identity()))
    q1, q2 = x["quats"], np.roll(x["quats"], 1, axis=0)
    np.testing.assert_allclose(tm.quat_mul(_t(q1), _t(q2)).numpy(),
                               np.asarray(jm.quat_mul(jnp.asarray(q1), jnp.asarray(q2))),
                               rtol=RTOL, atol=ATOL)
    mat = tm.quat_to_mat3(_t(q1))
    assert mat.shape == (N, 3, 3)
    np.testing.assert_allclose(mat.numpy(), x["rots"], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tm.quat_rotate(_t(q1), _t(x["v"])).numpy(),
                               np.asarray(jm.quat_rotate(jnp.asarray(q1), jnp.asarray(x["v"]))),
                               rtol=RTOL, atol=ATOL)


def test_rigid_transforms_match_jax():
    x = _inputs(1)
    rot, pos, piv, p, v = (x[k] for k in ("rots", "pos", "pivot", "p", "v"))
    jr, jpos, jpiv, jp, jv = (jnp.asarray(a) for a in (rot, pos, piv, p, v))
    tr, tpos, tpiv, tp, tv = (_t(a) for a in (rot, pos, piv, p, v))
    for got, ref in (
            (tm.rigid_forward(tr, tpos, tpiv, tp), jm.rigid_forward(jr, jpos, jpiv, jp)),
            (tm.rigid_inverse_point(tr, tpos, tpiv, tp),
             jm.rigid_inverse_point(jr, jpos, jpiv, jp)),
            (tm.rigid_forward_vec(tr, tv), jm.rigid_forward_vec(jr, jv)),
            (tm.rigid_inverse_vec(tr, tv), jm.rigid_inverse_vec(jr, jv))):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
    # one rotation for every point, as a volume's transform is applied
    np.testing.assert_allclose(
        tm.rigid_inverse_point(tr[0], tpos[0], tpiv[0], tp).numpy(),
        np.asarray(jm.rigid_inverse_point(jr[0], jpos[0], jpiv[0], jp)), rtol=RTOL, atol=ATOL)
    # forward then inverse is the identity up to rounding
    back = tm.rigid_inverse_point(tr, tpos, tpiv, tm.rigid_forward(tr, tpos, tpiv, tp))
    np.testing.assert_allclose(back.numpy(), p, atol=1e-5)


def test_to_local_is_bit_identical_to_the_written_out_transform():
    x = _inputs(2)
    rot, pos, piv = (_t(x[k][0]) for k in ("rots", "pos", "pivot"))
    o, d = _t(x["p"]), _t(x["v"])
    o_l, d_l = tcomposite._to_local(rot, pos, piv, o, d)

    def rt_apply(v):
        return torch.stack([rot[0, c] * v[:, 0] + rot[1, c] * v[:, 1] + rot[2, c] * v[:, 2]
                            for c in range(3)], dim=-1)

    assert torch.equal(o_l, rt_apply(o - pos) + piv)
    assert torch.equal(d_l, rt_apply(d))


def test_norm_rcp_normalize_and_reinhard_within_one_ulp():
    rng = np.random.RandomState(3)
    v = (rng.randn(N, 3) * 4).astype(np.float32)
    v[:8] *= 1e-5                              # shorter than eps
    v[8] = 0.0
    np.testing.assert_allclose(tm.norm(_t(v)).numpy(), np.asarray(jm.norm(jnp.asarray(v))),
                               rtol=ULP_RTOL)
    got = tm.normalize(_t(v), eps=1e-3).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.normalize(jnp.asarray(v), eps=1e-3)),
                               rtol=ULP_RTOL)
    assert np.all(np.linalg.norm(got[:9], axis=1) < 1.0)   # clamped, not unit
    np.testing.assert_allclose(tm.normalize(_t(v[9:])).numpy(),
                               np.asarray(jm.normalize(jnp.asarray(v[9:]))), rtol=ULP_RTOL)
    d = v.ravel().copy()
    d[:2] = [0.0, -0.0]
    got = tm.safe_rcp(_t(d)).numpy()
    ref = np.asarray(jm.safe_rcp(jnp.asarray(d)))
    assert got[0] == np.inf and got[1] == -np.inf
    np.testing.assert_allclose(got, ref, rtol=ULP_RTOL)
    c = (rng.rand(4096, 3) * 8).astype(np.float32)
    for max_white in (1.0, 4.0, 11.2):
        np.testing.assert_allclose(
            ttonemap.reinhard_extended(_t(c), max_white).numpy(),
            np.asarray(jtonemap.reinhard_extended(jnp.asarray(c), max_white)), rtol=ULP_RTOL)
