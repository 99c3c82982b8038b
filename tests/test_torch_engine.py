"""Parity: the port's engine layer (pool, GJK, SAT, physics world) and
space-filling curves against the JAX package's, on tests/test_engine.py's
cases and on seed-made inputs.  Both are numpy on the host, so results
are equal, not close."""

import numpy as np
import pytest

from voxel_tracer_tpu.engine import gjk as jgjk, physics as jphys, sat as jsat
from voxel_tracer_tpu.ops import curves as jcurves
from voxel_tracer_tpu_torch.engine import gjk, physics, sat
from voxel_tracer_tpu_torch.engine.pool import Pool
from voxel_tracer_tpu_torch.ops import curves


def test_pool_add_remove_iterate():
    p = Pool(4)
    h1 = p.add("a")
    h2 = p.add("b")
    assert len(p) == 2 and sorted(p) == ["a", "b"]
    p.remove(h1)
    assert len(p) == 1 and p.get(h1) is None and p.get(h2) == "b"
    for x in "cde":
        p.add(x)
    assert len(p) == 4 and list(p.handles()) == [0, 1, 2, 3]
    with pytest.raises(RuntimeError):
        p.add("f")


def _rot(angle, axis):
    c, s = np.cos(angle), np.sin(angle)
    i, j = [k for k in range(3) if k != axis]
    r = np.eye(3)
    r[i, i], r[i, j], r[j, i], r[j, j] = c, -s, s, c
    return r


def test_gjk_cases_of_test_engine():
    a = gjk.SphereSupport((0, 0, 0), 1.0)
    assert gjk.gjk_intersect(a, gjk.SphereSupport((1.5, 0, 0), 1.0))
    assert not gjk.gjk_intersect(a, gjk.SphereSupport((3.0, 0, 0), 1.0))
    box = gjk.BoxSupport((0, 0, 0), np.eye(3), (1, 1, 1))
    assert gjk.gjk_intersect(box, gjk.SphereSupport((1.5, 0, 0), 0.6))
    assert not gjk.gjk_intersect(box, gjk.SphereSupport((3.0, 3.0, 0), 0.5))
    rot = _rot(0.78, 2)
    assert gjk.gjk_intersect(box, gjk.BoxSupport((2.3, 0, 0), rot, (1, 1, 1)))
    assert not gjk.gjk_intersect(box, gjk.BoxSupport((2.6, 0, 0), rot, (1, 1, 1)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gjk_and_sat_match_jax(seed):
    """Random box and sphere pairs: GJK and the 15-axis SAT give the JAX
    package's answers, and GJK agrees with SAT on box pairs."""
    rng = np.random.RandomState(seed)
    for _ in range(60):
        c1, c2 = rng.randn(2, 3) * 1.5
        r1, r2 = _rot(rng.rand() * 3, rng.randint(3)), _rot(rng.rand() * 3, rng.randint(3))
        h1, h2 = rng.rand(2, 3) + 0.2
        got = gjk.gjk_intersect(gjk.BoxSupport(c1, r1, h1), gjk.BoxSupport(c2, r2, h2))
        ref = jgjk.gjk_intersect(jgjk.BoxSupport(c1, r1, h1), jgjk.BoxSupport(c2, r2, h2))
        assert got == ref
        s = sat.box_box_sat(c1, r1, h1, c2, r2, h2)
        assert s == jsat.box_box_sat(c1, r1, h1, c2, r2, h2)
        assert s == got
        rad = rng.rand() + 0.1
        assert (gjk.gjk_intersect(gjk.BoxSupport(c1, r1, h1), gjk.SphereSupport(c2, rad))
                == jgjk.gjk_intersect(jgjk.BoxSupport(c1, r1, h1),
                                      jgjk.SphereSupport(c2, rad)))


def test_aabb_pyramid_sat_matches_jax():
    rng = np.random.RandomState(4)
    origin = np.zeros(3, np.float32)
    corners = np.array([[-1, 1, 2], [1, 1, 2], [-1, -1, 2], [1, -1, 2]], np.float32)
    planes = rng.randn(4, 4).astype(np.float32)
    for _ in range(40):
        lo = (rng.randn(3) * 3).astype(np.float32)
        hi = lo + rng.rand(3).astype(np.float32) + 0.1
        for acc in (False, True):
            assert (sat.aabb_pyramid_sat(lo, hi, origin, corners, planes, acc)
                    == jsat.aabb_pyramid_sat(lo, hi, origin, corners, planes, acc))


def _world(pkg):
    world = pkg.PhyWorld()
    world.add_object(pkg.PhyObject(pos=np.zeros(3), is_static=True,
                                   collider=pkg.PlaneCollider()))
    ball = pkg.PhyObject(pos=np.array([0.0, 5.0, 0.0]), collider=pkg.SphereCollider(0.5))
    box = pkg.PhyObject(pos=np.array([0.3, 7.0, 0.1]), collider=pkg.BoxCollider())
    hits = []
    box.on_collide = lambda other: hits.append(type(other.collider).__name__)
    world.add_object(ball)
    world.add_object(box)
    return world, ball, box, hits


def test_physics_world_matches_jax():
    """test_engine.py's falling ball plus a box that lands on it: every
    position, velocity and collision callback equals the JAX world's."""
    tw, tb, tx, th = _world(physics)
    jw, jb, jx, jh = _world(jphys)
    for _ in range(300):
        tw.step(1 / 60)
        jw.step(1 / 60)
        for a, b in ((tb, jb), (tx, jx)):
            np.testing.assert_array_equal(a.pos, b.pos)
            np.testing.assert_array_equal(a.vel, b.vel)
    assert tb.pos[1] < 5.0 and np.linalg.norm(tb.vel) < 1.0
    assert th == jh and th


def test_physics_dispatch_type_swap():
    s = physics.PhyObject(pos=np.zeros(3), collider=physics.SphereCollider(1.0))
    b = physics.PhyObject(pos=np.array([1.2, 0, 0]), collider=physics.BoxCollider())
    assert physics.test_collision(s, b) and physics.test_collision(b, s)
    far = physics.PhyObject(pos=np.array([9.0, 0, 0]), collider=physics.VoxelCollider())
    assert not physics.test_collision(s, far)


def test_morton_codes_match_jax():
    rng = np.random.RandomState(0)
    x, y, z = (rng.randint(0, 1024, 500).astype(np.uint32) for _ in range(3))
    code = curves.morton3_encode(x, y, z)
    np.testing.assert_array_equal(code, jcurves.morton3_encode(x, y, z))
    for a, b in zip(curves.morton3_decode(code), (x, y, z)):
        np.testing.assert_array_equal(a, b)
    x2, y2 = (rng.randint(0, 65536, 500).astype(np.uint32) for _ in range(2))
    code2 = curves.morton2_encode(x2, y2)
    np.testing.assert_array_equal(code2, jcurves.morton2_encode(x2, y2))
    for a, b in zip(curves.morton2_decode(code2), (x2, y2)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("order", [1, 2, 3])
def test_hilbert_table_matches_jax(order):
    lut = curves.hilbert3_table(order)
    np.testing.assert_array_equal(lut, jcurves.hilbert3_table(order))
    n = 1 << order
    assert sorted(lut.ravel().tolist()) == list(range(n ** 3))
    pos = np.zeros((n ** 3, 3), np.int32)
    for zz in range(n):
        for yy in range(n):
            for xx in range(n):
                pos[lut[zz, yy, xx]] = (xx, yy, zz)
    assert (np.abs(np.diff(pos, axis=0)).sum(axis=1) == 1).all()


def test_brick_morton_layout_matches_jax():
    g = np.random.RandomState(2).randint(0, 256, (16, 8, 24)).astype(np.uint8)
    got = curves.brick_linear_to_morton(g)
    np.testing.assert_array_equal(got, jcurves.brick_linear_to_morton(g))
    assert got.shape == (2 * 1 * 3, 512)
