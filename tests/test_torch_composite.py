"""Parity: the port's scene composition, primitives and compaction vs JAX.

A scene of two volume groups (three 16^3 volumes of one shape, so the
top-K candidate prepass runs with K = 2 < O = 3, and one 28x12x20 volume)
plus an analytic sphere and capsule, built in code, carried into the port
with `convert.scene_from_jax`, and traced by `ops/composite.py` in both
packages on the same numpy-seeded rays.
Tolerances: t within 1e-5 (world-space transforms and analytic roots in
float32), mat / obj / steps equal, voxel normals and albedo within 1e-5;
primitive normals (and the normal-as-color albedo) within 5e-4: near a grazing hit the quadratic's
discriminant cancels, so a one-ulp difference in its terms (PyTorch's CPU
float32 sqrt is not correctly rounded) moves the hit point along the
surface.
`masked_apply`: bit-equal to the uncompacted call.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from voxel_tracer_tpu.models.scene import Scene as JScene
from voxel_tracer_tpu.models.volume import VoxelVolume as JVolume
from voxel_tracer_tpu.ops import composite as jcomp
from voxel_tracer_tpu.ops import prims as jprims

from voxel_tracer_tpu_torch.convert import scene_from_jax
from voxel_tracer_tpu_torch.ops import composite, prims
from voxel_tracer_tpu_torch.ops.compact import bucket_caps, live_indices, masked_apply

torch.set_num_threads(1)

ATOL = 1e-5
PRIM_NORMAL_ATOL = 5e-4
N = 1024


def _shell(shape, glass, core):
    """A glass shell (id ``glass``) two voxels thick around a solid core."""
    g = np.zeros(shape, np.uint8)
    g[1:-1, 1:-1, 1:-1] = glass
    g[3:-3, 3:-3, 3:-3] = 0
    z, y, x = (s // 2 for s in shape)
    g[z - 2:z + 2, 3:y + 3, x - 2:x + 2] = core
    return g


@pytest.fixture(scope="module")
def scenes():
    rng = np.random.RandomState(3)
    pal = (rng.rand(256, 3) * 0.8 + 0.1).astype(np.float32)
    rot = np.array([[0.8, 0.0, 0.6], [0.0, 1.0, 0.0], [-0.6, 0.0, 0.8]], np.float32)
    vols = [JVolume(_shell((16, 16, 16), 3, 40), palette=pal, pos=(0.0, 0.0, 0.0)),
            JVolume(_shell((16, 16, 16), 3, 41), palette=pal, pos=(0.5, 0.1, 0.3),
                    rot=rot),
            JVolume(_shell((16, 16, 16), 5, 42), palette=pal, pos=(1.0, -0.1, 0.0)),
            JVolume(_shell((20, 12, 28), 3, 60), palette=pal, pos=(0.4, -0.5, 0.9))]
    sc = JScene(volumes=vols)
    sc.add_sphere((0.3, 0.5, -0.3), 0.12, mat=20, albedo=(0.2, 0.7, 0.3))
    sc.add_sphere((0.9, 0.4, 0.5), 0.1)                 # normal-as-color albedo
    sc.add_capsule((-0.3, -0.2, 0.0), (0.2, 0.4, 0.1), 0.04)
    jsd = sc.data()
    return jsd, scene_from_jax(jsd, device="cpu")


def _rays(seed, n=N):
    """Rays from a box around the scene aimed at random points inside it."""
    rng = np.random.RandomState(seed)
    o = rng.uniform(-1.5, 2.2, (n, 3)).astype(np.float32)
    tgt = rng.uniform(-0.4, 1.3, (n, 3)).astype(np.float32)
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d.astype(np.float32)


def _np(h):
    return {f: np.asarray(getattr(h, f)) for f in h._fields}


def _compare(ref, out):
    ref, out = _np(ref), _np(out)
    hr, ho = ref["t"] < 1e30, out["t"] < 1e30
    np.testing.assert_array_equal(ho, hr)
    np.testing.assert_allclose(out["t"][hr], ref["t"][hr], atol=ATOL, rtol=0)
    for f in ("mat", "obj", "steps"):
        np.testing.assert_array_equal(out[f], ref[f], err_msg=f)
    prim = ref["obj"] == -2
    for f in ("normal", "albedo"):       # one sphere's albedo is its normal
        np.testing.assert_allclose(out[f][~prim], ref[f][~prim], atol=ATOL, rtol=0,
                                   err_msg=f)
        np.testing.assert_allclose(out[f][prim], ref[f][prim], atol=PRIM_NORMAL_ATOL,
                                   rtol=0, err_msg=f)
    return hr


@pytest.fixture(scope="module")
def primary(scenes):
    jsd, sd = scenes
    o, d = _rays(1)
    ref = jcomp.intersect_scene(jsd, jnp.asarray(o), jnp.asarray(d), max_candidates=2)
    out = composite.intersect_scene(sd, torch.from_numpy(o), torch.from_numpy(d),
                                    max_candidates=2)
    return o, d, ref, out


def test_intersect_scene(primary):
    _o, _d, ref, out = primary
    hit = _compare(ref, out)
    obj = out.obj.numpy()
    # every volume, the prims (-2) and misses are represented
    assert {0, 1, 2, 3, -2, -1} <= set(obj.tolist())
    assert hit.sum() > N // 4


def test_intersect_scene_ignore_and_shadow(scenes):
    jsd, sd = scenes
    o, d = _rays(2)
    rng = np.random.RandomState(4)
    ignore = np.where(rng.rand(N) < 0.5, 3, 0).astype(np.int32)
    seed = rng.randint(0, 2 ** 32, N, dtype=np.uint64)
    ref = jcomp.intersect_scene(jsd, jnp.asarray(o), jnp.asarray(d), 2,
                                ignore=jnp.asarray(ignore))
    out = composite.intersect_scene(sd, torch.from_numpy(o), torch.from_numpy(d), 2,
                                    ignore=torch.from_numpy(ignore))
    _compare(ref, out)
    occ_r, ref = jcomp.is_occluded(jsd, jnp.asarray(o), jnp.asarray(d), 1.5, 2,
                                   shadow_seed=jnp.asarray(seed.astype(np.uint32)))
    occ_o, out = composite.is_occluded(sd, torch.from_numpy(o), torch.from_numpy(d),
                                       1.5, 2, shadow_seed=torch.from_numpy(
                                           seed.astype(np.int64)))
    _compare(ref, out)
    np.testing.assert_array_equal(occ_o.numpy(), np.asarray(occ_r))
    occ_r, _ = jcomp.is_occluded(jsd, jnp.asarray(o), jnp.asarray(d), 1.5, 2)
    occ_o, _ = composite.is_occluded(sd, torch.from_numpy(o), torch.from_numpy(d), 1.5, 2)
    np.testing.assert_array_equal(occ_o.numpy(), np.asarray(occ_r))
    assert 0 < int(occ_o.sum()) < N


def test_march_interior(scenes, primary):
    """Rays refracted into the glass they hit march to its exit."""
    jsd, sd = scenes
    o, d, ref_hit, out_hit = primary
    t = np.asarray(ref_hit.t)
    mat = np.asarray(ref_hit.mat)
    glass = (t < 1e30) & (mat >= 1) & (mat <= 8)
    assert glass.sum() > 50
    p = (o + d * np.where(glass, t, 0.0)[:, None] + d * 1e-3).astype(np.float32)
    medium = np.where(glass, mat, 0).astype(np.int32)
    obj = np.asarray(ref_hit.obj)
    ref = jcomp.march_interior(jsd, jnp.asarray(obj), jnp.asarray(p), jnp.asarray(d),
                               jnp.asarray(medium))
    out = composite.march_interior(sd, out_hit.obj, torch.from_numpy(p),
                                   torch.from_numpy(d), torch.from_numpy(medium))
    hit = _compare(ref, out)
    assert hit[glass].all()


def test_intersect_prims(scenes):
    jsd, sd = scenes
    o, d = _rays(5)
    ref = jprims.intersect_prims(jsd.prims, jnp.asarray(o), jnp.asarray(d))
    out = prims.intersect_prims(sd.prims, torch.from_numpy(o), torch.from_numpy(d))
    hit = np.asarray(ref[0]) < 1e30
    assert 10 < hit.sum() < N
    np.testing.assert_array_equal(out[0].numpy() < 1e30, hit)
    np.testing.assert_allclose(out[0].numpy()[hit], np.asarray(ref[0])[hit],
                               atol=ATOL, rtol=0)
    np.testing.assert_array_equal(out[1].numpy(), np.asarray(ref[1]))
    for k in (2, 3):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   atol=PRIM_NORMAL_ATOL, rtol=0)
    assert prims.intersect_prims(prims.PrimsData.empty("cpu"), torch.from_numpy(o),
                                 torch.from_numpy(d)) is None


@pytest.mark.parametrize("frac", [0.0, 0.03, 0.5, 1.0])
def test_masked_apply_equals_uncompacted(scenes, frac):
    """The stage on the gathered live rows, scattered back, equals the
    stage on every row, masked; idx is each row's original index."""
    _jsd, sd = scenes
    o, d = (torch.from_numpy(x) for x in _rays(6, 2048))
    mask = torch.from_numpy(np.random.RandomState(7).rand(2048) < frac)

    def stage(lv, idx, o_g, d_g):
        h = composite.intersect_scene(sd, o_g, d_g, 2)
        return h.t, h.normal * idx.to(torch.float32)[:, None], h.mat + idx

    fill = (torch.full((2048,), -1.0), torch.zeros((2048, 3)),
            torch.full((2048,), -5, dtype=torch.int32))
    out = masked_apply(mask, stage, (o, d), fill, bucket_caps(2048))
    full = stage(torch.ones(2048, dtype=torch.bool), torch.arange(2048), o, d)
    for got, want, f in zip(out, full, fill):
        m = mask.reshape((-1,) + (1,) * (want.ndim - 1))
        assert torch.equal(got, torch.where(m, want.to(got.dtype), f))
    caps = bucket_caps(2048, (1 / 16, 1 / 4))
    assert caps == (1024, 2048)
    idx = live_indices(mask, caps[-1])
    nz = torch.nonzero(mask).reshape(-1)
    assert torch.equal(idx[:nz.numel()].long(), nz)
    assert bool((idx[nz.numel():] == 2048).all())
