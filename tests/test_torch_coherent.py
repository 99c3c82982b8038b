"""Parity: the port's coherent-kernel tracer (`ops/cuda/coherent.py`, B5)
vs the JAX package, on CPU.

On CPU tensors `trace_coherent` runs its plain PyTorch version; the JAX
side runs the Pallas kernel in interpret mode, as
tests/test_coherent_kernel.py does, on that file's five scenes (built in
code).

Tolerances, each against the JAX function named in the test:
- `coherent.trace_coherent(interpret=True)`, on the rays it resolved: hit
  mask, vox and ax equal, t within 1e-5 (observed: t bit-equal, because
  the port fuses the same multiply-adds XLA's CPU backend fuses under
  `jit`).  `steps` is not compared: the Pallas count depends on its tile's
  rect order and pruning (ROADMAP C).
- `oracle.intersect_volume`, on every ray (the port resolves all): the
  budget of tests/test_coherent_kernel.py, at most max(1, n // 200) rays
  with a different hit, t off by more than atol 2e-3 + rtol 1e-4, or
  another material.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from voxel_tracer_tpu.models.camera import Camera as JCamera
from voxel_tracer_tpu.models.camera import rays_for_image
from voxel_tracer_tpu.models.volume import VoxelVolume as JVolume
from voxel_tracer_tpu.ops import oracle
from voxel_tracer_tpu.ops.pallas import coherent as jcoh

from voxel_tracer_tpu_torch.ops.cuda import coherent
from voxel_tracer_tpu_torch.utils import profiling

torch.set_num_threads(1)

W, H = 64, 32


def _sphere(n=16, r=0.4, mat=5):
    z, y, x = np.meshgrid(*[np.arange(n)] * 3, indexing="ij")
    c = (n - 1) / 2
    return np.where(
        np.sqrt((x - c) ** 2 + (y - c) ** 2 + (z - c) ** 2) < r * n, mat, 0
    ).astype(np.uint8)


# tests/test_coherent_kernel.py's scenes: volume, camera position (target 0)
SCENES = {
    "sphere_front": (lambda: JVolume(_sphere(), vpu=20.0), (0.21, 0.17, -2.1)),
    "oblique": (lambda: JVolume(_sphere(24, 0.45, 9), vpu=20.0), (1.3, 0.9, -1.4)),
    "noise": (lambda: JVolume.noise_filled((32, 32, 32)), (-1.1, 1.2, -1.9)),
    "negative_major_axis": (lambda: JVolume(_sphere(), vpu=20.0), (0.08, -0.13, 2.2)),
    "x_major_axis": (lambda: JVolume(_sphere(), vpu=20.0), (-2.2, 0.1, 0.14)),
}


def _jax_trace(vol, o_l, d, pad_with_first=False):
    """The Pallas kernel in interpret mode on rays padded to whole tiles
    (with rays at 0 along +z, or with copies of the first ray)."""
    n = o_l.shape[0]
    pad = (-n) % jcoh.TILE
    if pad_with_first:
        o_p, d_p = (np.concatenate([x, np.repeat(x[:1], pad, 0)]) for x in (o_l, d))
    else:
        o_p = np.concatenate([o_l, np.zeros((pad, 3), np.float32)])
        d_p = np.concatenate([d, np.tile(np.float32([[0, 0, 1]]), (pad, 1))])
    pk = jcoh.pack_volume(vol.grid, vol.vpu)
    res = jcoh.trace_coherent(pk.occ, pk.words, jnp.asarray(o_p), jnp.asarray(d_p),
                              pk.bsize, pk.vpu, interpret=True)
    return {k: np.asarray(v)[:n] for k, v in res.items()}


def _port_trace(vol, o_l, d):
    pv = coherent.pack_volume(vol.grid, vol.vpu, device="cpu")
    out = coherent.trace_coherent(pv.occ, pv.words, torch.from_numpy(o_l),
                                  torch.from_numpy(d), pv.bsize, pv.vpu)
    return {k: v.numpy() for k, v in out.items()}


def _camera_rays(vol, campos):
    cam = JCamera.create(campos, (0.0, 0.0, 0.0), W / H)
    o, d = (np.array(x, np.float32) for x in rays_for_image(cam, W, H))
    o_l = (o + np.asarray(vol.pivot) - np.asarray(vol.pos)).astype(np.float32)
    return o, d, o_l


@pytest.mark.parametrize("grid", [(16, 16, 16), (24, 20, 12), (32, 32, 32)])
def test_pack_volume_matches_jax(grid):
    rng = np.random.RandomState(sum(grid))
    g = np.where(rng.rand(*grid) < 0.3, rng.randint(1, 256, grid), 0).astype(np.uint8)
    ref = jcoh.pack_volume(g, 20.0)
    pv = coherent.pack_volume(g, 20.0, device="cpu")
    assert pv.bsize == ref.bsize and pv.vpu == ref.vpu
    np.testing.assert_array_equal(pv.occ.numpy(), np.asarray(ref.occ)[0])
    np.testing.assert_array_equal(pv.words.numpy(), np.asarray(ref.words).T)


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_trace_coherent_matches_pallas_and_oracle(scene):
    make, campos = SCENES[scene]
    vol = make()
    o, d, o_l = _camera_rays(vol, campos)
    ref = _jax_trace(vol, o_l, d)
    out = _port_trace(vol, o_l, d)
    assert out["resolved"].all()

    res = ref["resolved"]
    assert res.mean() >= 0.8
    hr, ho = ref["t"] < 1e30, out["t"] < 1e30
    np.testing.assert_array_equal(ho[res], hr[res])
    both = res & hr
    assert both.sum() > 50
    np.testing.assert_allclose(out["t"][both], ref["t"][both], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(out["vox"][res], ref["vox"][res])
    np.testing.assert_array_equal(out["ax"][res], ref["ax"][res])

    ov = oracle.OracleVolume(grid=vol.grid, vpu=vol.vpu, pos=vol.pos)
    bx, by, _ = coherent.pack_volume(vol.grid, vol.vpu, device="cpu").bsize
    bad = 0
    for i in range(o.shape[0]):
        hh = oracle.intersect_volume(ov, o[i], d[i])
        if hh.no_hit != (not ho[i]):
            bad += 1
        elif not hh.no_hit:
            v = out["vox"][i]
            vz, vy, vx = v // (bx * 8 * by * 8), (v // (bx * 8)) % (by * 8), v % (bx * 8)
            if not (np.isclose(out["t"][i], hh.depth, atol=2e-3, rtol=1e-4)
                    and vol.grid[vz, vy, vx] == hh.material):
                bad += 1
    assert bad <= max(1, o.shape[0] // 200), f"{bad} rays disagree with the oracle"


def test_miss_encoding_and_any_ray_count():
    """Misses: t = BIG, vox = -1, ax = entry_axis * 4 (the Pallas
    placeholder, not * 2); a ray that starts near 1e30 (a missed pixel's
    shadow ray) misses at once.  N need not be a multiple of 1024."""
    vol = JVolume(_sphere(), vpu=20.0)          # local box [0, 0.8]^3
    e = 0.02                                    # corner strip, no voxels
    o_l = np.float32([
        [-1.0, e, e], [e, -1.0, e], [e, e, -1.0],     # enter x, y, z faces
        [0.9, e, e], [e, 1.7, e], [e, e, 0.81],       # enter the far faces
        [-1.0, 2.0, 0.4],                             # misses the box
        [1e30, 1e30, 1e30],                           # far origin
        [-1.0, 0.41, 0.39],                           # hits the sphere
    ])
    d = np.float32([
        [1, 0, 0], [0, 1, 0], [0, 0, 1],
        [-1, 0, 0], [0, -1, 0], [0, 0, -1],
        [1, 0, 0], [0.6, 0.48, 0.64], [1, 0, 0],
    ])
    out = _port_trace(vol, o_l, d)
    # one Pallas tile per ray, so that no ray fights its tile's major axis
    ref = _jax_trace(vol, np.repeat(o_l, jcoh.TILE, 0), np.repeat(d, jcoh.TILE, 0))
    ref = {k: v[::jcoh.TILE] for k, v in ref.items()}
    assert ref["resolved"].all()
    for k in ("vox", "ax"):
        np.testing.assert_array_equal(out[k], ref[k])
    np.testing.assert_array_equal(out["t"][:8], np.float32(coherent.BIG))
    np.testing.assert_array_equal(out["vox"][:8], -1)
    np.testing.assert_array_equal(out["ax"][:8], [0, 4, 8, 0, 4, 8, 0, 0])
    np.testing.assert_array_equal(out["steps"][6:8], 0)
    assert out["vox"][8] >= 0 and out["ax"][8] == 1
    np.testing.assert_allclose(out["t"][8], ref["t"][8], atol=1e-5, rtol=0)


def _on_voxel_plane(o, d, vpu):
    """Rays that run inside a voxel plane: a zero direction component whose
    origin coordinate is a whole number of voxels."""
    v = o * np.float32(vpu)
    return ((d == 0) & (v == np.round(v))).any(axis=1)


# Rays whose first solid voxel is a tie: inside a voxel plane (they touch
# the voxels on both sides), through brick corners (every voxel meeting
# there), from a voxel's corner; and rays toward the volume from 1e30,
# whose entry point carries an error of ~1e23 voxels.  Each traversal
# breaks such ties its own way.
AMBIGUOUS_GROUPS = ("corner", "solid_corner", "far_toward")


@pytest.mark.parametrize("grid", ["sphere", "noise64"])
def test_edge_rays_match_pallas_and_oracle(grid):
    """`profiling.edge_rays` through the port (plain version) against the
    Pallas kernel in interpret mode (each group of one major axis and
    sign padded to whole tiles, so no ray fights its tile) and the scalar
    oracle.  Every ray resolves.  Rays without a tie: the same hits, vox
    and ax as the Pallas kernel and t within 1e-5, and within the oracle
    test's tolerances, with no budget.  Rays with a tie (in a voxel plane,
    `AMBIGUOUS_GROUPS`): each hit lies on a solid voxel, and, but for the
    rays from 1e30, within 1e-4 of that voxel's box at t."""
    vol = (JVolume(_sphere(), vpu=20.0) if grid == "sphere"
           else JVolume.noise_filled((64, 64, 64), pos=(0, 0, 0), vpu=20.0))
    o_l, d = profiling.edge_rays(vol.grid, vol.vpu)
    n = o_l.shape[0]
    out = _port_trace(vol, o_l, d)
    assert out["resolved"].all()

    major = np.abs(d).argmax(axis=1)
    group = major * 2 + (d[np.arange(n), major] < 0)
    ref = {}
    for g in np.unique(group):
        ids = np.nonzero(group == g)[0]
        r = _jax_trace(vol, o_l[ids], d[ids], pad_with_first=True)
        for k, v in r.items():
            ref.setdefault(k, np.zeros(n, v.dtype))[ids] = v
    ambiguous = _on_voxel_plane(o_l, d, vol.vpu)
    for name in AMBIGUOUS_GROUPS:
        ambiguous[profiling.EDGE_RAY_GROUPS[name]] = True
    exact = ref["resolved"] & ~ambiguous
    assert exact.sum() >= n // 2
    hr, ho = ref["t"] < 1e30, out["t"] < 1e30
    np.testing.assert_array_equal(ho[exact], hr[exact])
    both = exact & hr
    np.testing.assert_allclose(out["t"][both], ref["t"][both], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(out["vox"][exact], ref["vox"][exact])
    np.testing.assert_array_equal(out["ax"][exact], ref["ax"][exact])

    ov = oracle.OracleVolume(grid=vol.grid, vpu=vol.vpu, pos=vol.pos)
    o_w = (o_l - np.asarray(vol.pivot) + np.asarray(vol.pos)).astype(np.float32)
    bsize = coherent.pack_volume(vol.grid, vol.vpu, device="cpu").bsize
    pad = np.zeros([b * 8 for b in bsize[::-1]], np.uint8)
    pad[tuple(slice(0, s) for s in vol.grid.shape)] = vol.grid
    zyx = np.stack(np.unravel_index(np.maximum(out["vox"], 0), pad.shape), axis=1)
    far = np.zeros(n, bool)
    far[profiling.EDGE_RAY_GROUPS["far_toward"]] = True
    bad = []
    for i in range(n):
        mat = pad[tuple(zyx[i])]
        if ambiguous[i]:
            if ho[i]:
                lo = zyx[i, ::-1] / np.float32(vol.vpu)
                p = o_l[i].astype(np.float64) + out["t"][i] * d[i].astype(np.float64)
                off_box = np.abs(p - np.clip(p, lo, lo + 1.0 / vol.vpu)).max()
                if mat == 0 or (not far[i] and off_box > 1e-4):
                    bad.append((i, "ambiguous", mat, off_box))
            continue
        hh = oracle.intersect_volume(ov, o_w[i], d[i])
        if hh.no_hit != (not ho[i]):
            bad.append((i, "hit", hh.no_hit))
        elif not hh.no_hit and not (np.isclose(out["t"][i], hh.depth, atol=2e-3, rtol=1e-4)
                                    and mat == hh.material):
            bad.append((i, "t or material", out["t"][i], hh.depth))
    assert not bad, bad


def test_brick_bits_and_launch_args():
    """The bitmap that `pack_volume` keeps with its launch arguments on occ
    holds occ's flags (bit b % 32 of word b // 32, zero-padded to a
    multiple of 4 words); the launch arguments are reused, and rebuilt
    after an in-place edit of occ or for another words tensor; malformed
    tables raise."""
    rng = np.random.RandomState(5)
    g = np.where(rng.rand(40, 24, 72) < 0.002, 7, 0).astype(np.uint8)
    pv = coherent.pack_volume(g, 20.0, device="cpu")
    nb = pv.occ.numel()

    def flags(bits):
        w = bits.numpy().view(np.uint32)
        assert w.size % 4 == 0 and (w.size - 4) * 32 < nb <= w.size * 32
        b = np.arange(w.size * 32)
        return (w[b >> 5] >> (b & 31)) & 1

    dev = pv.occ.device
    la = coherent._launch_args(pv.occ, pv.words, pv.bsize, pv.vpu, dev)
    assert la is pv.occ._vt_coherent            # built by pack_volume
    f = flags(la.bits)
    np.testing.assert_array_equal(f[:nb], pv.occ.numpy() != 0)
    assert not f[nb:].any() and 0 < f.sum() < nb
    assert coherent._launch_args(pv.occ, pv.words, pv.bsize, pv.vpu, dev) is la
    b = int(pv.occ.nonzero()[0, 0])
    pv.occ[b] = 0
    la2 = coherent._launch_args(pv.occ, pv.words, pv.bsize, pv.vpu, dev)
    assert la2 is not la and flags(la2.bits)[b] == 0
    assert coherent._launch_args(pv.occ, pv.words.clone(), pv.bsize, pv.vpu, dev) is not la2
    with pytest.raises(ValueError):
        coherent._launch_args(pv.occ, pv.words[:-1], pv.bsize, pv.vpu, dev)
    with pytest.raises(TypeError):
        coherent._launch_args(pv.occ.long(), pv.words, pv.bsize, pv.vpu, dev)
