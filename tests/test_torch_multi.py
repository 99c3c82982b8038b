"""Parity: the port's multi-volume backend (`ops/cuda/multi.py`) and the
O(1) table edits of `ops/cuda/mega.py` / `ops/cuda/whitted.py`, on the CPU.

On CPU tensors every trace of `MultiMegaIntersector` runs B2's plain
version (`mega.trace_rays_plain`), the float32 program the kernel runs on
the card.  The scene is tests/test_multi.py's `_dyn_scene`: a floor volume
and a 12^3 cube rotated 0.35 rad about y (a glass variant of the cube for
the interior march and the stochastic shadows).  The JAX side is its XLA
wavefront (`composite`, `render_rays`), never its kernels in interpret
mode.  Tolerances:
- against the JAX wavefront: hit agreement > 0.99 and depth rtol 1e-3 /
  atol 2e-3 where both hit (tests/test_multi.py; the whole frame is in
  tests/test_torch_multi_frame.py);
- against the port's own wavefront (`ops/composite.py`): equal hit masks
  and objects, depth within 1e-5 (both run `ops/dda.py`'s float program on
  the same local rays; the interior march's grid exit is placed
  analytically, as tests/test_torch_whitted.py allows); a stochastic
  shadow walk's occluder within 1e-5 + 1e-3 / vpu (each transmitted voxel
  restarts the walk 1e-3 / vpu past its far face);
- the O(1) edits: every table equal to `pack_tables` of the edited grid.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from voxel_tracer_tpu.models.camera import Camera as JCamera
from voxel_tracer_tpu.models.camera import rays_for_image as jrays_for_image
from voxel_tracer_tpu.models.scene import Scene as JScene
from voxel_tracer_tpu.models.skydome import SkyDome as JSkyDome
from voxel_tracer_tpu.models.volume import VoxelVolume as JVolume
from voxel_tracer_tpu.ops import composite as jcomp

from voxel_tracer_tpu_torch.convert import scene_from_jax, volume_from_jax
from voxel_tracer_tpu_torch.models.volume import VoxelVolume
from voxel_tracer_tpu_torch.models.vox import vox_bytes
from voxel_tracer_tpu_torch.ops import composite
from voxel_tracer_tpu_torch.ops.cuda import mega, multi
from voxel_tracer_tpu_torch.ops.cuda.whitted import MegaIntersector

torch.set_num_threads(1)

W, H = 64, 48
BIG = 1e29
DEPTH_RTOL, DEPTH_ATOL = 1e-3, 2e-3
PORT_DEPTH_ATOL = 1e-5


def _rot_y(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)


def _dyn_scene(angle=0.35, glass=False):
    """test_multi.py's diffuse floor + rotated cube with a mirror core;
    ``glass`` makes the cube's shell glass (id 3)."""
    pal = np.random.RandomState(3).rand(256, 3).astype(np.float32) * 0.8 + 0.1
    floor = np.zeros((8, 8, 32), np.uint8)
    floor[:, 0:2, :] = 30
    cube = np.zeros((12, 12, 12), np.uint8)
    cube[2:10, 2:10, 2:10] = 3 if glass else 40
    cube[4:8, 4:8, 4:8] = 12
    vols = [JVolume(floor, palette=pal, pos=(0.0, 0.0, 0.0), vpu=20.0),
            JVolume(cube, palette=pal, pos=(0.8, 0.45, 0.2), vpu=20.0, rot=_rot_y(angle))]
    scene = JScene(volumes=vols, skydome=JSkyDome.procedural(32, 16))
    scene.add_light((0.5, 1.2, -0.6), 0.08, (1.0, 0.9, 0.8), 6.0)
    return vols, scene


def _multi(jvols, compact=False, **kw):
    return multi.MultiMegaIntersector(
        [MegaIntersector(mega.MegaVolume(volume_from_jax(v), device="cpu"),
                         shadow_rounds=4, compact=compact, **kw) for v in jvols])


def _t(a):
    return torch.from_numpy(np.array(a))


def _camera():
    return JCamera.create((1.0, 0.8, -1.2), (0.6, 0.3, 0.2), W / H)


def _check_vs_jax(t_port, t_jax, min_hit=0.2):
    """Hit agreement and depth against the JAX wavefront (test_multi.py)."""
    tp, tj = np.asarray(t_port).ravel(), np.asarray(t_jax).ravel()
    hp, hj = tp < BIG, tj < BIG
    assert hj.mean() > min_hit, "the rays missed the scene"
    assert (hp == hj).mean() > 0.99, f"hit agreement {(hp == hj).mean():.4f}"
    np.testing.assert_allclose(tp[hp & hj], tj[hp & hj], rtol=DEPTH_RTOL, atol=DEPTH_ATOL)


def _check_vs_port(h, r):
    """Against the port's wavefront composite: the same float program."""
    hk, hr = h.t < BIG, r.t < BIG
    assert torch.equal(hk, hr)
    assert float((h.t[hk] - r.t[hk]).abs().max()) <= PORT_DEPTH_ATOL
    assert torch.equal(h.obj[hk], r.obj[hk]) and torch.equal(h.mat[hk], r.mat[hk])
    assert torch.allclose(h.normal[hk], r.normal[hk], atol=1e-5)


@pytest.fixture(scope="module")
def dyn():
    jvols, scene = _dyn_scene()
    jsd = scene.data()
    o, d = jrays_for_image(_camera(), W, H)
    sd = scene_from_jax(jsd, device="cpu")
    return dict(jvols=jvols, jsd=jsd, sd=sd, jo=o, jd=d, o=_t(o), d=_t(d),
                jref=jcomp.intersect_scene(jsd, o, d),
                ref=composite.intersect_scene(sd, _t(o), _t(d)))


@pytest.fixture(scope="module")
def glass():
    jvols, scene = _dyn_scene(glass=True)
    jsd = scene.data()
    o, d = jrays_for_image(JCamera.create((1.2, 0.9, -0.9), (0.8, 0.45, 0.2), 1.0), 32, 32)
    return dict(jvols=jvols, jsd=jsd, sd=scene_from_jax(jsd, device="cpu"), jo=o, jd=d,
                o=_t(o), d=_t(d))


@pytest.mark.parametrize("compact", [True, False])
def test_intersect_scene_matches_wavefronts(dyn, compact):
    m = _multi(dyn["jvols"], compact)
    h = m.intersect_scene(dyn["sd"], dyn["o"], dyn["d"])
    ref = dyn["jref"]
    _check_vs_jax(h.t, ref.t)
    hit = np.asarray(ref.t) < BIG
    assert set(np.unique(np.asarray(ref.obj)[hit])) == {0, 1}      # both volumes in view
    _check_vs_port(h, dyn["ref"])


def test_march_interior_is_routed_by_obj(glass):
    """Rays entering the glass cube march its interior only: the entered
    volume's obj routes them; rows naming the floor (no glass) stay a miss
    with obj -1."""
    sd, o, d = glass["sd"], glass["o"], glass["d"]
    m = _multi(glass["jvols"])
    first = m.intersect_scene(sd, o, d)
    inside = (first.obj == 1) & (first.mat == 3)
    assert int(inside.sum()) > 30
    p = o + d * torch.where(first.t < BIG, first.t, 0.0)[:, None] - first.normal * 1e-4
    medium = torch.where(inside, first.mat, 0)
    h = m.march_interior(sd, first.obj, p, d, medium)
    ref = jcomp.march_interior(glass["jsd"], jnp.asarray(first.obj.numpy()),
                               jnp.asarray(p.numpy()), glass["jd"],
                               jnp.asarray(medium.numpy()))
    sel = inside.numpy()
    _check_vs_jax(h.t.numpy()[sel], np.asarray(ref.t)[sel], min_hit=0.99)
    assert np.array_equal(h.mat.numpy()[sel], np.asarray(ref.mat)[sel])
    assert torch.equal(h.obj[inside], first.obj[inside])
    floor = first.obj == 0
    assert bool((h.obj[floor] == -1).all()) and bool((h.t[floor] >= BIG).all())
    r = composite.march_interior(sd, first.obj, p, d, medium)
    assert float((h.t[inside] - r.t[inside]).abs().max()) <= PORT_DEPTH_ATOL
    assert torch.equal(h.mat[inside], r.mat[inside])


def test_stochastic_shadows_match_wavefronts(glass):
    """Shadow rays toward the sun from the frame's hit points, per-ray
    seeds: each volume walks its own stochastic rounds (continued on the
    DDA's shadow mode past shadow_rounds), nearest-combined."""
    sd, o, d = glass["sd"], glass["o"], glass["d"]
    m = _multi(glass["jvols"], exact_fallback=True)
    first = m.intersect_scene(sd, o, d)
    hit = first.t < BIG
    p = o + d * torch.where(hit, first.t, 0.0)[:, None] + first.normal * 1e-4
    p = torch.where(hit[:, None], p, 1e6)
    sun = torch.broadcast_to(sd.sun_dir, p.shape)
    seed = torch.arange(p.shape[0], dtype=torch.int64) * 7919 + 13
    occ, h = m.is_occluded(sd, p, sun, 1e30, shadow_seed=seed)
    jocc, jh = jcomp.is_occluded(glass["jsd"], jnp.asarray(p.numpy()),
                                 jnp.asarray(sun.numpy()), 1e30,
                                 shadow_seed=jnp.asarray(seed.numpy().astype(np.uint32)))
    assert (occ.numpy() == np.asarray(jocc)).mean() > 0.99
    _check_vs_jax(h.t, jh.t, min_hit=0.01)
    r_occ, r = composite.is_occluded(sd, p, sun, 1e30, shadow_seed=seed)
    assert torch.equal(occ, r_occ)
    assert torch.equal(h.obj, r.obj) and torch.equal(h.mat, r.mat)
    # a round that transmits through a voxel restarts 1e-3 / vpu past its
    # far face (whitted.py `_shadow_rounds`); an occluder adjoining it is
    # entered at that point, so t reads up to that offset long
    hk = h.t < BIG
    assert float((h.t[hk] - r.t[hk]).abs().max()) <= PORT_DEPTH_ATOL + 1e-3 / 20.0


def test_with_transforms_moves_the_volume(dyn):
    """A moved and rotated cube matches the JAX wavefront at its new pose;
    the intersector it was made from keeps the old pose."""
    rot, pos = _rot_y(0.9), np.array([0.85, 0.5, 0.25], np.float32)
    m = _multi(dyn["jvols"])
    moved = m.with_transforms([None, (rot, pos)])
    t1 = moved.intersect_scene(dyn["sd"], dyn["o"], dyn["d"]).t
    t0 = m.intersect_scene(dyn["sd"], dyn["o"], dyn["d"]).t
    assert int(((t0 < BIG) != (t1 < BIG)).sum() + ((t0 - t1).abs() > 1e-4).sum()) > 10
    jvols, scene = _dyn_scene()
    jvols[1].set_rotation(rot)
    jvols[1].set_position(pos)
    ref = jcomp.intersect_scene(scene.data(), dyn["jo"], dyn["jd"])
    _check_vs_jax(t1, ref.t)
    assert bool((t0 == m.intersect_scene(dyn["sd"], dyn["o"], dyn["d"]).t).all())


def _edit_volume():
    """36x28x20 voxels (60 bricks, so brick and bit index 31 occur): glass
    id 4 around a diffuse core, a mirror slab, an empty corner."""
    g = np.zeros((20, 28, 36), np.uint8)
    g[2:18, 3:20, 4:30] = 4
    g[5:9, 5:9, 5:9] = 40
    g[8:16, 20:24, 0:8] = 12
    return VoxelVolume(g, palette=np.random.RandomState(5).rand(256, 3).astype(np.float32),
                       vpu=20.0)


def _assert_tables_equal(a, b, tag):
    for f in ("bocc", "bitmap", "occw", "matb", "grid", "brick_occ", "pal"):
        assert torch.equal(getattr(a, f), getattr(b, f)), (tag, f)


def test_set_voxel_edits_tables_in_place():
    """Seeded random edits (glass, diffuse, mirror, air, a new glass id),
    a brick carved empty and an empty brick filled: the intersector's
    tables equal a fresh pack of the edited grid, and a table state taken
    before the edits sees them."""
    vol = _edit_volume()
    isect = MegaIntersector(mega.MegaVolume(vol, device="cpu"))
    state = isect.table_state()
    tensors = [state[0].occw, state[0].matb, state[0].bitmap, state[2], state[3]]
    rng = np.random.RandomState(11)
    for _ in range(200):
        x, y, z = rng.randint(36), rng.randint(28), rng.randint(20)
        isect.set_voxel(x, y, z, int(rng.choice([0, 4, 40, 12, 3])))
    for z in range(8, 16):                       # carve brick (bx, by, bz) = (0, 2, 1)
        for y in range(16, 24):
            for x in range(0, 8):
                isect.set_voxel(x, y, z, 0)
    for z in range(0, 8):                        # fill brick (4, 3, 0): empty before
        for y in range(24, 28):
            for x in range(32, 36):
                isect.set_voxel(x, y, z, 41)
    fresh = MegaIntersector(mega.MegaVolume(VoxelVolume(vol.grid.copy(), vol.palette),
                                            device="cpu"))
    assert isect.glass_ids == fresh.glass_ids == [3, 4]
    _assert_tables_equal(isect.full_tables, fresh.full_tables, "full")
    for g in fresh.glass_ids:
        _assert_tables_equal(isect.inv_tables[g], fresh.inv_tables[g], g)
    assert torch.equal(isect.grid_dda, fresh.grid_dda)
    assert torch.equal(isect.brick_occ, fresh.brick_occ)
    np.testing.assert_array_equal(vol.brick_occ, fresh.mv.volume.brick_occ)
    after = isect.table_state()
    for t_before, t_after in zip(tensors, [after[0].occw, after[0].matb, after[0].bitmap,
                                          after[2], after[3]]):
        assert t_before is t_after
    assert int(fresh.full_tables.bocc[(1 * 4 + 2) * 5 + 0]) == 0
    assert int(fresh.full_tables.bocc[(0 * 4 + 3) * 5 + 4]) == 1


@pytest.mark.parametrize("occupied", [None, "inverted"])
def test_set_voxel_tables_sign_bits(occupied):
    """The word bit 31 (voxel index i % 32 == 31) and the bitmap bit 31
    (brick 31) are the int32 sign: set, cleared and set again."""
    g = np.zeros((24, 32, 48), np.uint8)                 # 6 x 4 x 3 = 72 bricks
    g[0, 0, 0] = 4
    tb = mega.pack_tables(g, np.ones((256, 3), np.float32), 20.0, "cpu",
                          occupied=None if occupied is None else g != 4)
    # brick 31 = (bx, by, bz) = (1, 1, 1); voxel index 31 = (x, y, z) = (7, 3, 0)
    x, y, z = 8 + 7, 8 + 3, 8
    for val in (40, 0, 4, 12):
        g[z, y, x] = val
        occ = None if occupied is None else val != 4
        mega.set_voxel_tables(tb, x, y, z, val, occupied=occ)
        ref = mega.pack_tables(g, np.ones((256, 3), np.float32), 20.0, "cpu",
                               occupied=None if occupied is None else g != 4)
        _assert_tables_equal(tb, ref, val)


def test_mega_volume_set_voxel():
    """`MegaVolume.set_voxel` edits the host volume and its tables in
    place: equal to a repack of the edited grid."""
    vol = _edit_volume()
    mv = mega.MegaVolume(vol, device="cpu")
    rng = np.random.RandomState(12)
    for _ in range(100):
        mv.set_voxel(rng.randint(36), rng.randint(28), rng.randint(20),
                     int(rng.choice([0, 4, 40])))
    _assert_tables_equal(mv.tables, mega.pack_tables(vol.grid, vol.palette, vol.vpu, "cpu"),
                         "MegaVolume")
    np.testing.assert_array_equal(vol.brick_occ, VoxelVolume(vol.grid.copy()).brick_occ)


def test_edited_volume_traces_like_a_fresh_one(dyn):
    """After carving a voxel of the cube, the multi-volume hit equals a
    fresh intersector's and the port's wavefront on the edited grid."""
    vols = [volume_from_jax(v) for v in dyn["jvols"]]
    isects = [MegaIntersector(mega.MegaVolume(v, device="cpu")) for v in vols]
    m = multi.MultiMegaIntersector(isects)
    hit = m.intersect_scene(dyn["sd"], dyn["o"], dyn["d"])
    cube = hit.obj == 1
    for px in torch.nonzero(cube).reshape(-1)[::7].tolist():
        p = (dyn["o"][px] + dyn["d"][px] * hit.t[px] - hit.normal[px] * 1e-3).numpy()
        x, y, z = vols[1].to_grid(p)
        isects[1].set_voxel(int(x), int(y), int(z), 0)
    carved = m.intersect_scene(dyn["sd"], dyn["o"], dyn["d"])
    fresh = multi.MultiMegaIntersector(
        [MegaIntersector(mega.MegaVolume(VoxelVolume(v.grid.copy(), v.palette, v.pos, v.rot),
                                         device="cpu")) for v in vols])
    ref = fresh.intersect_scene(dyn["sd"], dyn["o"], dyn["d"])
    assert int((carved.t != hit.t).sum()) > 5
    for f in ref._fields:
        assert torch.equal(getattr(carved, f), getattr(ref, f)), f


def test_make_drone_scene_stand_ins_and_assets(tmp_path, monkeypatch):
    """Without assets: the procedural box (ids 16 -> 4, 62 -> 12) and four
    16^3 drones at (i, 2, 0); with a directory holding the two .vox files
    (here written in code) it reads them, as VOXEL_TRACER_ASSET_DIR does."""
    monkeypatch.delenv("VOXEL_TRACER_ASSET_DIR", raising=False)
    vols, scene = multi.make_drone_scene()
    assert len(vols) == 5 and len(scene.volumes) == 5 and len(scene.lights) == 1
    ids = set(np.unique(vols[0].grid).tolist())
    assert {4, 12} <= ids and not {16, 62} & ids
    assert set(np.unique(multi.make_drone_scene(glass=False)[0][0].grid).tolist()) >= {16, 62}
    for i, v in enumerate(vols[1:]):
        assert v.grid.shape == (16, 16, 16) and tuple(v.pos) == (float(i), 2.0, 0.0)

    rng = np.random.RandomState(4)
    box = np.concatenate([rng.randint(0, 6, (40, 3)), rng.choice([16, 62, 30], (40, 1))], 1)
    drone = np.concatenate([rng.randint(0, 4, (20, 3)), np.full((20, 1), 77)], 1)
    os.makedirs(tmp_path / "testing")
    (tmp_path / "testing" / "glass-box.vox").write_bytes(vox_bytes((6, 6, 6), box))
    (tmp_path / "enemy-drone.vox").write_bytes(vox_bytes((4, 4, 4), drone))
    monkeypatch.setenv("VOXEL_TRACER_ASSET_DIR", str(tmp_path))
    vols, _ = multi.make_drone_scene()
    assert vols[0].grid.shape == (6, 6, 6) and tuple(vols[0].pos) == (0.0, 0.0, 0.0)
    assert set(np.unique(vols[0].grid).tolist()) <= {0, 4, 12, 30}
    assert all(set(np.unique(v.grid).tolist()) == {0, 77} for v in vols[1:])
