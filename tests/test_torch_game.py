"""Parity: the port's game layer (`game/`), oracle (`ops/oracle.py`),
framebuffer and timer against the JAX package's, on tests/test_game.py's
cases.

Both packages run the same scenario from the same seeds (numpy
`RandomState`), and the port's results are held to the JAX ones: player
and enemy state, carved grids, scores and game states equal; laser paths
within 1e-5; oracle hits equal (the same scalar numpy program); HUD and
menu pixels and PNG bytes equal.  The JAX game runs on its own `Camera`
and `VoxelVolume`, the port's on the port's.
"""

import importlib
import types

import numpy as np
import pytest
import torch

PATH_ATOL = 1e-5


def _pkg(root):
    mods = dict(enemy="game.enemy", game="game.game", gui="game.gui", player="game.player",
                scene="models.scene", volume="models.volume", oracle="ops.oracle",
                fb="utils.framebuffer", timer="utils.timer")
    return types.SimpleNamespace(**{k: importlib.import_module(f"{root}.{v}")
                                    for k, v in mods.items()})


JAX, PORT = _pkg("voxel_tracer_tpu"), _pkg("voxel_tracer_tpu_torch")


def _solid_volume(p, n=16, mat=30, pos=(0, 0, 0)):
    return p.volume.VoxelVolume(np.full((n, n, n), mat, np.uint8), pos=pos, vpu=20.0)


def _intersect(p, vols):
    """test_game.py's oracle query: the medium march per volume, skipping
    a volume the ray misses inside a medium (t = 0, air)."""
    ovols = [p.oracle.OracleVolume(grid=v.grid, vpu=v.vpu, pos=v.pos, rot=v.rot)
             for v in vols]

    def fn(o, d, medium=0):
        if not medium:
            h = p.oracle.intersect_scene(ovols, o, d)
            return h.depth, h.material, h.normal
        best = None
        for v in ovols:
            h = p.oracle.intersect_volume(v, o, d, medium=medium)
            if h.depth <= 0.0 and h.material == 0:
                continue
            if best is None or h.depth < best.depth:
                best = h
        if best is None:
            best = p.oracle.intersect_volume(ovols[0], o, d, medium=medium)
        return best.depth, best.material, best.normal
    return fn


def _both(fn):
    """fn(package) for the JAX package and the port."""
    return fn(JAX), fn(PORT)


def _assert_state_equal(a, b, path=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_state_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_state_equal(x, y, f"{path}[{i}]")
    else:
        np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                                   rtol=0, atol=PATH_ATOL, err_msg=path)


def test_player_flight_matches_jax():
    rng = np.random.RandomState(5)
    inputs = [dict(forward=float(rng.choice([-1, 0, 1])), strafe=float(rng.choice([-1, 0, 1])),
                   up=float(rng.choice([-1, 0, 1])), mouse_dx=float(rng.randn() * 40),
                   mouse_dy=float(rng.randn() * 40)) for _ in range(90)]

    def run(p):
        pl = p.player.Player()
        out = []
        for kw in inputs:
            pos, target, dd = pl.tick(1 / 60, p.player.Input(**kw))
            out.append([pos, target, dd, pl.velocity, pl.yaw, pl.pitch])
        cam = pl.camera(16 / 9)
        out.append([np.asarray(f) for f in (cam.pos, cam.tl, cam.tr, cam.bl, cam.planes)])
        return out
    j, t = _both(run)
    _assert_state_equal(j, t)
    assert t[-2][0][2] != -2.0 and -1.5 <= t[-2][5] <= 0.4


def test_enemy_steering_matches_jax():
    """Three drones from one RandomState steer toward a moving player and
    apart from each other; the model transform follows (enemy.cpp:10-43)."""
    def run(p):
        rng = np.random.RandomState(0)
        es = [p.enemy.Enemy(_solid_volume(p, 8), rng) for _ in range(3)]
        out, caught = [], []
        for k in range(150):
            player = np.array([np.sin(k / 30.0), 0.2, -2.0 + 0.01 * k])
            for e in es:
                caught.append(e.tick(1 / 60, player, es))
            out.append([[e.pos, e.velocity, e.yaw, e.model.pos, e.model.rot] for e in es])
        return out, caught
    (j, jc), (t, tc) = _both(run)
    _assert_state_equal(j, t)
    assert jc == tc
    d0 = np.linalg.norm(t[0][0][0] - np.array([0.0, 0.2, -2.0]))
    assert np.linalg.norm(t[-1][0][0] - np.array([np.sin(149 / 30), 0.2, -0.51])) < d0


def test_carving_and_reload_match_jax():
    def run(p):
        rng = np.random.RandomState(0)
        vol = _solid_volume(p, 8)
        restored = []
        e = p.enemy.Enemy(vol, rng, reload_fn=lambda m: restored.append(m.grid.copy()))
        e.health = 3
        hp = vol.pos + np.array([0.0, 0.0, -vol.size[2] / 2], np.float32)
        died = [e.process_hit(hp + np.array([0.06 * k, 0.0, 0.0], np.float32),
                              np.array([0, 0, -1.0], np.float32)) for k in range(3)]
        return died, vol.grid.copy(), vol.brick_occ.copy(), restored, e.pos, e.health
    (jd, jg, jb, jr, jp, jh), (td, tg, tb, tr, tp, th) = _both(run)
    assert jd == td == [False, False, True]
    np.testing.assert_array_equal(jg, tg)
    np.testing.assert_array_equal(jb, tb)
    assert int((tg != 0).sum()) == 8 ** 3 - 3        # each hit carves before the kill
    assert len(jr) == len(tr) == 1 and np.array_equal(jr[0], tr[0])
    np.testing.assert_array_equal(jp, tp)
    assert jh == th == 32


def test_state_machine_laser_and_score_match_jax():
    def run(p):
        rng = np.random.RandomState(1)
        vol = _solid_volume(p, 8, mat=30, pos=(0, 0, -3))
        enemy = p.enemy.Enemy(vol, rng)
        game = p.game.Game(p.scene.Scene(volumes=[vol]), [enemy],
                           intersect_fn=_intersect(p, [vol]), aspect=1.0)
        states = [game.state.name]
        game.start()
        states.append(game.state.name)
        enemy.pos = np.array([0.0, 0.0, -3.0])
        enemy.velocity = np.zeros(3)
        vol.set_position(enemy.pos)
        paths = []
        for k in range(6):
            game.tick(1 / 60, p.player.Input(fire=k % 2 == 0, mouse_dx=3.0))
            paths.append([np.asarray(q) for q in game.laser_path])
        return states, game.score, vol.grid.copy(), paths, game.hud_lines()
    (js, jsc, jg, jpaths, jh), (ts, tsc, tg, tpaths, th) = _both(run)
    assert js == ts == ["MENU", "GAME"]
    assert jsc == tsc and tsc >= 1
    np.testing.assert_array_equal(jg, tg)
    assert int((tg != 0).sum()) < 8 ** 3
    _assert_state_equal(jpaths, tpaths)
    assert len(tpaths[0]) >= 2 and jh == th


@pytest.mark.parametrize("core", [True, False], ids=["diffuse_core", "pure_glass"])
def test_laser_through_glass_matches_jax(core):
    """next_path_ray's glass semantics (materials.cpp:50-69): the beam
    enters the glass box, continues as the same ray with the medium set,
    and the interior march ends on the diffuse core, or at the back face
    with air (test_game.py's two cases)."""
    def run(p):
        g = np.full((16, 16, 16), 3, np.uint8)
        if core:
            g[6:10, 6:10, 6:10] = 30
        vol = p.volume.VoxelVolume(g, pos=(0, 0, -4), vpu=20.0)
        game = p.game.Game(p.scene.Scene(volumes=[vol]), [],
                           intersect_fn=_intersect(p, [vol]), aspect=1.0)
        game.start()
        game.tick(1 / 60, p.player.Input(fire=True))
        return [np.asarray(q) for q in game.laser_path]
    j, t = _both(run)
    _assert_state_equal(j, t)
    assert len(t) == 3
    assert abs(t[1][2] - (-3.6)) < 0.02
    if core:
        assert -4.12 < t[2][2] < -3.88 and abs(t[2][0]) < 0.11
    else:
        assert abs(t[2][2] - (-4.4)) < 0.02


def test_game_over_when_caught_matches_jax():
    def run(p):
        vol = _solid_volume(p, 8)
        enemy = p.enemy.Enemy(vol, np.random.RandomState(2))
        game = p.game.Game(p.scene.Scene(volumes=[vol]), [enemy], aspect=1.0)
        game.start()
        enemy.pos = game.player.pos + np.array([0.1, 0.0, 0.0])
        game.tick(1 / 60, p.player.Input())
        return game.state.name, game.hud_lines()
    assert _both(run) == (("GAME_OVER", ["GAME OVER", "SCORE: 0"]),) * 2


def test_gui_screens_match_jax():
    """Menu, HUD and game-over screens and their keyboard navigation
    (gui.h + game.cpp:103-223): the same pixels in both packages."""
    def run(p):
        vol = _solid_volume(p, 8)
        game = p.game.Game(p.scene.Scene(volumes=[vol]),
                           [p.enemy.Enemy(vol, np.random.RandomState(0))], aspect=1.0)
        gui = p.gui.GameGui()
        frames, states = [], []
        steps = [None, p.gui.MenuInput(down=True), p.gui.MenuInput(up=True),
                 p.gui.MenuInput(confirm=True), None]
        for inp in steps:
            surf = p.fb.Surface(160, 120)
            surf.clear((20, 60, 90))
            p.gui.draw_game_gui(surf, game, gui, inp)
            frames.append(surf.pixels.copy())
            states.append((game.state.name, gui.focus))
        game.state = p.game.GameState.GAME_OVER
        game.score = 7
        surf = p.fb.Surface(160, 120)
        p.gui.draw_game_gui(surf, game, gui)
        frames.append(surf.pixels.copy())
        return frames, states
    (jf, js), (tf, ts) = _both(run)
    assert js == ts and ts[3][0] == "GAME"
    for a, b in zip(jf, tf):
        np.testing.assert_array_equal(a, b)
    assert tf[-1][:, :, 0].mean() > tf[-1][:, :, 2].mean()          # red game-over tint
    assert (tf[-2] != np.array([20, 60, 90], np.uint8)).any()       # HUD glyphs landed


def test_framebuffer_png_roundtrip_matches_jax(tmp_path):
    img = (np.random.RandomState(0).rand(20, 30, 3) * 255).astype(np.uint8)
    for p, name in ((JAX, "j.png"), (PORT, "t.png")):
        p.fb.write_png(str(tmp_path / name), img)
    assert (tmp_path / "j.png").read_bytes() == (tmp_path / "t.png").read_bytes()
    np.testing.assert_array_equal(PORT.fb.read_png(str(tmp_path / "t.png"))[:, :, :3], img)

    def draw(p):
        s = p.fb.Surface(64, 32)
        s.clear((10, 20, 30))
        s.line(0, 0, 63, 31, (255, 0, 0))
        s.bar(5, 5, 8, 8, (0, 255, 0))
        s.box(40, 2, 60, 12, (0, 0, 255))
        s.print("SCORE: 42", 2, 20)
        s2 = p.fb.Surface(4, 4).from_float(np.linspace(0, 1, 48).reshape(4, 4, 3))
        return s.pixels, s2.pixels
    (ja, jb), (ta, tb) = _both(draw)
    np.testing.assert_array_equal(ja, ta)
    np.testing.assert_array_equal(jb, tb)


def test_timer_and_device_time_on_cpu():
    t = PORT.timer.Timer()
    assert t.elapsed() >= 0.0 and t.reset() >= 0.0
    f = PORT.timer.EmaFps()
    f.update(1 / 60)
    f.update(1 / 30)
    j = JAX.timer.EmaFps()
    j.update(1 / 60)
    j.update(1 / 30)
    assert f.fps == j.fps and 25 < f.fps < 65
    x = torch.arange(6, dtype=torch.float32) + 2.0
    assert PORT.timer._force_sync({"a": [x * 2]}) == 4.0
    assert PORT.timer._force_sync(()) is None
    sec, out = PORT.timer.device_time(lambda a: a + 1, x, warmup=1, iters=3)
    assert sec >= 0.0 and torch.equal(out, x + 1)


@pytest.mark.parametrize("mode", ["plain", "medium", "ignore", "shadow"])
def test_oracle_matches_jax(mode):
    rng = np.random.RandomState(21)
    g = np.zeros((20, 24, 28), np.uint8)
    g[3:17, 4:20, 5:23] = 3
    g[7:12, 8:14, 9:16] = 40
    g[0:4, 0:6, :] = 12
    rot = np.array([[0.8, 0.0, 0.6], [0.0, 1.0, 0.0], [-0.6, 0.0, 0.8]], np.float32)
    kw = dict(plain={}, medium=dict(medium=3), ignore=dict(ignore=3),
              shadow=dict(shadow=True, seed=77))[mode]
    jv, tv = _both(lambda p: p.oracle.OracleVolume(grid=g, vpu=20.0,
                                                   pos=np.array([0.1, 0.0, 0.2]), rot=rot))
    for _ in range(60):
        o = rng.uniform(-0.9, 0.9, 3).astype(np.float32)
        d = rng.randn(3).astype(np.float32)
        d /= np.linalg.norm(d)
        hj = JAX.oracle.intersect_volume(jv, o, d, **kw)
        ht = PORT.oracle.intersect_volume(tv, o, d, **kw)
        assert (hj.depth, hj.material, hj.steps) == (ht.depth, ht.material, ht.steps)
        np.testing.assert_array_equal(hj.normal, ht.normal)
        np.testing.assert_array_equal(hj.albedo, ht.albedo)


def test_game_demo_on_cpu(tmp_path):
    """game_demo's loop at a tiny size on the plain versions: the laser
    carves drone voxels, each carve is mirrored into the drone's device
    tables (equal to a fresh pack), and the result JSON is written."""
    import json

    from voxel_tracer_tpu_torch.examples import game_demo
    from voxel_tracer_tpu_torch.game.player import Input
    from voxel_tracer_tpu_torch.ops.cuda import mega

    args = game_demo.parse_args(["--device", "cpu", "--size", "32x20"])
    game, _scene, vols, m, _wh = game_demo.build_game(args, torch.device("cpu"))
    before = [v.grid.copy() for v in vols]
    for k in range(8):
        d = game.enemies[0].pos - game.player.pos
        game.player.yaw = float(np.arctan2(-d[0], -d[2]))
        game.player.pitch = float(np.clip(np.arcsin(d[1] / np.linalg.norm(d)), -1.5, 0.4))
        game.tick(1 / 60, Input(fire=True))
    carved = [int((b != v.grid).sum()) for b, v in zip(before, vols)]
    assert carved[0] == 0 and sum(carved) > 0
    for isect, v in zip(m.vols, vols):
        fresh = mega.pack_tables(v.grid, v.palette, v.vpu, "cpu")
        for f in ("bocc", "bitmap", "occw", "matb", "grid", "brick_occ"):
            assert torch.equal(getattr(isect.full_tables, f), getattr(fresh, f)), f
        assert torch.equal(isect.grid_dda, torch.from_numpy(v.grid.astype(np.int32)))

    out = tmp_path / "demo.json"
    rc = game_demo.main(["--device", "cpu", "--frames", "3", "--size", "24x16",
                         "--json", str(out)])
    res = json.loads(out.read_text())
    assert rc == 0 and res["voxels_carved"] > 0 and res["frames_rendered"] == 3
    assert res["render_ms_per_frame"] == "not measured"
