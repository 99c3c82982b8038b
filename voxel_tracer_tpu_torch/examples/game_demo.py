"""Headless arcade-game demo on the PyTorch / CUDA port, rendered every frame.

Counterpart of `examples/game_demo.py`.  The reference's deliverable is a
playable game (src/game/game.cpp:28-98): drones steer and rotate each
tick, the laser carves voxels out of them, kills reload the model.  This
demo runs that loop headless, each frame a full-material frame over five
moving volumes (`ops/cuda/multi.render_whitted_multi`, every traversal on
the ray-list kernel B2):

- per-frame drone motion and rotation: each volume's (rot, pos), passed
  with `with_transforms` (scene.cpp:40-43, enemy.cpp:10-43);
- laser carving: each carved voxel is mirrored into the drone's device
  tables in place (`MegaIntersector.mirror_voxel`, O(1)); a kill reloads
  the model and re-packs its tables (`refresh_tables`, enemy.cpp:60-63);
- the laser beam renders as up to 8 analytic capsules (scene.cpp:21-24,
  capsule.cpp:56-70); its path is traced on the host by `ops/oracle.py`,
  glass with the medium march.

The scene is the glass test box and four drones, read from the directory
VOXEL_TRACER_ASSET_DIR names (or `--asset-dir`), else procedural
stand-ins (`ops/cuda/multi.glass_box`, `drone_model`).  Runs on the card;
`--device cpu` runs the kernels' plain versions (small sizes only).

After the game loop the render time is measured on a frozen state: CUDA
events over serialized frames, a `torch.profiler` window for device busy,
kernels and the idle share, and host syncs counted by PyTorch's sync
debug mode.  Prints one JSON object (written to ``--json`` if given) and
exits 1 if no voxel was carved.

Usage:
    python -m voxel_tracer_tpu_torch.examples.game_demo [--frames 60]
        [--size 1280x768] [--bounces 2] [--render-every 1]
        [--save-every 20 --out-prefix DIR/frame] [--json PATH]
        [--asset-dir DIR] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from voxel_tracer_tpu_torch.bench.measure import count_host_syncs

N_CAPSULES = 8          # laser segment slots (scene.cpp:21-24)
TIMED_FRAMES = 8        # frozen-state frames timed with CUDA events
PROFILED_FRAMES = 2     # frozen-state frames under torch.profiler


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--size", default="1280x768")
    ap.add_argument("--bounces", type=int, default=2)
    ap.add_argument("--render-every", type=int, default=1)
    ap.add_argument("--save-every", type=int, default=20)
    ap.add_argument("--out-prefix", default=None,
                    help="write every --save-every-th frame with its HUD as "
                         "<prefix>_<frame>.png (no files without it)")
    ap.add_argument("--json", default=None, help="also write the result here")
    ap.add_argument("--asset-dir", default=None,
                    help="directory of the reference's .vox assets "
                         "(default: VOXEL_TRACER_ASSET_DIR)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap.parse_args(argv)


def build_game(args, device):
    """Scene, enemies, per-volume intersectors and the game; the drones'
    carve and reload hooks mirror each edit into their device tables."""
    from voxel_tracer_tpu_torch.game.enemy import Enemy
    from voxel_tracer_tpu_torch.game.game import Game
    from voxel_tracer_tpu_torch.models.scene import Scene
    from voxel_tracer_tpu_torch.models.skydome import SkyDome
    from voxel_tracer_tpu_torch.models.volume import VoxelVolume, compute_brick_occ
    from voxel_tracer_tpu_torch.ops import oracle
    from voxel_tracer_tpu_torch.ops.cuda import mega
    from voxel_tracer_tpu_torch.ops.cuda.multi import (MultiMegaIntersector,
                                                       drone_model, glass_box)
    from voxel_tracer_tpu_torch.ops.cuda.whitted import MegaIntersector

    w, h = (int(v) for v in args.size.split("x"))
    rng = np.random.RandomState(3)
    # static glass test box (scene.cpp:11-13) + 4 dynamic drones
    box = glass_box(args.asset_dir, pos=(0.0, -0.6, -6.5))
    enemies, drones = [], []
    for i in range(4):
        grid, pal = drone_model(args.asset_dir, i)
        vol = VoxelVolume(grid.copy(), pal, pos=(float(i), 2.0, 0.0), vpu=20.0)
        enemies.append(Enemy(vol, rng, reload_fn=lambda m, b=grid.copy(): np.copyto(m.grid, b)))
        drones.append(vol)
    vols = [box] + drones
    scene = Scene(volumes=vols, skydome=SkyDome.procedural(64, 32))
    scene.add_light((0.5, 2.5, -4.0), 0.15, (1.0, 0.9, 0.8), 40.0)

    mvs = [mega.MegaVolume(v, device) for v in vols]
    isects = [MegaIntersector(mv, shadow_rounds=2, compact=True) for mv in mvs]
    multi = MultiMegaIntersector(isects)

    for vi, (e, v) in enumerate(zip(enemies, drones), start=1):
        host_set, host_reload = v.set_voxel, e.reload_fn

        def set_voxel(x, y, z, val, _set=host_set, _vi=vi):
            _set(x, y, z, val)
            isects[_vi].mirror_voxel(x, y, z)        # vv.cpp:377-432, O(1)

        def reload(m, _reload=host_reload, _vi=vi):
            _reload(m)
            m.brick_occ[:] = compute_brick_occ(m.grid)   # the restored grid's counts
            mvs[_vi].refresh()
            isects[_vi].refresh_tables()

        v.set_voxel = set_voxel
        e.reload_fn = reload

    def intersect(o, d, medium=0):
        """Laser query: nearest hit over all volumes on the host oracle; a
        volume the ray misses inside a medium (t = 0, air) is skipped,
        the reference's BVH pretest (bvh.cpp:229-233)."""
        best = (1e30, 0, np.zeros(3, np.float32))
        for v in vols:
            hh = oracle.intersect_volume(
                oracle.OracleVolume(grid=v.grid, vpu=v.vpu, pos=v.pos, rot=v.rot),
                o, d, medium=medium)
            if medium and hh.depth <= 0.0 and hh.material == 0:
                continue
            if hh.depth < best[0]:
                best = (hh.depth, hh.material, hh.normal)
        return best

    game = Game(scene, enemies, intersect_fn=intersect, aspect=w / h)
    game.start()
    for i, e in enumerate(enemies):
        e.pos = np.array([(i - 1.5) * 1.2, 0.1 * i, -5.0 - i])
        e.velocity = np.zeros(3)
        e.model.set_position(e.pos)
    return game, scene, vols, multi, (w, h)


def frame_inputs(game, scene, vols, sd, device, w, h):
    """This frame's camera, volume transforms and scene data: the laser
    path as capsules (game.cpp:76-83), idle slots parked far away."""
    from voxel_tracer_tpu_torch.ops.prims import build_prims

    pts = game.laser_path or []
    far = np.array([1e5, 1e5, 1e5], np.float32)
    scene.capsules = []
    for si in range(N_CAPSULES):
        if si + 1 < len(pts):
            scene.add_capsule(np.asarray(pts[si], np.float32),
                              np.asarray(pts[si + 1], np.float32), 0.02)
        else:
            scene.add_capsule(far, far + np.array([0, 0, 0.01], np.float32), 0.02)
    sd = sd._replace(prims=build_prims(scene.spheres, scene.capsules, device))
    transforms = [(v.rot, v.pos) for v in vols]
    return game.player.camera(w / h), transforms, sd


def play(args):
    """Run the game loop and the frozen-state measurement; returns the
    result dict."""
    from voxel_tracer_tpu_torch.game.game import GameState
    from voxel_tracer_tpu_torch.game.player import Input
    from voxel_tracer_tpu_torch.ops.cuda import mega
    from voxel_tracer_tpu_torch.ops.cuda.multi import render_whitted_multi
    from voxel_tracer_tpu_torch.renderer import RenderConfig

    device = torch.device(args.device)
    game, scene, vols, multi, (w, h) = build_game(args, device)
    config = RenderConfig(width=w, height=h, shading="full", max_bounces=args.bounces,
                          glass_reflections=2, compact=True)
    sd = scene.data(device)          # volumes, sky, lights; prims change per frame

    def render(cam, transforms, sd_f, frame):
        return render_whitted_multi(multi, sd_f, cam, w, h, frame, transforms,
                                    config=config)["image"]

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    carved0 = sum(int((v.grid != 0).sum()) for v in vols)
    t_sim = t_render = 0.0
    rendered = 0
    mega.reset_launch_counts()
    t_wall0 = time.perf_counter()
    for frame in range(args.frames):
        t0 = time.perf_counter()
        tgt = min(game.enemies, key=lambda e: np.linalg.norm(e.pos - game.player.pos))
        d = tgt.pos - game.player.pos
        d = d / max(np.linalg.norm(d), 1e-9)
        game.player.yaw = float(np.arctan2(-d[0], -d[2]))
        game.player.pitch = float(np.clip(np.arcsin(d[1]), -1.5, 0.4))
        game.tick(1 / 60, Input(fire=(frame % 2 == 0)))
        if game.state == GameState.GAME_OVER:
            game.start()
        t_sim += time.perf_counter() - t0

        if frame % args.render_every == 0:
            t0 = time.perf_counter()
            cam, transforms, sd_f = frame_inputs(game, scene, vols, sd, device, w, h)
            img = render(cam, transforms, sd_f, frame % 120)
            sync()
            t_render += time.perf_counter() - t0
            rendered += 1
            if args.out_prefix and frame % args.save_every == 0:
                from voxel_tracer_tpu_torch.game.gui import GameGui, draw_game_gui
                from voxel_tracer_tpu_torch.utils.framebuffer import Surface
                surf = Surface(w, h).from_float(img.cpu().numpy())
                draw_game_gui(surf, game, GameGui())
                surf.save_png(f"{args.out_prefix}_{frame:04d}.png")
    wall = time.perf_counter() - t_wall0
    loop_b2 = mega.KERNEL_LAUNCHES["mega_rays"]
    carved = carved0 - sum(int((v.grid != 0).sum()) for v in vols)

    result = {
        "device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                   else "cpu"),
        "resolution": f"{w}x{h}",
        "frames_simulated": args.frames,
        "frames_rendered": rendered,
        "wall_fps": args.frames / wall,
        "render_ms_per_frame_walled": t_render / max(rendered, 1) * 1e3,
        "sim_ms_per_frame": t_sim / args.frames * 1e3,
        "voxels_carved": carved,
        "score": game.score,
        "volumes": len(vols),
        "b2_launches_per_frame_in_loop": loop_b2 / max(rendered, 1),
        "config": {"bounces": args.bounces, "glass_reflections": 2, "shadow_rounds": 2,
                   "shading": "full", "compact": True, "dynamic_rotating_volumes": 4},
    }
    if device.type != "cuda":
        result.update(render_ms_per_frame="not measured", kernels_per_frame="not measured",
                      b2_launches_per_frame="not measured",
                      host_syncs_per_frame="not measured", idle_share="not measured")
        return result

    # frozen state: serialized frames timed with CUDA events
    from voxel_tracer_tpu_torch.utils.timer import device_busy, device_time
    cam, transforms, sd_f = frame_inputs(game, scene, vols, sd, device, w, h)
    before = mega.KERNEL_LAUNCHES["mega_rays"]
    sec, _ = device_time(render, cam, transforms, sd_f, 0, warmup=1, iters=TIMED_FRAMES)
    b2 = (mega.KERNEL_LAUNCHES["mega_rays"] - before) / (TIMED_FRAMES + 1)
    wall_f, busy, kernels = device_busy(lambda: [render(cam, transforms, sd_f, 0)
                                                 for _ in range(PROFILED_FRAMES)])
    wall_f, busy = wall_f / PROFILED_FRAMES, None if busy is None else busy / PROFILED_FRAMES
    syncs = count_host_syncs(lambda: render(cam, transforms, sd_f, 0))
    result.update(
        render_ms_per_frame=sec * 1e3,
        render_fps=1.0 / sec,
        profiled_wall_ms_per_frame=wall_f,
        device_busy_ms_per_frame=busy,
        kernels_per_frame=kernels / PROFILED_FRAMES,
        b2_launches_per_frame=b2,
        host_syncs_per_frame=syncs,
        idle_share=None if busy is None else 1.0 - busy / wall_f,
    )
    return result


def main(argv=None):
    args = parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("game_demo: no CUDA device (pass --device cpu to run the plain "
              "versions on the CPU)", file=sys.stderr)
        return 2
    result = play(args)
    print(json.dumps(result, indent=1))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    return 0 if result["voxels_carved"] > 0 else 1


if __name__ == "__main__":
    sys.exit(main())
