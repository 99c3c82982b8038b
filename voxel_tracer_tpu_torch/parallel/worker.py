"""One rank of a multi-process run of the parallel layer.

Counterpart of `tools/multiproc_worker.py`: N processes join one process
group (`parallel.distributed.initialize`), build their meshes and run the
sharded train steps, traces and frames on one deterministic problem;
rank 0 prints one JSON line with each mode's losses or checksums, the
world size, the collective backend and the device.  Start one process
per rank:

    python -m voxel_tracer_tpu_torch.parallel.worker --world 2 --rank 0 \\
        --init-method file:///tmp/store --device cpu \\
        --mode replicated,overlap,trace,render

Modes (comma-separated, run in the order given, every rank in each):

- ``replicated``: `make_train_step` on the problem's rays, sharded over a
  ray mesh of every rank, parameters replicated;
- ``overlap``: the same with ``overlap_slabs=4`` (per-slab gradient
  averages inside the backward pass);
- ``grid``: `make_grid_sharded_train_step` on a (grid 2, rays world/2)
  mesh; also reports each rank's parameter and Adam moment shapes;
- ``nosync``: the ray-sharded step with ``sync_grads=False``: each rank
  trains on its block alone (rank 0 reports its own losses);
- ``replicated:S``, ``overlap:S``, ``grid:S``: the same with a march
  budget of S steps (the targets', and a slab's, too) in place of the
  problem's.  Slab compositions equal the one march only where no ray
  runs out of steps;
- ``trainer``: `Trainer.fit` (wavefront) under the process group;
- ``kernel``: `Trainer(backend="kernel")` under the group: the error;
- ``trace`` / ``trace:G``: the grid-sharded trace on a (rays world/G,
  grid G) mesh against the replicated `composite.intersect_scene`;
- ``render``: `sharded_render` (full shading) against the unsharded
  `render_rays`, field for field;
- ``probe``: which collectives the backend runs on the device's tensors
  as they are.

Problems: ``small`` (the JAX worker's `build_problem`: 512 rays, 32^3;
`test_grid_shard.py`'s 48^3 volume and 32x32 rays; a 32^3 glass box at
48x32) and ``inverse_128`` (bench_suite.py's inverse_128_32views: a 128^3
grid, 32 ring views of 64x64, vpu 20, Adam lr 1e-2, 192 march steps; the
48^3 volume scaled to 128^3 and 1280x768 rays; the 128^3 glass box at
320x192).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from voxel_tracer_tpu_torch.parallel import distributed, mesh as pmesh
from voxel_tracer_tpu_torch.parallel.mesh import GRID, RAYS
from voxel_tracer_tpu_torch.utils import profiling


def build_problem(n_rays=512, g=32):
    """Deterministic tiny inverse-rendering problem (config-5 shaped): the
    JAX worker's `build_problem`, numpy from seed 0."""
    rng = np.random.RandomState(0)
    zz, yy, xx = np.meshgrid(*[np.linspace(0, 1, g)] * 3, indexing="ij")
    r2 = (xx - 0.5) ** 2 + (yy - 0.5) ** 2 + (zz - 0.5) ** 2
    sigma_true = (40.0 * np.exp(-r2 * 30.0)).astype(np.float32)
    albedo_true = np.stack([xx, yy, 1.0 - xx], axis=-1).astype(np.float32)

    views = 32
    rpv = n_rays // views
    th = np.linspace(0, 2 * np.pi, views, endpoint=False)
    centers = np.stack([0.5 + 1.4 * np.cos(th), np.full(views, 0.9),
                        0.5 + 1.4 * np.sin(th)], axis=1)
    fwd = np.array([0.5, 0.5, 0.5]) - centers
    fwd /= np.linalg.norm(fwd, axis=1, keepdims=True)
    d = fwd[:, None, :] + rng.randn(views, rpv, 3) * 0.12
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.broadcast_to(centers[:, None, :], (views, rpv, 3))
    return (sigma_true, albedo_true,
            np.ascontiguousarray(o.reshape(-1, 3), np.float32),
            np.ascontiguousarray(d.reshape(-1, 3), np.float32))


def train_problem(name):
    """(truth sigma, truth albedo, origins, dirs, init sigma, settings) of
    a training problem, numpy."""
    if name == "small":
        s, a, o, d = build_problem()
        g = s.shape[0]
        return s, a, o, d, dict(vpu=float(g), max_steps=48, lr=5e-2,
                                sigma_init=5.0)
    s, a = profiling.blob_field(128, 1)
    o, d = profiling.ring_views()
    return s, a, o, d, dict(vpu=20.0, max_steps=192, lr=1e-2, sigma_init=0.1)


def targets(sigma, albedo, o, d, vpu, max_steps, device):
    """Target colours: the truth field rendered by the wavefront march."""
    from voxel_tracer_tpu_torch.ops import diff
    with torch.no_grad():
        return diff.render_density(
            torch.from_numpy(sigma).to(device), torch.from_numpy(albedo).to(device),
            torch.from_numpy(o).to(device), torch.from_numpy(d).to(device),
            vpu, max_steps)["color"]


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _timed_steps(step, params, o, d, t, steps, device):
    losses, ms, opt = [], [], None
    for _ in range(steps):
        _sync(device)
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, o, d, t)
        losses.append(float(loss))
        _sync(device)
        ms.append((time.perf_counter() - t0) * 1e3)
    return losses, ms, opt


TRAIN_MODES = ("replicated", "overlap", "grid", "nosync")


def run_train(mode, problem, device, steps, march_steps=None):
    """One of the train modes; returns its JSON-able result."""
    from voxel_tracer_tpu_torch.parallel.grid_train import (
        make_grid_sharded_train_step, place_grid_params)
    from voxel_tracer_tpu_torch.parallel.sharding import make_train_step
    s_true, a_true, o_np, d_np, cfg = problem
    budget = march_steps or cfg["max_steps"]
    g = s_true.shape[0]
    init = {"sigma": np.full((g,) * 3, cfg["sigma_init"], np.float32),
            "albedo": np.full((g,) * 3 + (3,), 0.5, np.float32)}
    world = pmesh.world_size()
    if mode == "grid":
        mesh = pmesh.make_mesh(((GRID, 2), (RAYS, world // 2)), device)
        params = place_grid_params(mesh, init)
        step = make_grid_sharded_train_step(mesh, cfg["lr"], cfg["vpu"], budget)
    else:
        mesh = pmesh.make_ray_mesh(device=device)
        params = {k: torch.from_numpy(v).to(device).requires_grad_()
                  for k, v in init.items()}
        step = make_train_step(mesh, cfg["lr"], cfg["vpu"], budget,
                               sync_grads=mode != "nosync",
                               overlap_slabs=4 if mode == "overlap" else 1)
    o, d = (pmesh.shard_rays(mesh, torch.from_numpy(x).to(device)) for x in (o_np, d_np))
    # each rank renders the targets of its own rays (a ray's colour does
    # not depend on the batch it is rendered in) with the march it trains
    # with, as the JAX worker does
    t = targets(s_true, a_true, *(pmesh.shard_rays(mesh, x) for x in (o_np, d_np)),
                cfg["vpu"], budget, device)
    losses, ms, opt = _timed_steps(step, params, o, d, t, steps, device)
    out = dict(losses=losses, ms_per_step=ms, rays_per_rank=int(o.shape[0]),
               march_steps=budget)
    if mode == "grid":
        out["slab_shapes"] = {k: list(v.shape) for k, v in params.items()}
        out["moment_shapes"] = {
            k: [list(opt.state[params[k]][m].shape) for m in ("exp_avg", "exp_avg_sq")]
            for k in params}
    return out


def run_trainer(problem, device, steps, out_dir=None, profile=None, mesh=None):
    """`Trainer.fit` (wavefront) on the problem's rays, batches of all of
    them, under the process group if one is initialized.  ``profile``:
    called with a function that runs one more step; its result is kept
    under "profile".  ``mesh``: passed to `Trainer(cfg, mesh)` as JAX
    passes it, positionally (None: the Trainer's own ray mesh)."""
    from voxel_tracer_tpu_torch.trainer import TrainConfig, Trainer
    s_true, a_true, o, d, cfg = problem
    c = targets(s_true, a_true, o, d, cfg["vpu"], cfg["max_steps"], device).cpu().numpy()
    metrics = os.path.join(out_dir, "metrics.jsonl") if out_dir else None
    tc = TrainConfig(grid_size=s_true.shape, vpu=cfg["vpu"], lr=cfg["lr"], steps=steps,
                     rays_per_batch=o.shape[0], march_steps=cfg["max_steps"],
                     sigma_init=cfg["sigma_init"], metrics_path=metrics)
    tr = Trainer(tc, mesh, device=device)
    ms = []

    def timed(_msg):
        _sync(device)
        ms.append((time.perf_counter() - t0[0]) * 1e3)
        t0[0] = time.perf_counter()

    t0 = [time.perf_counter()]
    losses = tr.fit(o, d, c, log_every=1, log_fn=timed)
    out = dict(losses=losses, ms_per_step=ms, world=tr.mesh.size)
    if profile is not None:
        tr.cfg = dataclasses.replace(tr.cfg, steps=steps + 1)
        out["profile"] = profile(lambda: tr.fit(o, d, c, log_every=steps + 2))
    return out


def run_kernel(device):
    from voxel_tracer_tpu_torch.trainer import TrainConfig, Trainer
    try:
        Trainer(TrainConfig(grid_size=(8, 8, 8), backend="kernel"), device=device)
    except ValueError as e:
        return dict(error=str(e))
    return dict(error=None)


def trace_volume(n, aspect=1.0):
    """`test_grid_shard.py`'s punched sphere volume at n^3 (48 there), its
    world extent kept, and a camera whose rays run along +z."""
    from voxel_tracer_tpu_torch.models.camera import Camera
    from voxel_tracer_tpu_torch.models.volume import VoxelVolume
    rng = np.random.RandomState(5)
    z, y, x = np.meshgrid(*[np.arange(n)] * 3, indexing="ij")
    c = (n - 1) / 2
    r = np.sqrt((x - c) ** 2 + (y - c) ** 2 + (z - c) ** 2)
    grid = np.where(r < 19 * n / 48, np.where(z > c, 20, 30), 0).astype(np.uint8)
    # punch holes so rays penetrate across slab boundaries
    grid[rng.rand(n, n, n) < 0.25] = 0
    pal = rng.rand(256, 3).astype(np.float32)
    vol = VoxelVolume(grid, pal, pos=(0.1, 0.0, -0.2), vpu=20.0 * n / 48)
    return vol, Camera.create((0.1, 0.2, -3.0), (0.1, 0.0, -0.2), aspect)


def run_trace(n_grid, problem_name, device, out_dir=None):
    """Grid-sharded trace vs the replicated one; rank 0 compares."""
    from voxel_tracer_tpu_torch.models.camera import rays_for_image
    from voxel_tracer_tpu_torch.models.scene import Scene
    from voxel_tracer_tpu_torch.ops import composite
    from voxel_tracer_tpu_torch.parallel import grid_shard
    n, (w, h) = (48, (32, 32)) if problem_name == "small" else (128, (1280, 768))
    vol, cam = trace_volume(n, w / h)
    world = pmesh.world_size()
    mesh = pmesh.make_ray_grid_mesh(world // n_grid, n_grid, device=device)
    slab = grid_shard.local_slab(mesh, grid_shard.split_volume_z(vol, n_grid, device))
    o, d = rays_for_image(cam, w, h, device=device)
    trace = grid_shard.make_grid_sharded_trace(mesh)
    _sync(device)
    t0 = time.perf_counter()
    local = trace(slab, pmesh.shard_rays(mesh, o), pmesh.shard_rays(mesh, d))
    got = composite.HitResult(*(mesh.all_gather(RAYS, x).flatten(0, 1) for x in local))
    _sync(device)
    ms = (time.perf_counter() - t0) * 1e3
    if mesh.coords[RAYS] != 0 or mesh.coords[GRID] != 0:
        return None
    ref = composite.intersect_scene(Scene(volumes=[vol]).data(device), o, d)
    h_ref, h_got = ref.t < 1e30, got.t < 1e30
    both = h_ref & h_got
    res = dict(rays=w * h, slabs=n_grid, ms=ms, hits=int(h_got.sum()),
               mismatches=int((h_ref != h_got).sum()),
               t_max_diff=float((got.t - ref.t)[both].abs().max()) if bool(both.any()) else 0.0,
               mat_equal=float((got.mat == ref.mat)[both].float().mean()),
               normal_equal=float(((got.normal - ref.normal).abs().amax(-1) < 1e-5)[both]
                                  .float().mean()))
    if out_dir:
        np.savez(os.path.join(out_dir, f"trace_{n_grid}.npz"),
                 **{f: getattr(got, f).cpu().numpy() for f in ("t", "mat", "normal")})
    return res


def run_render(problem_name, device):
    """`sharded_render` of the glass box, full shading, against the
    unsharded `render_rays` on the same rays; rank 0 compares."""
    from voxel_tracer_tpu_torch.models.camera import rays_for_image
    from voxel_tracer_tpu_torch.parallel.sharding import sharded_render
    from voxel_tracer_tpu_torch.renderer import RenderConfig, render_rays
    from voxel_tracer_tpu_torch.utils.profiling import glass_box_camera, glass_box_scene
    n, (w, h) = (32, (48, 32)) if problem_name == "small" else (128, (320, 192))
    merged, scene = glass_box_scene(n)
    sd = scene.data(device)
    cam = glass_box_camera(merged, 0.05, w, h)
    cfg = RenderConfig(width=w, height=h, shading="full", max_bounces=3,
                       glass_reflections=2, compact=True)
    mesh = pmesh.make_ray_mesh(device=device)
    _sync(device)
    t0 = time.perf_counter()
    out = sharded_render(mesh, cfg)(sd, cam, 3)
    _sync(device)
    ms = (time.perf_counter() - t0) * 1e3
    if mesh.coords[RAYS] != 0:
        return None
    o, d = rays_for_image(cam, w, h, device=device)
    ref = render_rays(sd, o, d, 3, config=cfg)
    diffs = {k: float((out[k].double() - ref[k].double()).abs().max()) for k in ref}
    hit = ref["depth"] < 1e30
    rows = torch.div(ref["material"][hit] - 1, 8, rounding_mode="floor")
    return dict(size=[w, h], ms=ms, max_abs_diff=diffs,
                hit_fraction=float(hit.float().mean()),
                glass_hits=int((rows == 0).sum()), mirror_hits=int((rows == 1).sum()),
                checksum=float(ref["image"].double().sum()))


def probe_collectives(device):
    """Whether the group's backend runs the mesh's collectives on
    ``device`` tensors as they are ("ok"), or the error it raises (gloo
    implements some collectives for host tensors only)."""
    import torch.distributed as dist
    x = torch.arange(4.0, device=device) + dist.get_rank()
    ops = {"all_reduce": lambda: dist.all_reduce(x.clone()),
           "all_gather": lambda: dist.all_gather(
               [torch.empty_like(x) for _ in range(dist.get_world_size())], x)}
    out = {}
    for op, fn in ops.items():
        try:
            fn()
            out[op] = "ok"
        except RuntimeError as e:
            out[op] = str(e).strip().splitlines()[0][:200]
    return out


def run_modes(modes, problem_name, device, steps=3, out_dir=None):
    """Every mode in ``modes`` on this rank; {mode: result} (rank 0's
    results are the ones reported)."""
    problem = None
    results = {}
    for mode in modes:
        name, _, arg = mode.partition(":")
        if name in TRAIN_MODES + ("trainer",) and problem is None:
            problem = train_problem(problem_name)
        if name == "trainer":
            results[mode] = run_trainer(problem, device, steps, out_dir)
        elif name in TRAIN_MODES:
            results[mode] = run_train(name, problem, device, steps, int(arg or 0))
        elif name == "kernel":
            results[mode] = run_kernel(device)
        elif name == "probe":
            results[mode] = probe_collectives(device)
        elif name == "trace":
            results[mode] = run_trace(int(arg or 2), problem_name, device, out_dir)
        elif name == "render":
            results[mode] = run_render(problem_name, device)
        else:
            raise ValueError(f"unknown mode {mode!r}")
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=None)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--init-method", default=None,
                    help="tcp://host:port or file:///path; default: the "
                         "launcher's MASTER_ADDR/MASTER_PORT/WORLD_SIZE/RANK")
    ap.add_argument("--backend", default=None, help="default: nccl on cuda, gloo on cpu")
    ap.add_argument("--device", default="cuda", help="cpu, cuda or cuda:N")
    ap.add_argument("--mode", default="replicated")
    ap.add_argument("--problem", default="small", choices=["small", "inverse_128"])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", default=None, help="directory for rank 0's arrays")
    ap.add_argument("--timeout", type=float, default=300.0,
                    help="seconds a collective may wait for the other ranks")
    args = ap.parse_args(argv)

    multi = distributed.initialize(None, args.world, args.rank, backend=args.backend,
                                   init_method=args.init_method, device=args.device,
                                   timeout_s=args.timeout)
    device = torch.device(args.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    info = distributed.process_info()
    try:
        results = run_modes(args.mode.split(","), args.problem, device, args.steps,
                            args.out)
    finally:
        backend = torch.distributed.get_backend() if multi else None
        distributed.shutdown()
    if info["process_index"] == 0:
        print(json.dumps(dict(
            modes=results, world=info["process_count"], backend=backend,
            device=str(device), multi=multi, problem=args.problem)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
