#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

Builds the port's CUDA kernels from the sources in this checkout, drives
the port's main paths through their public entry points, holds every
kernel against its plain PyTorch version on the same inputs, and times
them:

- serving: the bench.py frame -- dense 64^3 noise volume, orbit camera,
  1920x1088, flat (`render_mega`) and lit (`render_lambert_mega`);
- training: `Trainer.fit` with the kernel backend at the width of
  bench_suite.py's inverse_128_32views -- a 128^3 sigma + albedo grid, 32
  ring views of 64x64 (131,072 rays a step), Adam lr 1e-2 -- after the
  integrate kernels are checked on bench_suite.py's diff_lambert_512 scene
  (sparse 64^3 blob, 512x512 camera rays) and the z-slab sequencer;
- the kernel renderer: the 512-crate profiling scene baked into one 256^3
  grid and the bench scene, `render_lambert_fast` and `render_flat_fast`
  at 1920x1088 on the coherent kernel (B5), each bench frame equal to its
  plain-traced frame; then B5 against its plain version on each frame's
  own primary and shadow ray lists and on `profiling.edge_rays`, and an
  unbaked two-volume scene;
- the independent DDA: `render_indep` flat and lambert at 1920x1088 on the
  bench scene (B3) and `trace_rays_indep` on 1 M random rays (B4), then B3
  on the bench frame of a 128^3 noise volume (4096 bricks, the most indep
  takes) and B4 on the long sparse volume's rays, walked end to end;
- the mega kernels' edges: B2 on the lit frame's own shadow-ray list and
  on a long sparse volume whose rays run out of the 256-step budget
  (`profiling.budget_scene`: 2048 bricks, and 32,800 bricks whose bitmap
  outgrows 4 KB), B1 on a 256^3 grid, the lit frame with temporal
  reprojection (`prev_accu`);
- the full-material Whitted frame: `render_whitted_mega` at 1280x768
  (bench_suite.py's full_whitted_720p configuration: 3 bounces, 2 glass
  reflections, 2 shadow rounds, compacted) on a procedural glass box,
  mirror and drones scene, every traversal on B1 / B2; the same frame
  traced by the plain versions at 1280x768 and at 320x192, equal field
  for field; the wavefront `Renderer` at 320x192; four accumulated frames;
  frame time compacted and not, device busy share, kernels and B2
  launches a frame; B2 on the frame's own ray lists, replayed alone;
- the DDA kernel D1 (`csrc/dda.cu`): against the plain DDA (`ops/dda.py`)
  on 1 M random rays through the bench volume, the budget volume's rays,
  a medium batch at a 6-step budget (and the same rays in two calls,
  where the JAX loop's batch rule gives other answers), the glass box's
  interior (medium) and scan (ignore) rays, shadow rays with seeds of
  2^31 and above, and stacked grids by oid with a per-ray vpu (once more
  with the brick bitmap read from global memory, the kernel's branch for
  bitmaps over 16 KB); voxels edited in place between two D1 calls
  (`mega.set_voxel_tables`, a uint8 grid and a grid of ids past 255),
  both calls equal to the plain DDA; the parent design (PR 14's D1,
  built from `tools/torch_dda_trials.py`) timed on the random rays; then
  the slice's path at 1280x768 on the glass box scene: the exact Whitted
  frame (`exact_fallback=True`, its fallback on D1) and the wavefront
  `Renderer` (full shading, 8 bounces, every traversal on D1 and its
  glue on C1, one launch of each C1 kernel a traversal call), each
  equal field for field to its plain frame (B1 / B2 / the DDA plain;
  `composite.PLAIN`) and timed beside it, and each frame's D1 calls
  replayed on D1 and on the parent design in turns;
- the reference's default scene: `render_whitted_multi` over five
  separate volumes (`make_drone_scene`: the glass box and four turned
  drones, one laser capsule) with game_demo's config at 1280x768, every
  traversal on B2; the same frame traced by B2's plain version, the
  wavefront `Renderer`, a drone moved by `with_transforms`, O(1) table
  edits against a repack, frame time and host syncs; then game_demo's
  loop for 14 frames (the laser must carve voxels);
- the top-K prepass C2 (`composite_topk_kernel`) and D1's candidate race
  (`dda_kernel<SMEM>(RaceArgs)`) on their main path: the wavefront
  `Renderer` (full shading, 8 bounces) on the default scene at 1280x720,
  the four drones one stacked group: one C2 launch and one race launch
  for each prepass call, the frame bit-equal to the frame on the plain
  prepass (`composite._topk`) and the plain race (the slot loop), the
  frame's prepass calls replayed on C2 and on `_topk`, and its race calls
  on the race and on the slot loop, equal bit for bit and timed;
- the differentiable surface path: `render_lambert_surface_mega` on the
  bench scene at 512x512 (B1 + B2 under autograd) against the same
  computation on the plain versions and against the wavefront
  `render_lambert_surface`, and 20 Adam steps of its palette fit.
- the differentiable march D2 / D3 (`csrc/diff.cu`): against the plain
  march (`ops/diff.py`) on workload 4's input (262,144 plane rays, 64^3
  blob, 128 steps), inverse_128's step (131,072 ring rays, 128^3, 192
  steps), the edge rays (+-0 and NaN directions, misses), a z-slab with
  shifted origins, sigma with zeros and albedo with negative entries,
  and the wavefront trainer's first batch (inverse_128's rays drawn at
  random), each timed and bounded: D2 on the float4 record and on the
  plain grids, D3 beside its glue (the zeroed gradient record, the
  unpack), the record's pack kernel against torch's copy,
  D2 and D3 beside the parent design (the first D2 / D3, built from
  `tools/torch_diff_trials.py`); then the main path, the wavefront
  `Trainer.fit` at inverse_128's width (one pack a step), its step split
  by kernel and glue and its peak memory, beside the same step on the
  plain march;
- the parallel layer at inverse_128_32views' width on the wavefront
  march (D2 / D3): `Trainer.fit` on one device and under an NCCL world of one
  (`make_train_step`); the worker (`python -m
  voxel_tracer_tpu_torch.parallel.worker`) as two processes on the one
  card over gloo: the ray-sharded step, overlap_slabs 4 against 1, the
  grid-sharded step (each rank a 64x128x128 slab) against the
  ray-sharded one, the grid-sharded trace of a 128^3 volume at
  1280x768, and `sharded_render` of the glass box at 320x192 against the
  unsharded frame (two ranks on one card measure no interconnect);
- the `render_vox` example on a .vox file of the glass-box stand-in at
  640x384: flat, lambert and full with --fast (B1; B1 + B2; B1 + B2),
  each against the same frame through the kernels' plain versions and
  its hit mask against the wavefront frame's;
- the port's benchmark suite (`python -m voxel_tracer_tpu_torch.bench`
  with 1 round and 1 profiled frame, every workload in one process):
  exit code 0 and 15 lines, each held to its plain version and correct.

Each main path runs with the launch counts set to 0 just before it and
read just after.  It prints one line per check, the seconds each phase
took (`[phases]`), then the card's name and
power limit as nvidia-smi reports them, then

    {"kernels": [{"name", "route", "source", "replaces", "launches",
                  "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
                  "bound_by", "library_ms"}, ...]}

and, as the last line, {"ok": true, "device": {...}}.  `ms` is CUDA-event
time per call over serialized calls, host work of the wrapper included;
`device_ms` the kernel's own span per launch in a device-only profiler
window (`utils.timer.device_window`; null where it shows no device
events).  `bound_ms` is the
larger of the bytes the call must move over 3.35 TB/s and its FP32
operations (counted from this run's data, per-unit counts read off the
kernel sources) over 67 TFLOP/s, the H100 SXM's published peaks.  The
mega, integrate, coherent and indep rows also carry `differential_ms`
(per-call time from two call counts); B5 carries its numbers on the
crate frame's shadow list, the random rays, the bench frame's primary and
shadow lists and the turned volume's rays (`crate_shadow`, `random`,
`bench_primary`, `bench_shadow`, `turned_volume`; its own row is the
crate frame's primary list), the bench frames' launches
(`bench_launches`) and B4 on the bench primary list
(`indep_rays_bench_primary`, a yardstick); B3 carries the 128^3 frame's
numbers (`grid_128`), B4 the long sparse volume's (`budget_rays`); B2 its
numbers on the lit frame's shadow-ray list (`lit_shadow_rays`) and in the
Whitted frame (`whitted`: B2 and B1 launches of the main path's frame,
B2's device ms per launch, the frame's ms compacted and not, device busy
ms and idle share, and its ray lists replayed: `lists_ms`,
`lists_device_ms`, `lists_plain_ms`, `lists_bound_ms`: per list the
rays, the bitmap, and the occupancy words and material bytes the list can
touch, `list_bound_bytes`) and in the default scene's frame (`multi`: the
same, host syncs a frame, us per O(1) edit, and game_demo's numbers under
`game`); D1 (`dda`) its 1 M random rays as its own numbers and the
parent design's device ms on them (`parent_device_ms`), every list under
`lists`, the in-place edits under `edits` and the two frames under
`exact_whitted` and `wavefront` (ms, device busy, kernels, host syncs,
D1 launches and device ms a frame, the plain frame's ms, D1's bound
summed over the frame's calls, and the frame's D1 calls replayed on D1
and on the parent design: `replay_device_ms`, `parent_replay_device_ms`);
C1 (`composite_local`, `composite_record`) its launches on the wavefront
frame, device ms a launch and a frame, and its bytes bound from that
frame's rays (`bound_ms` a launch, `bound_ms_per_frame`; no `ms` or
`plain_ms`: the glue it replaced is timed in the frame alone); C2
(`composite_topk`) its launches on the default scene's wavefront frame
and its numbers at that frame's largest prepass call (`rays`, `k`,
`objects`), and over the frame's calls (`device_ms_per_frame`,
`plain_ms_per_frame`, `bound_ms_per_frame`; the bytes bound: 24 B read
and 8 K written a ray); the race (`dda_race`) the same on that frame's
race calls, at the call that walks the most slots, its `plain_ms` the
slot loop's, its bound D1's over the slots it walks (each a D1 ray with
an object index and a per-ray vpu, and its steps), and the frame's slot
rows, walked rows and walked steps;
D2 and D3 (`diff_fwd`, `diff_bwd`) their numbers on inverse_128's step,
each [march] input under `inputs` (D2 also `with_pack_device_ms` and
`grids`, D2 on the plain grids; D3 `whole_device_ms`, its glue included;
both `parent_device_ms`), `grad_err_rel`, and the `Trainer.fit` step on
them and on the plain march (`trainer_fit`, `trainer_fit_plain`: ms,
busy, idle, kernels and host syncs a step; `kernel_ms` by label,
`glue_ms` and `peak_mem_bytes`); the record's pack (`diff_pack`) its
numbers on inverse_128's grid and under `grids` on each input's,
torch's copy as the plain version and torch.cat as the library call;
B1 and B2 their `render_vox` launches and
kernel-vs-plain error (`render_vox`); B1 its numbers on the surface path
(`surface`: launches, colour
and gradient against the plain versions on the bench grid and a
palette-varied copy, ms per Adam step on each); B6 and B7
`dup_warp_step_share` (share of warp-steps in which
two of 32 consecutive rays meet one voxel, counted by the plain march) at
training shapes, and the same numbers on diff_lambert_512.  Serialized
calls find their tables warm in L2, as the trainer's backward finds the
forward's.
Any failed check raises, and the script exits non-zero without printing a
result; so does a machine without a CUDA device, or a directory without
the repository.

Run from the repository root:  python3 chip_smoke.py
"""

import contextlib
import functools
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

# the suite's timing, scenes and the tolerances of kernel vs plain version
# (hits, materials, axes and steps equal; depth T_ATOL; image LSB;
# integrate INT_ATOL and GRAD_RTOL x max|g|): one definition each
from voxel_tracer_tpu_torch.bench.measure import (SLOPE_RTOL, alternating_rounds,
                                                  count_host_syncs, cuda_ms, nvidia_smi)
from voxel_tracer_tpu_torch.bench.workloads import (
    FRAME_TOL, GRAD_RTOL, HIT_MISMATCH_BUDGET, INT_ATOL, LSB, SF_COLOR_ATOL, SF_GRAD_RTOL,
    SUN, T_ATOL, T_EPS, WH_SHADOW_ROUNDS, bench_camera, build_multi, diff_scene, multi_camera,
    multi_scene, whitted_launches)
from voxel_tracer_tpu_torch.bench.workloads import multi_config as _multi_config
from voxel_tracer_tpu_torch.bench.workloads import whitted_config as _whitted_config
# busy time: the union of the kernels' spans in a device-only profiler window
from voxel_tracer_tpu_torch.utils.timer import device_busy, device_window

ROOT = os.path.dirname(os.path.abspath(__file__))
W, H = 1920, 1088
N_RAYS = 1 << 20
# render_density_slabs(n_slabs=2) vs render_density_mega (the CPU tests')
SLAB_ATOL = 5e-5
SLAB_GRAD_RTOL = 5e-3
FD_RTOL = 0.05      # central difference vs the kernel gradient
TRAIN_G, TRAIN_VIEWS, TRAIN_PX, TRAIN_VPU = 128, 32, 64, 20.0

# bounds: H100 SXM published peaks (HBM3 rate, FP32 non-tensor rate)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
# FP32 operations per unit of work, counted off the kernel sources
MEGA_OPS_PER_RAY = 80           # slab test 38, DDA set-up 41 (mega.cu)
MEGA_OPS_PER_STEP = 8           # compares and add of a step 4, brick entry 28 amortized
INT_OPS_PER_RAY = 65            # slab test, signs, first brick (diffint.cu)
INT_OPS_PER_BRICK_STEP = 38     # brick planes, [tn, tf], exit axis
INT_OPS_PER_VISIT = 43          # fine entry of an occupied brick
INT_OPS_PER_FINE_STEP = {"fwd": 29, "bwd": 60}
COH_BYTES_PER_RAY = 41          # o, d read; t, vox, ax, steps and a bool written
COH_OPS_PER_RAY = 70            # slab test, signs, first brick (coherent.cu)
COH_OPS_PER_BRICK_STEP = 50     # brick-AABB slab test, crossing rule, exit step
COH_OPS_PER_VISIT = 35          # fine entry of an occupied brick (brick_walk.cuh)
FINE_OPS_PER_STEP = 16          # one fine DDA step (brick_walk.cuh)
IND_OPS_PER_RAY = 80            # slab test, signs, brick DDA set-up (indep.cu)
IND_OPS_PER_BRICK_STEP = 14     # bitmap test, one brick A&W step
IND_OPS_PER_VISIT = 40          # enter, brick corner, fine entry
CAM_OPS_PER_PIXEL = 60          # raygen and shading tail (frame.cuh)


def log(msg):
    print(msg, flush=True)


@functools.lru_cache(maxsize=None)
def parent_design(tool):
    """(the trial tool ``tool`` of tools/, the library of its parent
    variant): the design a redesigned kernel replaced, built beside the
    committed one for a comparison in the same run."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(tool, os.path.join(ROOT, "tools",
                                                                     f"{tool}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    lib, ptxas = mod.build_variants(["parent"])["parent"]
    for line in ptxas:
        log(f"[build] {tool} parent: {line}")
    return mod, lib


PHASE_S = {}   # seconds spent in each phase function, summed over its calls


def timed_phase(fn):
    """Adds the wall time of each call of ``fn`` to PHASE_S[fn's name]."""
    @functools.wraps(fn)
    def run(*args, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kw)
        finally:
            name = fn.__name__[len("phase_"):]
            PHASE_S[name] = PHASE_S.get(name, 0.0) + time.perf_counter() - t0
    return run


def require(cond, what):
    if not cond:
        raise AssertionError(what)


def bound(nbytes, ops):
    """(least ms, what bounds it) for moving nbytes and doing ops FP32
    operations at the card's published peaks."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FP32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare_frames(tag, k, p):
    """k/p: (rgba, t, aux) of the kernel and the plain version."""
    from voxel_tracer_tpu_torch.ops.cuda import mega
    (rk, tk, ak), (rp, tp, ap) = k, p
    hk, hp = tk < mega.BIG, tp < mega.BIG
    flips = int((hk != hp).sum())
    both = hk & hp
    lsb = int((mega._unpack_rgb8(rk) - mega._unpack_rgb8(rp)).abs().max())
    dt = float((tk[both] - tp[both]).abs().max()) if bool(both.any()) else 0.0
    aux_eq = int((ak == ap).sum())
    log(f"[{tag}] hit-mask mismatches {flips} (budget {HIT_MISMATCH_BUDGET}), "
        f"image max diff {lsb} LSB, depth max |d| {dt:.3g}, "
        f"aux equal {aux_eq}/{ak.numel()}, hit fraction {float(hk.float().mean()):.4f}")
    require(flips <= HIT_MISMATCH_BUDGET, f"{tag}: {flips} hit-mask mismatches")
    require(lsb <= LSB, f"{tag}: image differs by {lsb} LSB")
    require(dt <= T_ATOL, f"{tag}: depth differs by {dt}")
    require(aux_eq == ak.numel(), f"{tag}: mat/axis/steps/resolved differ")
    return dt


@timed_phase
def phase_build():
    from voxel_tracer_tpu_torch.ops.cuda import _build
    t0 = time.perf_counter()
    logs = _build.build()
    dt = time.perf_counter() - t0
    for name, text in logs.items():
        for line in text.splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    log(f"[build] {len(logs)} of {len(list(_build.CSRC.glob('*.cu')))} "
        f"sources compiled in {dt:.1f} s into {_build.BUILD_DIR}")
    # B5's entry functions keep their walk in registers
    frames = [ln.strip() for ln in logs.get("coherent", "").splitlines()
              if "bytes stack frame" in ln]
    require(all(re.match(r"0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
                         ln) for ln in frames), f"B5 uses local memory: {frames}")
    # D2 (both templates), D3 and the record's pack spill nothing, nor do C1 and C2
    for name in ("diff", "composite"):
        frames = [ln.strip() for ln in logs.get(name, "").splitlines()
                  if "bytes stack frame" in ln]
        require(all("0 bytes spill stores, 0 bytes spill loads" in ln for ln in frames),
                f"{name}.cu's kernels spill: {frames}")


@timed_phase
def phase_main_path(mv):
    """The user-facing path, with every launch counter at 0 before it."""
    from voxel_tracer_tpu_torch.ops.cuda import mega
    cam = bench_camera(0.0, W / H)
    mega.reset_launch_counts()
    flat = mega.render_mega(mv, cam, W, H, sun_dir=SUN)
    lit = mega.render_lambert_mega(mv, cam, W, H, sun_dir=SUN)
    torch.cuda.synchronize()
    launches = dict(mega.KERNEL_LAUNCHES)
    log(f"[main path] render_mega + render_lambert_mega at {W}x{H}: "
        f"launches {launches}")
    for name, n in launches.items():
        require(n > 0, f"kernel {name} was not launched on the main path")
    hit = flat["depth"] < mega.BIG
    frac = float(hit.float().mean())
    require(flat["image"].shape == (H, W, 3) and flat["image"].dtype == torch.uint8,
            "flat image shape/dtype")
    require(0.05 < frac < 0.99, f"flat hit fraction {frac}")
    require(bool(torch.isfinite(flat["depth"][hit]).all()), "non-finite depth")
    require(bool((flat["resolved"] == 1).all()), "unresolved rays in the frame")
    require(bool((flat["steps"][hit] >= 0).all()), "negative steps")
    lhit = lit["depth"] < mega.BIG
    require(bool(torch.equal(lhit, hit)), "flat and lit hit masks differ")
    n = lit["normal"][lhit]
    require(bool(torch.allclose(n.norm(dim=-1), torch.ones_like(n[:, 0]), atol=1e-6)),
            "normals are not unit length")
    require(bool(torch.isfinite(lit["irradiance"]).all()), "non-finite irradiance")
    lit_frac = float((lit["irradiance"][lhit][:, 0] > 0.2 + 1e-6).float().mean())
    log(f"[main path] hit fraction {frac:.4f}, mean steps on hits "
        f"{float(flat['steps'][hit].float().mean()):.2f}, "
        f"sunlit share of hits {lit_frac:.4f}")
    require(0.0 < lit_frac < 1.0, "lit frame is all shadow or all sun")
    return launches, int(flat["steps"].sum())


@timed_phase
def phase_small_reference():
    """Kernel on the card vs the plain version on the CPU (which the CPU
    tests hold against the JAX package) on a small scene."""
    from voxel_tracer_tpu_torch.models.camera import Camera
    from voxel_tracer_tpu_torch.models.volume import VoxelVolume
    from voxel_tracer_tpu_torch.ops.cuda import mega
    n = 16
    z, y, x = np.meshgrid(*[np.arange(n)] * 3, indexing="ij")
    c = (n - 1) / 2
    dist = np.sqrt((x - c) ** 2 + (y - c) ** 2 + (z - c) ** 2)
    grid = np.where(dist < 0.42 * n, np.where(y > c, 140, 23), 0).astype(np.uint8)
    pal = np.random.RandomState(3).rand(256, 3).astype(np.float32)
    vol = VoxelVolume(grid, palette=pal, pos=(0.1, -0.05, 0.2), vpu=20.0)
    cam = Camera.create((1.2, 0.9, -1.4), (0.1, -0.05, 0.2), 2.0)
    worst = 0.0
    for shading in ("flat", "lambert"):
        outs = [mega.render_mega(mega.MegaVolume(vol, dev), cam, 64, 32,
                                 shading=shading)
                for dev in ("cuda", "cpu")]
        k = {kk: v.cpu() for kk, v in outs[0].items()}
        p = outs[1]
        hk, hp = k["depth"] < mega.BIG, p["depth"] < mega.BIG
        lsb = int((k["image"].int() - p["image"].int()).abs().max())
        dt = float((k["depth"][hk & hp] - p["depth"][hk & hp]).abs().max())
        log(f"[small {shading}] 64x32 sphere, card kernel vs CPU plain: "
            f"hit mismatches {int((hk != hp).sum())}, image {lsb} LSB, "
            f"depth {dt:.3g}")
        require(bool(torch.equal(hk, hp)), "small scene hit masks differ")
        require(lsb <= LSB and dt <= T_ATOL, "small scene differs")
        require(bool(torch.equal(k["mat"], p["mat"])
                     and torch.equal(k["steps"], p["steps"])),
                "small scene mat/steps differ")
        worst = max(worst, dt)
    return worst


def random_rays():
    """N_RAYS random local rays around the bench volume, 1/64 of them
    axis-parallel (on the card)."""
    rng = np.random.RandomState(0)
    o = rng.uniform(-1.0, 4.2, (N_RAYS, 3)).astype(np.float32)  # volume: [0, 3.2]^3
    d = rng.randn(N_RAYS, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    # 1/64 axis-parallel rays whose zero components carry random signs
    k = N_RAYS // 64
    axis = rng.randint(0, 3, k)
    zeros = np.where(rng.rand(k, 3) < 0.5, -0.0, 0.0).astype(np.float32)
    zeros[np.arange(k), axis] = np.where(rng.rand(k) < 0.5, -1.0, 1.0)
    d[:k] = zeros
    return torch.from_numpy(o).cuda(), torch.from_numpy(d).cuda()


def compare_mega_traces(tag, tables, o_t, d_t, fetch_mat):
    """B2 against its plain version on one ray list (`compare_traces`).
    Returns (kernel outputs, max |dt|)."""
    from voxel_tracer_tpu_torch.ops.cuda import mega
    kr = mega.trace_rays(o_t, d_t, tables, fetch_mat=fetch_mat)
    pr = mega.trace_rays_plain(o_t, d_t, tables, fetch_mat=fetch_mat)
    torch.cuda.synchronize()
    return kr, compare_traces(tag, kr, pr)


def mega_bound(n, per_ray_bytes, tb, steps, camera):
    """Rays (or camera floats and pixels) read / written once, the tables
    read once; operations per ray (and pixel) and per DDA step."""
    nbytes = (n * per_ray_bytes + tb.bitmap.numel() * 4 + tb.occw.numel() * 4
              + tb.matb.numel() + (tb.pal.numel() * 4 + 29 * 4 if camera else 0))
    ops = (n * (MEGA_OPS_PER_RAY + (CAM_OPS_PER_PIXEL if camera else 0))
           + steps * MEGA_OPS_PER_STEP)
    return nbytes, bound(nbytes, ops)


@timed_phase
def phase_trace_rays(tag, mv, o_t, d_t, fetch_mat):
    """[trace_rays ...] B2 on one ray list: held against its plain
    version, timed, bounded; DDA steps a second from the device time."""
    from voxel_tracer_tpu_torch.ops.cuda import mega
    kr, dt = compare_mega_traces(tag, mv.tables, o_t, d_t, fetch_mat)
    n, steps = o_t.shape[0], int(kr["steps"].sum())
    nbytes, b = mega_bound(n, 24 + 8, mv.tables, steps, False)
    t = time_kernel(tag, lambda: mega.trace_rays(o_t, d_t, mv.tables, fetch_mat=fetch_mat),
                    lambda: mega.trace_rays_plain(o_t, d_t, mv.tables, fetch_mat=fetch_mat),
                    (10, 40), "mega_rays_kernel", n, b)
    per_s = "not measured" if t["dev_ms"] is None else f"{steps / t['dev_ms'] * 1e3:.4g}"
    log(f"[{tag}] {nbytes} bytes, {steps} DDA steps ({steps / n:.2f} a ray), "
        f"{per_s} DDA steps/s (device time)")
    return dict(t, err=dt, steps=steps)


def lit_shadow_rays(mv, cam):
    """The volume-local shadow-ray list that the lit frame hands B2,
    captured from `render_lambert_mega`'s own shadow pass."""
    from voxel_tracer_tpu_torch.ops.cuda import mega
    lists = []

    def capture(o, d, tables):
        lists.append((o, d))
        return mega.trace_rays(o, d, tables)
    mega._lambert_frame(mv, cam, W, H, SUN, None, 0.2, mega.render_mega_tiles, capture)
    return lists[0]


@timed_phase
def phase_budget():
    """[budget] B2 on the long sparse volume of `profiling.budget_scene`:
    65,536 rays, most of which run out of the 256-step budget; at 4096
    voxels (2048 bricks) and at 65,600 (32,800 bricks, a 1025-word
    bitmap)."""
    from voxel_tracer_tpu_torch.ops.cuda import mega
    from voxel_tracer_tpu_torch.utils import profiling
    err = 0.0
    for length in (4096, 65600):
        g, o, d, vpu = profiling.budget_scene(length=length, n_rays=65536)
        tb = mega.pack_tables(g, np.ones((256, 3), np.float32), vpu, "cuda")
        tag = f"budget {length} voxels"
        kr, dt = compare_mega_traces(tag, tb, torch.from_numpy(o).cuda(),
                                     torch.from_numpy(d).cuda(), True)
        exhausted = int((~kr["resolved"]).sum())
        hits = int((kr["t"] < mega.BIG).sum())
        log(f"[{tag}] {int(tb.bocc.sum())} of {tb.bocc.numel()} bricks occupied, "
            f"{tb.bitmap.numel()}-word bitmap; {exhausted} rays exhausted the "
            f"{int(kr['steps'].max())}-step budget, {hits} hit")
        require(exhausted > 0 and hits > 0, f"{tag}: {exhausted} exhausted, {hits} hits")
        err = max(err, dt)
    return err


@timed_phase
def phase_large_grid():
    """[large grid] B1 on a 256^3 noise volume (32,768 bricks, a 1024-word
    bitmap) against the plain version, and its device time."""
    from voxel_tracer_tpu_torch.models.volume import VoxelVolume
    from voxel_tracer_tpu_torch.ops.cuda import mega
    t0 = time.perf_counter()
    big = VoxelVolume.noise_filled((256, 256, 256), pos=(0, 0, 0), vpu=80.0)
    mv = mega.MegaVolume(big, device="cuda")
    log(f"[large grid] 256^3 noise volume built and packed in "
        f"{time.perf_counter() - t0:.1f} s")
    cam = bench_camera(0.0, W / H)
    err = phase_flat("large grid", mv, cam)
    cam_p = mega.mega_camera(mv, cam, SUN, W, H)
    dev = kernel_device_ms(lambda: mega.render_mega_tiles(cam_p, mv.tables, width=W,
                                                          height=H), 16, "mega_camera_kernel")
    log(f"[large grid] device time per launch "
        f"{'not measured' if dev is None else f'{dev:.4f} ms'}")
    return err


@timed_phase
def phase_flat(tag, mv, cam):
    from voxel_tracer_tpu_torch.ops.cuda import mega
    cam_p = mega.mega_camera(mv, cam, SUN, W, H)
    k = mega.render_mega_tiles(cam_p, mv.tables, width=W, height=H)
    p = mega.render_mega_tiles_plain(cam_p, mv.tables, width=W, height=H)
    torch.cuda.synchronize()
    return compare_frames(tag, k, p)


def compare_frame_fields(tag, k, p):
    """A flat or lambert frame dict (render_mega's, render_lambert_mega's
    or render_vox's) vs the same frame through the plain versions: hit
    masks equal, image within LSB (8-bit), depth (on the hits) and
    irradiance within T_ATOL, every other field equal."""
    hk, hp = k["depth"] < 1e29, p["depth"] < 1e29
    flips = int((hk != hp).sum())
    both = hk & hp
    diffs = {}
    for f in k:
        a, b = (k[f][both], p[f][both]) if f == "depth" else (k[f], p[f])
        d = float((a.double() - b.double()).abs().max()) if a.numel() else 0.0
        diffs[f] = d * 255 if f == "image" and a.is_floating_point() else d
    log(f"[{tag}] kernel vs plain: hit-mask mismatches {flips} (budget "
        f"{HIT_MISMATCH_BUDGET}), max |d| per field {diffs} (image in LSB)")
    require(flips <= HIT_MISMATCH_BUDGET, f"{tag}: {flips} hit-mask mismatches")
    for f, d in diffs.items():
        require(d <= FRAME_TOL.get(f, 0.0), f"{tag}: {f} differs by {d}")
    return diffs["depth"]


@timed_phase
def phase_lit(mv):
    from voxel_tracer_tpu_torch.ops.cuda import mega
    cam = bench_camera(0.0, W / H)
    k = mega.render_lambert_mega(mv, cam, W, H, sun_dir=SUN)
    p = mega.render_lambert_mega_plain(mv, cam, W, H, sun_dir=SUN)
    torch.cuda.synchronize()
    return compare_frame_fields(f"lit frame {W}x{H}", k, p)


@timed_phase
def phase_timing(mv):
    """Flat and lit frames over orbit cameras, serialized on one stream,
    timed with CUDA events at two frame counts each: the camera kernel
    alone on precomputed camera floats and its plain version, then the
    entry points end to end (host camera set-up and output unpacking
    included)."""
    from voxel_tracer_tpu_torch.ops.cuda import mega
    n_cams = 64
    cameras = [bench_camera(0.01 * i, W / H) for i in range(n_cams)]
    cams = torch.stack([mega.mega_camera(mv, c, SUN, W, H) for c in cameras])

    def flat(fn):
        return lambda i: fn(cams[i % n_cams], mv.tables, width=W, height=H)

    def entry(fn):
        return lambda i: fn(mv, cameras[i % n_cams], W, H, sun_dir=SUN)

    out = {}
    for name, frame, counts, kernel in (
            ("flat kernel", flat(mega.render_mega_tiles), (16, 64), True),
            ("flat plain", flat(mega.render_mega_tiles_plain), (2, 4), False),
            ("flat render_mega", entry(mega.render_mega), (16, 64), True),
            ("lit kernel", entry(mega.render_lambert_mega), (8, 32), True),
            ("lit plain", entry(mega.render_lambert_mega_plain), (1, 2), False)):
        frame(0)                                    # warm-up
        before = dict(mega.KERNEL_LAUNCHES)
        ms = [cuda_ms(frame, c) for c in counts]
        launched = {k: v - before[k] for k, v in mega.KERNEL_LAUNCHES.items()}
        slope = (ms[1] * counts[1] - ms[0] * counts[0]) / (counts[1] - counts[0])
        agree = abs(slope - ms[1]) <= SLOPE_RTOL * ms[1]
        log(f"[timing] {name}: {ms[0]:.4f} ms/frame over {counts[0]} frames, "
            f"{ms[1]:.4f} over {counts[1]}; differential {slope:.4f} ms/frame, "
            f"{'agrees' if agree else 'does NOT agree'} within {SLOPE_RTOL:.0%}; "
            f"{W * H / ms[1] * 1e3:.4g} primary rays/s; launches {launched}")
        require((launched["mega_camera"] > 0) == kernel,
                f"{name} timing launched the kernel {launched} times")
        out[name] = ms[1]
        out[f"{name} differential"] = slope
    dev_ms = kernel_device_ms(lambda: flat(mega.render_mega_tiles)(0), 16,
                              "mega_camera_kernel")
    log(f"[timing] flat kernel device time per launch "
        f"{'not measured' if dev_ms is None else f'{dev_ms:.4f} ms'}")
    out["flat kernel device"] = dev_ms
    for name, fn in (("flat render_mega", entry(mega.render_mega)),
                     ("lit render_lambert_mega", entry(mega.render_lambert_mega))):
        wall, busy, kernels = device_busy(lambda: [fn(i) for i in range(8)])
        busy_s = "not measured" if busy is None else f"{busy / 8:.4f} ms/frame"
        idle = "not measured" if busy is None else f"{1.0 - busy / wall:.4f}"
        log(f"[timing] {name} profiled 8 frames: wall {wall / 8:.4f} ms/frame, "
            f"device busy {busy_s} in {kernels / 8:.1f} kernels/frame, idle share {idle}")
    return out


# ---------------------------------------------------------------------------
# Training slice: the integrate kernels B6 / B7 and Trainer.fit
# ---------------------------------------------------------------------------

def _packed(sigma, albedo):
    from voxel_tracer_tpu_torch.ops.cuda import diffint
    rec = diffint.pack_records(sigma.detach(), albedo.detach())
    return rec, diffint.occ_words(rec[:, 0]), diffint.brick_dims(sigma.shape)


def _maxabs(t):
    return float(t.abs().max()) if t.numel() else 0.0


def _int_bytes(n, rec, mode):
    """Bytes each integrate call must move: rays, carry (and cotangents and
    totals) read once, the record table read once, the outputs (the
    gradient records) written once."""
    per_ray = 24 + 20 + (24 if mode == "fwd" else 40)
    table_bytes = rec.numel() * 4
    return n * per_ray + table_bytes * (1 if mode == "fwd" else 2)


def _int_ops(n, stats, mode):
    return (n * INT_OPS_PER_RAY + stats["brick_steps"] * INT_OPS_PER_BRICK_STEP
            + stats["brick_visits"] * INT_OPS_PER_VISIT
            + stats["fine_steps"] * INT_OPS_PER_FINE_STEP[mode])


def integrate_pair(tag, sigma, albedo, o, d, vpu, target, counts):
    """B6 and B7 against their plain versions on the same inputs (the
    cotangents of mean((color - target)^2)), timed both; returns errors,
    times, bounds and the march's work, with the share of warp-steps in
    which two lanes of a warp (32 consecutive rays) meet one voxel."""
    from voxel_tracer_tpu_torch.ops.cuda import diffint
    rec, occ, bsize = _packed(sigma, albedo)
    n = o.shape[0]
    carry = diffint._init_carry(n, o.device)
    kw = dict(bsize=bsize, vpu=vpu, t_eps=T_EPS)
    k = diffint.integrate_fwd_records(0, occ, o, d, carry, rec, **kw)
    stats = {}
    p = diffint.integrate_fwd_plain(0, occ, o, d, carry, rec, stats=stats, **kw)
    torch.cuda.synchronize()
    require(bool(torch.equal(k[5], p[5])), f"{tag}: flags differ")
    err_f = max(float((a - b).abs().max()) for a, b in zip(k[:5], p[:5]))
    marched = float((k[5] == 2).float().mean())
    dup = stats["dup_warp_steps"] / stats["warp_steps"]
    log(f"[{tag} fwd] {n} rays, {bsize} bricks: kernel vs plain max |d| "
        f"{err_f:.3g} (limit {INT_ATOL}), flags equal, marched {marched:.4f}")
    log(f"[{tag} work] {n} rays, {stats['brick_steps']} brick steps, "
        f"{stats['brick_visits']} brick visits, {stats['fine_steps']} fine steps "
        f"({stats['fine_steps'] / n:.1f} a ray); {stats['warp_steps']} warp-steps, "
        f"{stats['dup_warp_steps']} with two lanes on one voxel (share {dup:.4f}), "
        f"{stats['dup_lanes']} lane updates a warp aggregation would merge "
        f"(share of fine steps {stats['dup_lanes'] / stats['fine_steps']:.4f})")
    require(err_f <= INT_ATOL, f"{tag}: forward differs by {err_f}")
    require(bool(torch.isfinite(k[0]).all() and torch.isfinite(k[4]).all()),
            f"{tag}: non-finite forward")

    color = torch.stack(k[:3], dim=-1)
    g_color = 2.0 * (color - target) / color.numel()
    zero = torch.zeros(n, device=o.device)
    cts = tuple(g_color[:, i].contiguous() for i in range(3)) + (zero, zero)
    kb = diffint.integrate_bwd_records(0, occ, o, d, carry, rec, cts, k[:5], **kw)
    pb = diffint.integrate_bwd_plain(0, occ, o, d, carry, rec, cts, k[:5], **kw)
    torch.cuda.synchronize()
    nbk = rec.shape[0] // 512
    empty_brick = ((occ[:, None] >> torch.arange(32, device=occ.device)) & 1
                   ).reshape(-1)[:nbk] == 0
    err_b, rel_b = 0.0, 0.0
    for c, name in enumerate(("d_sigma", "d_albedo_r", "d_albedo_g", "d_albedo_b")):
        a, b = kb[:, c], pb[:, c]
        scale = float(b.abs().max())
        e = float((a - b).abs().max())
        err_b, rel_b = max(err_b, e), max(rel_b, e / max(scale, 1e-30))
        require(scale > 0.0, f"{tag}: {name} is all zero")
        require(e <= GRAD_RTOL * scale, f"{tag}: {name} differs by {e} (max|g| {scale})")
        require(_maxabs(a.reshape(nbk, 512)[empty_brick]) == 0.0,
                f"{tag}: kernel {name} nonzero in an empty brick")
        require(_maxabs(b.reshape(nbk, 512)[empty_brick]) == 0.0,
                f"{tag}: plain {name} nonzero in an empty brick")
    require(_maxabs(kb[:, 0][rec[:, 0] == 0.0]) == 0.0,
            f"{tag}: d_sigma nonzero where sigma is 0")
    log(f"[{tag} bwd] kernel vs plain max |d| {err_b:.3g}, {rel_b:.3g} x max|g| "
        f"(limit {GRAD_RTOL}); {int(empty_brick.sum())} empty bricks exactly 0")

    out = dict(err_fwd=err_f, err_bwd=err_b, stats=stats, n=n, dup=dup)
    for mode, fn_k, fn_p, args in (
            ("fwd", diffint.integrate_fwd_records, diffint.integrate_fwd_plain,
             (0, occ, o, d, carry, rec)),
            ("bwd", diffint.integrate_bwd_records, diffint.integrate_bwd_plain,
             (0, occ, o, d, carry, rec, cts, k[:5]))):
        t = time_kernel(f"{tag} {mode}", lambda: fn_k(*args, **kw),
                        lambda: fn_p(*args, **kw), counts, "integrate_kernel", n,
                        bound(_int_bytes(n, rec, mode), _int_ops(n, stats, mode)))
        per_s = [stats["fine_steps"] / x * 1e3 for x in (t["ms"], t["dev_ms"])
                 if x is not None]
        log(f"[{tag} {mode}] {' / '.join(f'{x:.4g}' for x in per_s)} fine steps/s "
            f"(event / device time)")
        out[mode] = t
    return out


@timed_phase
def phase_diffint(scene):
    """[diffint fwd] + [diffint bwd]: the diff_lambert_512 scene."""
    return integrate_pair("diffint", scene["sigma"], scene["albedo"], scene["o"],
                          scene["d"], scene["vpu"], scene["target"], (20, 80))


@timed_phase
def phase_finite_difference(scene):
    """Central difference of sum(color) at the voxel of largest |d/d sigma|,
    through render_density_mega on the card (launches B6 and B7)."""
    from voxel_tracer_tpu_torch.ops.cuda import diffint
    a, o, d = scene["albedo"], scene["o"], scene["d"]

    def loss(s):
        return diffint.render_density_mega(s, a, o, d, scene["vpu"],
                                           t_eps=T_EPS)["color"].double().sum()

    s = scene["sigma"].clone().requires_grad_()
    loss(s).backward()
    g = s.grad
    idx = int(g.abs().argmax())
    # stay on one side of the clamp at sigma = 0
    eps = min(1e-2, 0.5 * float(scene["sigma"].view(-1)[idx]))
    with torch.no_grad():
        sp, sm = scene["sigma"].clone(), scene["sigma"].clone()
        sp.view(-1)[idx] += eps
        sm.view(-1)[idx] -= eps
        fd = (float(loss(sp)) - float(loss(sm))) / (2 * eps)
    gi = float(g.view(-1)[idx])
    log(f"[diffint fd] voxel {idx}, eps {eps:.3g}: kernel grad {gi:.6g}, "
        f"central difference {fd:.6g} (limit {FD_RTOL:.0%})")
    require(abs(fd - gi) < FD_RTOL * max(abs(fd), abs(gi), 1e-6),
            "finite difference disagrees with the kernel gradient")


@timed_phase
def phase_slabs(scene):
    """[slabs] render_density_slabs(n_slabs=2) vs render_density_mega on the
    card: forward and gradients of mean((color - target)^2)."""
    from voxel_tracer_tpu_torch.ops.cuda import diffint
    outs, grads = [], []
    for fn, args in ((diffint.render_density_mega, ()),
                     (diffint.render_density_slabs, (2,))):
        s = scene["sigma"].clone().requires_grad_()
        a = scene["albedo"].clone().requires_grad_()
        out = fn(s, a, scene["o"], scene["d"], scene["vpu"], *args, t_eps=T_EPS)
        ((out["color"] - scene["target"]) ** 2).mean().backward()
        outs.append(out)
        grads.append((s.grad, a.grad))
    torch.cuda.synchronize()
    e_out = max(float((outs[0][k] - outs[1][k]).detach().abs().max())
                for k in ("color", "trans", "depth"))
    e_grad = max(float((gm - gs).abs().max()) / float(gm.abs().max())
                 for gm, gs in zip(*grads))
    log(f"[slabs] 2 slabs vs one call: outputs max |d| {e_out:.3g} (limit "
        f"{SLAB_ATOL}), grads {e_grad:.3g} x max|g| (limit {SLAB_GRAD_RTOL})")
    require(e_out <= SLAB_ATOL, "slab outputs differ")
    require(e_grad <= SLAB_GRAD_RTOL, "slab gradients differ")


def kernel_device_ms(fn, reps, name):
    """Mean device time of the kernels whose name contains ``name`` over
    ``reps`` calls of fn(), from the profiler's kernel spans
    (`utils.timer.device_window`); a window that shows none of them is
    profiled again, up to 3 windows (None if none shows device events)."""
    for _ in range(3):
        _wall, events = device_window(lambda: [fn() for _ in range(reps)])
        spans = [b - a for n, a, b in events if name in n]
        if spans:
            return sum(spans) / len(spans) / 1e3
    return None


@timed_phase
def phase_train():
    """[train] The training main path: Trainer.fit, kernel backend, at the
    width of inverse_128_32views, on targets rendered by the kernel forward
    of a known field.  Launch counts at 0 just before, read just after."""
    from voxel_tracer_tpu_torch.ops.cuda import diffint
    from voxel_tracer_tpu_torch.trainer import TrainConfig, Trainer
    from voxel_tracer_tpu_torch.utils.profiling import blob_field, ring_views
    # inverse_128_32views (bench_suite.py:480-506): 32 ring views of 64x64
    o, d = ring_views(TRAIN_G, TRAIN_VIEWS, TRAIN_PX, TRAIN_VPU)
    n = o.shape[0]
    true_s, true_a = (torch.from_numpy(x).cuda() for x in blob_field(TRAIN_G, 1, 40.0, 0.25))
    with torch.no_grad():
        c = diffint.render_density_mega(true_s, true_a, torch.from_numpy(o).cuda(),
                                        torch.from_numpy(d).cuda(), TRAIN_VPU,
                                        t_eps=T_EPS)["color"].cpu().numpy()
    cfg = TrainConfig(grid_size=(TRAIN_G,) * 3, vpu=TRAIN_VPU, lr=1e-2, steps=4,
                      rays_per_batch=n, backend="kernel")
    tr = Trainer(cfg)
    losses = []

    def fit(extra):
        tr.cfg.steps += extra
        losses.extend(tr.fit(o, d, c, log_every=1, log_fn=lambda s: None))

    diffint.reset_launch_counts()
    fit(0)                                   # 4 steps: warm-up
    counts = (6, 12)
    ms = [cuda_ms(lambda i, k=k: fit(k), 1) / k for k in counts]
    wall, busy, kernels = device_busy(lambda: fit(3))
    torch.cuda.synchronize()
    launches = dict(diffint.KERNEL_LAUNCHES)
    slope = (ms[1] * counts[1] - ms[0] * counts[0]) / (counts[1] - counts[0])
    idle = f"{1.0 - busy / wall:.4f}" if busy is not None else "not measured"
    log(f"[train] Trainer.fit, kernel backend, {TRAIN_G}^3, {TRAIN_VIEWS} views "
        f"of {TRAIN_PX}x{TRAIN_PX}, {n} rays/step: {tr.step} steps, loss "
        f"{losses[0]:.6g} -> {losses[-1]:.6g}; launches {launches}")
    log(f"[train] {ms[0]:.4f} ms/step over {counts[0]} steps, {ms[1]:.4f} over "
        f"{counts[1]}; differential {slope:.4f} ms/step; {n / ms[1] * 1e3:.4g} rays/s; "
        f"profiled 3 steps: wall {wall:.3f} ms, device busy "
        f"{'not measured' if busy is None else f'{busy:.3f} ms'} in {kernels} "
        f"kernels, idle share {idle}")
    require(all(np.isfinite(losses)), "non-finite training loss")
    require(losses[-1] < losses[0], f"loss did not fall: {losses[0]} -> {losses[-1]}")
    for name, k in launches.items():
        require(k > 0, f"kernel {name} was not launched on the training path")
    require(bool(torch.isfinite(tr.params["sigma"]).all()), "non-finite sigma")

    # both kernels at the main path's shapes: the trained grid, all rays
    res = integrate_pair("train shapes", tr.params["sigma"].detach(),
                         tr.params["albedo"].detach(), torch.from_numpy(o).cuda(),
                         torch.from_numpy(d).cuda(), TRAIN_VPU,
                         torch.from_numpy(c).cuda(), (10, 40))
    res["launches"] = launches
    return res


# ---------------------------------------------------------------------------
# Third slice: the coherent kernel B5 (kernel renderer) and the indep
# kernels B3 / B4
# ---------------------------------------------------------------------------

def compare_traces(tag, k, p, quiet=False):
    """Ray-list outputs of a kernel and its plain version: hit mask and
    every integer field equal, t within T_ATOL; returns max |dt|.  Logs
    one line unless ``quiet``."""
    hk, hp = k["t"] < 1e30, p["t"] < 1e30
    both = hk & hp
    dt = _maxabs(k["t"][both] - p["t"][both])
    eq = {f: bool(torch.equal(k[f], p[f]))
          for f in ("vox", "mat", "ax", "steps", "resolved") if f in p}
    if not quiet:
        log(f"[{tag}] {k['t'].numel()} rays: hit mismatches {int((hk != hp).sum())}, "
            f"equal {eq}, t max |d| {dt:.3g}, hit fraction {float(hk.float().mean()):.4f}, "
            f"unresolved {int((~k['resolved']).sum())}")
    require(bool(torch.equal(hk, hp)), f"{tag}: hit masks differ")
    require(all(eq.values()), f"{tag}: fields differ: {eq}")
    require(dt <= T_ATOL, f"{tag}: t differs by {dt}")
    return dt


def check_lit(tag, lit, all_sun=False):
    """The lit frame's AOVs: shapes, finite values, unit normals, a hit
    fraction strictly between 0 and 1, a sunlit share above 0 and below 1
    (or equal to 1 where ``all_sun``)."""
    hit = lit["depth"] < 1e30
    frac = float(hit.float().mean())
    require(lit["image"].shape == (H, W, 3) and lit["image"].dtype == torch.float32,
            f"{tag}: image shape/dtype")
    require(bool(((lit["image"] >= 0) & (lit["image"] <= 1)).all()), f"{tag}: image range")
    require(0.05 < frac < 0.99, f"{tag}: hit fraction {frac}")
    require(bool(torch.isfinite(lit["depth"][hit]).all()), f"{tag}: non-finite depth")
    n = lit["normal"][hit]
    require(bool(torch.allclose(n.norm(dim=-1), torch.ones_like(n[:, 0]), atol=1e-6)),
            f"{tag}: normals are not unit length")
    require(bool(torch.isfinite(lit["irradiance"]).all()), f"{tag}: non-finite irradiance")
    sun = float((lit["irradiance"][hit][:, 0] > 0.2 + 1e-6).float().mean())
    require(0.0 < sun and (sun <= 1.0 if all_sun else sun < 1.0),
            f"{tag}: sunlit share {sun}")
    return frac, sun


def frame_rays(scene, cam, lit):
    """The primary and shadow ray lists of a one-volume render_lambert_fast
    frame, volume-local, as the frame builds them (tile order)."""
    from voxel_tracer_tpu_torch.models.camera import rays_for_image
    from voxel_tracer_tpu_torch.ops.composite import _to_local
    from voxel_tracer_tpu_torch.ops.cuda.integrate import tiles_of_image
    fv = scene.volumes[0]
    o, d = (tiles_of_image(x, H, W) for x in rays_for_image(cam, W, H))
    depth = tiles_of_image(lit["depth"].reshape(-1), H, W)
    normal = tiles_of_image(lit["normal"].reshape(-1, 3), H, W)
    p = o + d * depth[:, None] + normal * 1e-4
    lists = {"primary": _to_local(fv.rot, fv.pos, fv.pivot, o, d),
             "shadow": _to_local(fv.rot, fv.pos, fv.pivot, p,
                                 torch.broadcast_to(scene.sun_dir, p.shape))}
    return {k: (a.contiguous(), b.contiguous()) for k, (a, b) in lists.items()}


def coherent_bound(n, pk, stats):
    """Rays read once (24 B), outputs written once (17 B: four int32 and
    a bool), tables read once; operations counted from the walk's work on
    these rays."""
    nbytes = n * COH_BYTES_PER_RAY + pk.occ.numel() * 4 + pk.words.numel() * 4
    ops = (n * COH_OPS_PER_RAY + stats.get("brick_steps", 0) * COH_OPS_PER_BRICK_STEP
           + stats.get("brick_visits", 0) * COH_OPS_PER_VISIT
           + stats.get("fine_steps", 0) * FINE_OPS_PER_STEP)
    return bound(nbytes, ops)


def indep_bound(n, per_ray_bytes, tb, stats, camera):
    nbytes = (n * per_ray_bytes + 512 + tb.occw.numel() * 4 + tb.matb.numel()
              + (tb.pal.numel() * 4 + 29 * 4 if camera else 0))
    ops = (n * (IND_OPS_PER_RAY + (CAM_OPS_PER_PIXEL if camera else 0))
           + stats.get("brick_steps", 0) * IND_OPS_PER_BRICK_STEP
           + stats.get("brick_visits", 0) * IND_OPS_PER_VISIT
           + stats.get("fine_steps", 0) * FINE_OPS_PER_STEP)
    return bound(nbytes, ops)


def time_kernel(tag, fn, plain_fn, counts, span, n, bnd):
    """CUDA-event ms per call at two call counts and their differential,
    profiler device ms per launch, plain ms (one call).  On a call of tens
    of microseconds the event time is mostly the wrapper's host work: the
    device time is the kernel's own."""
    fn()                                            # warm-up
    ms = [cuda_ms(lambda i: fn(), c) for c in counts]
    slope = (ms[1] * counts[1] - ms[0] * counts[0]) / (counts[1] - counts[0])
    agree = abs(slope - ms[1]) <= SLOPE_RTOL * ms[1]
    dev_ms = kernel_device_ms(fn, counts[0], span)
    plain_ms = cuda_ms(lambda i: plain_fn(), 1)
    dev = "not measured" if dev_ms is None else f"{dev_ms:.4f} ms"
    log(f"[timing] {tag}: kernel {ms[0]:.4f} ms per call over {counts[0]} calls, "
        f"{ms[1]:.4f} over {counts[1]}; differential {slope:.4f} ms/call, "
        f"{'agrees' if agree else 'does NOT agree'} within {SLOPE_RTOL:.0%}; "
        f"device time per launch {dev}; plain {plain_ms:.2f} ms; bound "
        f"{bnd[0]:.4f} ms ({bnd[1]}); {n / ms[1] * 1e3:.4g} rays/s")
    return dict(ms=ms[1], diff_ms=slope, dev_ms=dev_ms, plain_ms=plain_ms, bound=bnd)


def crate_random_rays():
    """N_RAYS random local rays in and around the crate field (on the
    card): the frames' lists barely walk (primary rays stop at the closed
    cube's face, shadow rays leave it), these walk the hollow crates."""
    rng = np.random.RandomState(1)
    o = rng.uniform(-1.0, 13.8, (N_RAYS, 3)).astype(np.float32)   # grid: [0, 12.8]^3
    d = rng.randn(N_RAYS, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return torch.from_numpy(o).cuda(), torch.from_numpy(d).cuda()


def crate_scene():
    """The 512-crate profiling scene baked into one 256^3 grid, as the
    kernel renderer's FastScene on the card, and its camera."""
    from voxel_tracer_tpu_torch.ops.cuda import renderer_fast
    from voxel_tracer_tpu_torch.utils import profiling
    scene = renderer_fast.FastScene.build([profiling.profiling_scene_merged()],
                                          device="cuda")
    return scene, profiling.profiling_camera(W / H)


def bench_fast_scene():
    """bench.py's scene (dense 64^3 noise, 512 bricks, all occupied) as the
    kernel renderer's FastScene on the card, and bench.py's camera."""
    from voxel_tracer_tpu_torch.models.volume import VoxelVolume
    from voxel_tracer_tpu_torch.ops.cuda import renderer_fast
    vol = VoxelVolume.noise_filled((64, 64, 64), pos=(0, 0, 0), vpu=20.0)
    return renderer_fast.FastScene.build([vol], device="cuda"), bench_camera(0.0, W / H)


def compare_fast_frames(tag, k, p):
    """A render_lambert_fast or render_flat_fast frame against the same
    frame traced by B5's plain version: every field equal (image 0 LSB)."""
    eq = {f: bool(torch.equal(k[f], p[f])) for f in p}
    log(f"[{tag}] kernel vs plain-traced frame, fields equal: {eq}")
    require(all(eq.values()), f"{tag}: fields differ: {eq}")


def b5_pair(tag, pk, o, d, stats=None):
    """B5 and its plain version on one list: every field equal, depth
    included; returns max |dt| (0)."""
    from voxel_tracer_tpu_torch.ops.cuda import coherent
    k = coherent.trace_coherent(pk.occ, pk.words, o, d, pk.bsize, pk.vpu)
    p = coherent.trace_coherent_plain(pk.occ, pk.words, o, d, pk.bsize, pk.vpu,
                                      stats=stats)
    torch.cuda.synchronize()
    dt = compare_traces(tag, k, p)
    require(dt == 0.0, f"{tag}: t differs by {dt}")
    return dt, int((~k["resolved"]).sum())


@timed_phase
def phase_kernel_renderer():
    """[kernel renderer] render_lambert_fast then render_flat_fast at WxH
    with the launch counts at 0 just before, on the 512-crate profiling
    scene baked into one 256^3 grid and on the bench scene (whose frames
    must equal their plain-traced frames); B5 against its plain version on
    each frame's own primary and shadow ray lists, random rays through the
    crate field and `profiling.edge_rays` on the bench grid."""
    from voxel_tracer_tpu_torch.ops.cuda import coherent, integrate, renderer_fast
    from voxel_tracer_tpu_torch.utils import profiling
    t0 = time.perf_counter()
    scene, cam = crate_scene()
    pk = scene.volumes[0].packed
    torch.cuda.synchronize()
    log(f"[kernel renderer] 512 crates baked into a {pk.bsize} brick grid, "
        f"{pk.occ.numel()} bricks ({int(pk.occ.sum())} occupied), scene built in "
        f"{time.perf_counter() - t0:.1f} s")

    coherent.reset_launch_counts()
    lit = renderer_fast.render_lambert_fast(scene, cam, W, H)
    torch.cuda.synchronize()
    lit_launches = coherent.KERNEL_LAUNCHES["coherent"]
    flat = integrate.render_flat_fast(scene.volumes[0], scene.sky, cam, W, H)
    torch.cuda.synchronize()
    launches = coherent.KERNEL_LAUNCHES["coherent"]
    log(f"[kernel renderer] render_lambert_fast + render_flat_fast at {W}x{H}: "
        f"coherent launches {launches} ({lit_launches} for the lit frame)")
    require(lit_launches == 2, f"lit frame launched B5 {lit_launches} times, not 2")
    require(launches > lit_launches, "flat frame did not launch B5")
    # the baked crates close into one cube whose faces seen from this
    # camera all face the sun: every hit is sunlit
    frac, sun = check_lit("kernel renderer", lit, all_sun=True)
    require(bool(torch.equal(flat["depth"], lit["depth"])), "flat and lit depth differ")
    log(f"[kernel renderer] hit fraction {frac:.4f}, sunlit share of hits {sun:.4f}, "
        f"mean steps on hits {float(lit['steps'][lit['depth'] < 1e30].float().mean()):.2f}")

    # the bench scene: every brick occupied, its rays walk into the noise
    bscene, bcam = bench_fast_scene()
    bpk = bscene.volumes[0].packed
    coherent.reset_launch_counts()
    blit = renderer_fast.render_lambert_fast(bscene, bcam, W, H)
    torch.cuda.synchronize()
    b_lit_launches = coherent.KERNEL_LAUNCHES["coherent"]
    bflat = integrate.render_flat_fast(bscene.volumes[0], bscene.sky, bcam, W, H)
    torch.cuda.synchronize()
    b_launches = coherent.KERNEL_LAUNCHES["coherent"]
    log(f"[kernel renderer bench] render_lambert_fast + render_flat_fast at {W}x{H}: "
        f"coherent launches {b_launches} ({b_lit_launches} for the lit frame)")
    require(b_lit_launches == 2, f"bench lit frame launched B5 {b_lit_launches} times")
    require(b_launches > b_lit_launches, "bench flat frame did not launch B5")
    bfrac, bsun = check_lit("kernel renderer bench", blit)
    require(bool(torch.equal(bflat["depth"], blit["depth"])), "bench flat and lit depth differ")
    log(f"[kernel renderer bench] hit fraction {bfrac:.4f}, sunlit share of hits "
        f"{bsun:.4f}, mean steps on hits "
        f"{float(blit['steps'][blit['depth'] < 1e30].float().mean()):.2f}")
    compare_fast_frames("kernel renderer bench lit", blit,
                        renderer_fast.render_lambert_fast_plain(bscene, bcam, W, H))
    compare_fast_frames("kernel renderer bench flat", bflat, integrate.render_flat_fast_plain(
        bscene.volumes[0], bscene.sky, bcam, W, H))

    lists = {f"crate {k}": (pk, *v) for k, v in frame_rays(scene, cam, lit).items()}
    lists["random"] = (pk, *crate_random_rays())
    lists.update({f"bench {k}": (bpk, *v) for k, v in frame_rays(bscene, bcam, blit).items()})
    out = dict(launches=launches, bench_launches=b_launches, err=0.0, lists=lists,
               stats={}, scene=scene, cam=cam)
    unresolved = 0
    for name, (pk_, o, d) in lists.items():
        stats = {}
        dt, unres = b5_pair(f"kernel renderer {name}", pk_, o, d, stats)
        out["err"] = max(out["err"], dt)
        unresolved += unres
        log(f"[kernel renderer {name}] work {stats}")
        out["stats"][name] = stats

    eo, ed = (torch.from_numpy(x).cuda()
              for x in profiling.edge_rays(bscene.volumes[0].volume.grid, bpk.vpu))
    dt, unres = b5_pair("kernel renderer edge rays", bpk, eo, ed)
    out["err"] = max(out["err"], dt)
    unresolved += unres
    log(f"[kernel renderer] unresolved rays: {unresolved}")
    require(unresolved == 0, f"{unresolved} unresolved rays")
    return out


@timed_phase
def phase_two_volumes():
    """[two volumes] Two unbaked procedural crates through
    render_lambert_fast (one B5 launch per volume and pass, min-combined)
    against its plain counterpart."""
    from voxel_tracer_tpu_torch.models.camera import Camera
    from voxel_tracer_tpu_torch.models.volume import VoxelVolume
    from voxel_tracer_tpu_torch.ops.cuda import coherent, renderer_fast
    from voxel_tracer_tpu_torch.utils import profiling
    crate = profiling._procedural_crate()
    # the raised crate shades the top of the other one
    vols = [VoxelVolume(crate, pos=(0.0, 1.0, 0.0)),
            VoxelVolume(crate, pos=(1.2, -0.8, 1.2))]
    scene = renderer_fast.FastScene.build(vols, device="cuda")
    cam = Camera.create((2.5, 4.0, -2.5), (0.6, 0.0, 0.6), W / H)
    coherent.reset_launch_counts()
    k = renderer_fast.render_lambert_fast(scene, cam, W, H)
    torch.cuda.synchronize()
    launches = coherent.KERNEL_LAUNCHES["coherent"]
    p = renderer_fast.render_lambert_fast_plain(scene, cam, W, H)
    torch.cuda.synchronize()
    eq = {f: bool(torch.equal(k[f], p[f]))
          for f in ("depth", "normal", "material", "steps", "irradiance", "albedo")}
    lsb = float((k["image"] - p["image"]).abs().max()) * 255
    frac, sun = check_lit("two volumes", k)
    log(f"[two volumes] 2 crates unbaked, {W}x{H}: coherent launches {launches}, "
        f"kernel vs plain equal {eq}, image {lsb:.3g} LSB, hit fraction {frac:.4f}, "
        f"sunlit share {sun:.4f}")
    require(launches == 4, f"two-volume frame launched B5 {launches} times, not 4")
    require(all(eq.values()), f"two-volume frame fields differ: {eq}")
    require(lsb <= LSB, f"two-volume image differs by {lsb} LSB")


API_N = 4096                # inputs of the math3d helpers, CPU vs the card
API_ULPS = {                 # card vs CPU; the rigid transforms: bit-equal
    # PyTorch's float32 sqrt on the CPU is not correctly rounded (an ulp
    # off on ~0.6 % of inputs; the phase counts both devices'), so norm
    # differs by an ulp, and normalize's quotient by two
    "norm": 2, "normalize": 2,
    # sinf / cosf: within 2 ulps on the card (CUDA's bound) and 1 on the
    # CPU; times the axis over its norm (2 ulps apart), rounded once more
    "quat_from_axis_angle": 6,
}


def ulps(a, b):
    """Most units in the last place between two float32 tensors (as
    ordered integers: +0 and -0 are one value, +inf and -inf far apart)."""
    k = [torch.as_tensor(x).detach().cpu().contiguous().view(torch.int32).long()
         for x in (a, b)]
    k = [torch.where(x < 0, -(x & 0x7fffffff), x) for x in k]
    return int((k[0] - k[1]).abs().max())


def turned_volume():
    """[api]'s volume: a 64^3 noise volume turned by
    quat_to_mat3(quat_from_axis_angle((0.3, 1, 0.2), 0.9)), the rotation
    built on the card, and bench_camera(0.3)'s WxH rays carried to its
    local space on the card by rigid_inverse_point / rigid_inverse_vec:
    (FastVolume, rotation, world (o, d), local (o_l, d_l))."""
    from voxel_tracer_tpu_torch.models.camera import rays_for_image
    from voxel_tracer_tpu_torch.models.volume import VoxelVolume
    from voxel_tracer_tpu_torch.ops import math3d as m3
    from voxel_tracer_tpu_torch.ops.cuda import integrate
    rot_card = m3.quat_to_mat3(m3.quat_from_axis_angle((0.3, 1, 0.2), 0.9))
    vol = VoxelVolume.noise_filled((64, 64, 64), pos=(0.1, -0.05, 0.2), vpu=20.0)
    vol.rot = rot_card.cpu().numpy()
    fv = integrate.FastVolume(vol, device="cuda")
    o, d = rays_for_image(bench_camera(0.3, W / H), W, H)
    o_l = m3.rigid_inverse_point(fv.rot, fv.pos, fv.pivot, o)
    d_l = m3.rigid_inverse_vec(fv.rot, d)
    return fv, rot_card, (o, d), (o_l, d_l)


@timed_phase
def phase_api():
    """[api] The math3d helpers that JAX callers use, on the card against
    the same calls on the CPU: the rigid transforms bit-equal (written
    out elementwise in a fixed order), the rest within API_ULPS (sqrt,
    sinf and cosf differ between the two libraries).  Then a
    volume turned by quat_to_mat3(quat_from_axis_angle((0.3, 1, 0.2),
    0.9)) on the card: its WxH world rays carried to local space by
    rigid_inverse_point / rigid_inverse_vec and traced by B5, held
    against trace_coherent_plain on the same local rays."""
    from voxel_tracer_tpu_torch.ops import math3d as m3, tonemap
    from voxel_tracer_tpu_torch.ops.cuda import coherent
    rng = np.random.RandomState(11)
    axes = rng.randn(64, 3).astype(np.float32)
    angles = rng.uniform(-math.pi, math.pi, 64).astype(np.float32)
    v, p, pos, piv = (torch.from_numpy((rng.randn(API_N, 3) * 4).astype(np.float32))
                      for _ in range(4))
    v[:16] *= 1e-5                                  # shorter than normalize's eps
    rcp = v.reshape(-1).clone()
    rcp[:2] = torch.tensor([0.0, -0.0])
    quats = {dev: torch.stack([m3.quat_from_axis_angle(torch.from_numpy(a).to(dev), float(t))
                               for a, t in zip(axes, angles)]) for dev in ("cpu", "cuda")}
    q = quats["cpu"]
    rot = m3.quat_to_mat3(q)[torch.from_numpy(rng.randint(0, 64, API_N))]

    def calls(dev):
        qd, rd = q.to(dev), rot.to(dev)
        vd, pd, posd, pivd = (x.to(dev) for x in (v, p, pos, piv))
        return {
            "quat_from_axis_angle": quats[dev], "quat_identity": m3.quat_identity(dev),
            "quat_mul": m3.quat_mul(qd, qd.roll(1, 0)), "quat_to_mat3": m3.quat_to_mat3(qd),
            "quat_rotate": m3.quat_rotate(qd, vd[:64]), "norm": m3.norm(vd),
            "normalize": m3.normalize(vd, eps=1e-3), "safe_rcp": m3.safe_rcp(rcp.to(dev)),
            "reinhard_extended": tonemap.reinhard_extended(vd.abs(), 4.0),
            "rigid_forward": m3.rigid_forward(rd, posd, pivd, pd),
            "rigid_inverse_point": m3.rigid_inverse_point(rd, posd, pivd, pd),
            "rigid_forward_vec": m3.rigid_forward_vec(rd, vd),
            "rigid_inverse_vec": m3.rigid_inverse_vec(rd, vd)}

    cpu, card = calls("cpu"), calls("cuda")
    require(all(x.is_cuda for x in card.values()), "[api] a helper left the card")
    err = {k: ulps(card[k], cpu[k]) for k in cpu}
    sq = torch.from_numpy(rng.uniform(0, 100, 1 << 20).astype(np.float32))
    off_ieee = {dev: int((torch.sqrt(sq.to(dev)).cpu()
                          != torch.sqrt(sq.double()).float()).sum()) for dev in ("cpu", "cuda")}
    log(f"[api] math3d / tonemap helpers, {API_N} inputs, card vs CPU, ulps: {err}; float32 "
        f"sqrt off the correctly rounded value on {off_ieee} of {sq.numel()} inputs")
    for k, e in err.items():
        limit = 0 if k.startswith("rigid_") else API_ULPS.get(k, 1)
        require(e <= limit, f"[api] {k}: {e} ulps between the card and the CPU (limit {limit})")

    fv, rot_card, (o, d), (o_l, d_l) = turned_volume()
    require(rot_card.is_cuda, "[api] the rotation was not built on the card")
    require(torch.equal(fv.rot, rot_card), "[api] the volume's rotation differs from the card's")
    pk = fv.packed
    o_c, d_c = (m3.rigid_inverse_point(fv.rot.cpu(), fv.pos.cpu(), fv.pivot.cpu(), o.cpu()),
                m3.rigid_inverse_vec(fv.rot.cpu(), d.cpu()))
    require(torch.equal(o_l.cpu(), o_c) and torch.equal(d_l.cpu(), d_c),
            "[api] the card's local rays differ from the CPU's")
    coherent.reset_launch_counts()
    k = coherent.trace_coherent(pk.occ, pk.words, o_l, d_l, pk.bsize, pk.vpu)
    torch.cuda.synchronize()
    launches = coherent.KERNEL_LAUNCHES["coherent"]
    stats = {}
    p_ = coherent.trace_coherent_plain(pk.occ, pk.words, o_l, d_l, pk.bsize, pk.vpu,
                                       stats=stats)
    frac = float((k["t"] < 1e30).float().mean())
    log(f"[api] B5 launches on the turned volume's {W}x{H} rays: {launches}; hit fraction "
        f"{frac:.4f}")
    require(launches == 1, f"[api] B5 launched {launches} times, not once")
    require(0.05 < frac < 0.99, f"[api] hit fraction {frac}")
    dt = compare_traces("api B5 turned volume", k, p_)
    require(dt == 0.0, f"[api] B5 t differs by {dt}")
    return dict(launches=launches, err=dt, ulps=err, turned=(pk, o_l, d_l), stats=stats)


@timed_phase
def phase_indep(mv, o_t, d_t):
    """[indep] render_indep flat and lambert at WxH on the bench scene and
    trace_rays_indep on the random rays, launch counts at 0 just before;
    then B3 and B4 against their plain versions."""
    from voxel_tracer_tpu_torch.ops.cuda import indep, mega
    cam = bench_camera(0.0, W / H)
    occb = indep.occb_of(mv.tables)
    indep.reset_launch_counts()
    flat = indep.render_indep(mv, cam, W, H, sun_dir=SUN)
    lit = indep.render_indep(mv, cam, W, H, sun_dir=SUN, shading="lambert")
    tr = indep.trace_rays_indep(o_t, d_t, occb, mv.tables)
    torch.cuda.synchronize()
    launches = dict(indep.KERNEL_LAUNCHES)
    log(f"[indep] render_indep flat + lambert at {W}x{H}, trace_rays_indep on "
        f"{N_RAYS} rays: launches {launches}")
    for name, n in launches.items():
        require(n > 0, f"kernel {name} was not launched on the indep path")
    hit = flat["depth"] < indep.BIG
    frac = float(hit.float().mean())
    require(flat["image"].shape == (H, W, 3) and flat["image"].dtype == torch.uint8,
            "indep image shape/dtype")
    require(0.05 < frac < 0.99, f"indep hit fraction {frac}")
    require(bool(torch.equal(lit["depth"] < indep.BIG, hit)), "flat and lit hit masks differ")
    unresolved = sum(int((x["resolved"] == 0).sum()) for x in (flat, lit)) + \
        int((~tr["resolved"]).sum())
    mega_hit = mega.render_mega(mv, cam, W, H, sun_dir=SUN)["depth"] < mega.BIG
    log(f"[indep] hit fraction {frac:.4f} (B1 on the same frame: "
        f"{float(mega_hit.float().mean()):.4f}, hit masks differ on "
        f"{int((mega_hit != hit).sum())} pixels), mean steps on hits "
        f"{float(flat['steps'][hit].float().mean()):.2f}, unresolved {unresolved}")
    require(unresolved == 0, f"{unresolved} unresolved indep rays")

    cam_p = mega.mega_camera(mv, cam, SUN, W, H)
    err = 0.0
    cam_stats, ray_stats = {}, {}
    for shading, stats in (("flat", cam_stats), ("lambert", None)):
        k = indep.render_indep_tiles(cam_p, occb, mv.tables, width=W, height=H,
                                     shading=shading)
        p = indep.render_indep_tiles_plain(cam_p, occb, mv.tables, width=W,
                                           height=H, shading=shading, stats=stats)
        torch.cuda.synchronize()
        err = max(err, compare_frames(f"indep {shading} frame", k, p))
    p = indep.trace_rays_indep_plain(o_t, d_t, occb, mv.tables, stats=ray_stats)
    torch.cuda.synchronize()
    ray_err = compare_traces("indep rays", tr, p)
    log(f"[indep] work: camera frame {cam_stats}, rays {ray_stats}")

    # the largest volume indep takes (a full 128-word bitmap) and a long
    # sparse volume whose rays walk hundreds of mostly empty bricks
    ex = indep_extra_inputs(cam)
    k = indep.render_indep_tiles(ex["grid_cam_p"], ex["grid_occb"], ex["grid"].tables,
                                 width=W, height=H)
    p = indep.render_indep_tiles_plain(ex["grid_cam_p"], ex["grid_occb"], ex["grid"].tables,
                                       width=W, height=H, stats=ex["grid_stats"])
    torch.cuda.synchronize()
    err = max(err, compare_frames("indep 128^3 frame", k, p))
    unresolved = int((((k[2] >> mega.AUX_RESOLVED_SHIFT) & 1) == 0).sum())
    k = indep.trace_rays_indep(ex["budget_o"], ex["budget_d"], ex["budget_occb"], ex["budget"])
    p = indep.trace_rays_indep_plain(ex["budget_o"], ex["budget_d"], ex["budget_occb"],
                                     ex["budget"], stats=ex["budget_stats"])
    torch.cuda.synchronize()
    ray_err = max(ray_err, compare_traces("indep budget rays", k, p))
    unresolved += int((~k["resolved"]).sum())
    hits = int((k["t"] < indep.BIG).sum())
    log(f"[indep] work: 128^3 frame ({ex['grid'].tables.bocc.numel()} bricks) "
        f"{ex['grid_stats']}, budget rays ({ex['budget'].bocc.numel()} bricks, "
        f"{int(ex['budget'].bocc.sum())} occupied; {hits} hits) {ex['budget_stats']}; "
        f"unresolved {unresolved}")
    require(unresolved == 0 and hits > 0, f"indep extra inputs: {unresolved} unresolved, "
            f"{hits} budget hits")
    return dict(launches=launches, err_cam=err, err_rays=ray_err, cam_p=cam_p,
                occb=occb, cam_stats=cam_stats, ray_stats=ray_stats, extra=ex)


def indep_extra_inputs(cam):
    """B3's and B4's inputs beyond the bench scene: the bench frame on a
    128^3 noise volume (4096 bricks, the most indep takes: a full 128-word
    bitmap) and 65,536 rays of `profiling.budget_scene` (2048 bricks, most
    of them empty, walked end to end)."""
    from voxel_tracer_tpu_torch.models.volume import VoxelVolume
    from voxel_tracer_tpu_torch.ops.cuda import indep, mega
    from voxel_tracer_tpu_torch.utils import profiling
    grid = mega.MegaVolume(VoxelVolume.noise_filled((128, 128, 128), pos=(0, 0, 0), vpu=40.0),
                           device="cuda")
    g, o, d, vpu = profiling.budget_scene(length=4096, n_rays=65536)
    budget = mega.pack_tables(g, np.ones((256, 3), np.float32), vpu, "cuda")
    return dict(grid=grid, grid_cam_p=mega.mega_camera(grid, cam, SUN, W, H),
                grid_occb=indep.occb_of(grid.tables), grid_stats={},
                budget=budget, budget_occb=indep.occb_of(budget),
                budget_o=torch.from_numpy(o).cuda(), budget_d=torch.from_numpy(d).cuda(),
                budget_stats={})


@timed_phase
def phase_new_timing(kr, api, ind, mv, o_t, d_t):
    """[timing] B5 on the kernel renderer's ray lists and the turned
    volume's rays (and B4 on the bench frame's primary list, the
    yardstick), B3 on the bench frame, B4 on the random rays; the lit frame
    of the kernel renderer end to end (wall and device-busy time)."""
    from voxel_tracer_tpu_torch.ops.cuda import coherent, indep, renderer_fast
    out = {}
    lists = dict(kr["lists"], **{"turned volume": api["turned"]})
    stats = dict(kr["stats"], **{"turned volume": api["stats"]})
    for name, (pk, o, d) in lists.items():
        def fn(pk=pk, o=o, d=d):
            return coherent.trace_coherent(pk.occ, pk.words, o, d, pk.bsize, pk.vpu)

        def plain(pk=pk, o=o, d=d):
            return coherent.trace_coherent_plain(pk.occ, pk.words, o, d, pk.bsize,
                                                 pk.vpu)
        n = o.shape[0]
        out[f"coherent {name}"] = time_kernel(
            f"coherent {name} rays", fn, plain, (10, 40), "coherent_kernel", n,
            coherent_bound(n, pk, stats[name]))
    # the yardstick: B4 walks the bench frame's primary list on indep's
    # float program (its own rounding and step count)
    o, d = kr["lists"]["bench primary"][1:]
    n = o.shape[0]
    ystats = {}
    indep.trace_rays_indep_plain(o, d, ind["occb"], mv.tables, stats=ystats)
    out["indep_rays bench primary"] = time_kernel(
        "indep rays on the bench frame's primary list (B4, yardstick)",
        lambda: indep.trace_rays_indep(o, d, ind["occb"], mv.tables),
        lambda: indep.trace_rays_indep_plain(o, d, ind["occb"], mv.tables), (10, 40),
        "indep_rays_kernel", n, indep_bound(n, 32, mv.tables, ystats, False))
    tb = mv.tables
    n_px = W * H
    ex = ind["extra"]
    n_b = ex["budget_o"].shape[0]
    for key, tag, fn, plain, counts, span, n, bnd, stats in (
            ("indep_camera", "indep camera frame",
             lambda: indep.render_indep_tiles(ind["cam_p"], ind["occb"], tb, width=W, height=H),
             lambda: indep.render_indep_tiles_plain(ind["cam_p"], ind["occb"], tb, width=W,
                                                    height=H),
             (16, 64), "indep_camera_kernel", n_px,
             indep_bound(n_px, 12, tb, ind["cam_stats"], True), ind["cam_stats"]),
            ("indep_rays", "indep rays",
             lambda: indep.trace_rays_indep(o_t, d_t, ind["occb"], tb),
             lambda: indep.trace_rays_indep_plain(o_t, d_t, ind["occb"], tb),
             (10, 40), "indep_rays_kernel", N_RAYS,
             indep_bound(N_RAYS, 32, tb, ind["ray_stats"], False), ind["ray_stats"]),
            ("indep_camera 128^3", "indep camera 128^3 frame",
             lambda: indep.render_indep_tiles(ex["grid_cam_p"], ex["grid_occb"],
                                              ex["grid"].tables, width=W, height=H),
             lambda: indep.render_indep_tiles_plain(ex["grid_cam_p"], ex["grid_occb"],
                                                    ex["grid"].tables, width=W, height=H),
             (8, 32), "indep_camera_kernel", n_px,
             indep_bound(n_px, 12, ex["grid"].tables, ex["grid_stats"], True),
             ex["grid_stats"]),
            ("indep_rays budget", "indep budget rays",
             lambda: indep.trace_rays_indep(ex["budget_o"], ex["budget_d"], ex["budget_occb"],
                                            ex["budget"]),
             lambda: indep.trace_rays_indep_plain(ex["budget_o"], ex["budget_d"],
                                                  ex["budget_occb"], ex["budget"]),
             (4, 16), "indep_rays_kernel", n_b,
             indep_bound(n_b, 32, ex["budget"], ex["budget_stats"], False),
             ex["budget_stats"])):
        t = time_kernel(tag, fn, plain, counts, span, n, bnd)
        steps = stats["brick_steps"] + stats["fine_steps"]
        per_s = ("not measured" if t["dev_ms"] is None
                 else f"{steps / t['dev_ms'] * 1e3:.4g}")
        log(f"[timing] {tag}: {steps} DDA steps ({steps / n:.2f} a ray), {per_s} DDA "
            f"steps/s (device time)")
        out[key] = t

    scene, cam = kr["scene"], kr["cam"]

    def frames(k):
        for _ in range(k):
            renderer_fast.render_lambert_fast(scene, cam, W, H)

    frames(1)
    counts = (4, 16)
    ms = [cuda_ms(lambda i: frames(1), c) for c in counts]
    wall, busy, kernels = device_busy(lambda: frames(8))
    idle = f"{1.0 - busy / wall:.4f}" if busy is not None else "not measured"
    log(f"[timing] kernel renderer lit frame {W}x{H}: {ms[0]:.4f} ms/frame over "
        f"{counts[0]} frames, {ms[1]:.4f} over {counts[1]}; profiled 8 frames: wall "
        f"{wall / 8:.4f} ms/frame, device busy "
        f"{'not measured' if busy is None else f'{busy / 8:.4f} ms/frame'} in "
        f"{kernels / 8:.1f} kernels/frame, idle share {idle}")
    return out


# ---------------------------------------------------------------------------
# Fourth slice: the full-material Whitted frame on B1 / B2
# ---------------------------------------------------------------------------

WH_W, WH_H = 1280, 768          # bench_suite.py full_whitted_720p
WH_SMALL_W, WH_SMALL_H = 320, 192
WH_BOUNCES, WH_GLASS_REFL = 3, 2
# orbit angle: off the grid's boundary planes (at 0 the camera sits in the
# plane of the grid's far z face, where grazing rays split between float
# pipelines), looking through the grid's far corner into the scene
WH_THETA = 0.05
WH_ROUNDS = 6                   # frame timing: the two counts in turns (an even count:
                                # a linear drift of the host cancels between them)
# the kernel frame vs the port's wavefront Renderer: the CPU tests' pinned
# budgets (tests/test_torch_renderer.py), as shares of the frame's pixels
WH_COLOR_MISMATCH_SHARE = 130 / 3072    # pixels over 5 % relative error
WH_MEAN_REL_ERR = 0.015
WH_DEPTH_ATOL = 5e-3
WH_HIT_COUNT_SHARE = 4 / 3072


def whitted_config(width, height, **kw):
    return _whitted_config(width, height, WH_BOUNCES, WH_GLASS_REFL, **kw)




def check_whitted_frame(tag, out, width, height):
    """Shapes, finite values, a hit fraction strictly inside (0, 1), unit
    normals on voxel hits (a laser capsule's analytic normal is the
    reference's unnormalized one), glass and mirror rows in view."""
    from voxel_tracer_tpu_torch.ops.prims import LASER_MAT
    hit = out["depth"] < 1e30
    frac = float(hit.float().mean())
    require(out["image"].shape == (height, width, 3), f"{tag}: image shape")
    for f in ("image", "color", "irradiance", "albedo"):
        require(bool(torch.isfinite(out[f]).all()), f"{tag}: non-finite {f}")
    require(0.05 < frac < 0.99, f"{tag}: hit fraction {frac}")
    n = out["normal"][hit & (out["material"] != LASER_MAT)]
    require(bool(torch.allclose(n.norm(dim=-1), torch.ones_like(n[:, 0]), atol=1e-6)),
            f"{tag}: normals are not unit length")
    rows = torch.div(out["material"][hit] - 1, 8, rounding_mode="floor")
    shares = {r: float((rows == k).float().mean()) for r, k in
              (("glass", 0), ("mirror", 1), ("diffuse", 2))}
    shares["diffuse"] = 1.0 - shares["glass"] - shares["mirror"]
    require(shares["glass"] > 0 and shares["mirror"] > 0,
            f"{tag}: glass and mirror not both in view: {shares}")
    return frac, shares


def compare_whitted(tag, k, p):
    """Kernel-traced vs plain-traced frame: every field equal."""
    diffs = {f: float((k[f].double() - p[f].double()).abs().max()) for f in k}
    log(f"[{tag}] kernel vs plain, max |d| per field: {diffs}")
    require(all(v == 0.0 for v in diffs.values()), f"{tag}: fields differ: {diffs}")
    return max(diffs.values())


def compare_whitted_wavefront(tag, k, r):
    """Kernel frame vs the wavefront Renderer's frame, to the CPU tests'
    budgets scaled to the frame's pixels."""
    kc, rc = k["color"].reshape(-1, 3), r["color"].reshape(-1, 3)
    rel = (kc - rc).abs().amax(-1) / torch.clamp(rc.abs().amax(-1), min=1.0)
    n = rel.numel()
    mism = int((rel > 0.05).sum())
    kt, rt = k["depth"].reshape(-1), r["depth"].reshape(-1)
    both = (kt < 1e30) & (rt < 1e30)
    dt = float((kt[both] - rt[both]).abs().max())
    dhit = abs(int((kt < 1e30).sum()) - int((rt < 1e30).sum()))
    mat_eq = float((k["material"].reshape(-1)[both] == r["material"].reshape(-1)[both])
                   .float().mean())
    log(f"[{tag}] kernel frame vs wavefront Renderer: {mism} of {n} pixels over 5 % "
        f"(budget {WH_COLOR_MISMATCH_SHARE * n:.0f}), mean relative error "
        f"{float(rel.mean()):.5f} (budget {WH_MEAN_REL_ERR}), depth max |d| {dt:.3g}, "
        f"hit counts differ by {dhit} (budget {WH_HIT_COUNT_SHARE * n:.0f}), "
        f"material equal on {mat_eq:.5f} of common hits")
    require(mism <= WH_COLOR_MISMATCH_SHARE * n, f"{tag}: {mism} colour mismatches")
    require(float(rel.mean()) < WH_MEAN_REL_ERR, f"{tag}: mean relative error")
    require(dt < WH_DEPTH_ATOL, f"{tag}: depth differs by {dt}")
    require(dhit <= WH_HIT_COUNT_SHARE * n, f"{tag}: hit counts differ by {dhit}")


@timed_phase
def phase_whitted(device="cuda", size=(WH_W, WH_H), small=(WH_SMALL_W, WH_SMALL_H),
                  counts=(4, 12)):
    """[whitted] The full-material frame: render_whitted_mega on B1 / B2 at
    1280x768 (launch counts at 0 just before, read just after); the same
    frame traced by the plain versions at 320x192, equal field for field;
    the port's wavefront Renderer on that frame; four accumulated frames;
    frame time and device busy share."""
    from voxel_tracer_tpu_torch.ops import composite
    from voxel_tracer_tpu_torch.ops.cuda import mega
    from voxel_tracer_tpu_torch.ops.cuda.whitted import (MegaIntersector, WhittedMegaRenderer,
                                                         render_whitted_mega)
    from voxel_tracer_tpu_torch.renderer import Renderer
    from voxel_tracer_tpu_torch.utils.profiling import glass_box_camera, glass_box_scene
    t0 = time.perf_counter()
    # a procedural stand-in for bench_suite.py:381-437's glass-box scene
    merged, scene = glass_box_scene(128)
    sd = scene.data(device)
    mv = mega.MegaVolume(merged, device)
    isect = MegaIntersector(mv, shadow_rounds=WH_SHADOW_ROUNDS, compact=True)
    w, h = size
    cfg = whitted_config(w, h)
    cam = glass_box_camera(merged, WH_THETA, w, h)
    log(f"[whitted] scene: {merged.grid.shape[::-1]} grid, glass ids {isect.glass_ids}, "
        f"{sd.lights.origin.shape[0]} sphere light; built in "
        f"{time.perf_counter() - t0:.1f} s")

    mega.reset_launch_counts()
    out = render_whitted_mega(isect, sd, cam, w, h, 0, config=cfg)
    if device != "cpu":
        torch.cuda.synchronize()
    launches = dict(mega.KERNEL_LAUNCHES)
    expected = whitted_launches(len(isect.glass_ids), WH_BOUNCES, WH_GLASS_REFL,
                                WH_SHADOW_ROUNDS)
    frac, shares = check_whitted_frame("whitted", out, w, h)
    log(f"[whitted] render_whitted_mega at {w}x{h}, shading full, {WH_BOUNCES} bounces, "
        f"{WH_GLASS_REFL} glass reflections, {WH_SHADOW_ROUNDS} shadow rounds, compact: "
        f"launches {launches} (bench_suite's formula: {expected} a frame, "
        f"{expected - 1} of them ray lists); hit fraction {frac:.4f}, rows of hits {shares}")
    if device != "cpu":
        for name, k in launches.items():
            require(k > 0, f"kernel {name} was not launched on the Whitted path")
    # the same frame traced by the plain versions: every B1 / B2 input of
    # the main path (983,040 primary rays, the full and inverted-table ray
    # lists) held against its plain version through the frame's fields
    plain = MegaIntersector(mv, shadow_rounds=WH_SHADOW_ROUNDS, compact=True,
                            trace_fn=mega.trace_rays_plain,
                            tiles_fn=mega.render_mega_tiles_plain)
    t0 = time.perf_counter()
    err = compare_whitted(f"whitted {w}x{h}",
                          out, render_whitted_mega(plain, sd, cam, w, h, 0, config=cfg))
    log(f"[whitted] plain-traced {w}x{h} frame in {time.perf_counter() - t0:.1f} s")

    sw, sh = small
    s_cfg = whitted_config(sw, sh)
    s_cam = glass_box_camera(merged, WH_THETA, sw, sh)
    k = render_whitted_mega(isect, sd, s_cam, sw, sh, 0, config=s_cfg)
    p = render_whitted_mega(plain, sd, s_cam, sw, sh, 0, config=s_cfg)
    err = max(err, compare_whitted(f"whitted {sw}x{sh}", k, p))
    check_whitted_frame(f"whitted {sw}x{sh}", k, sw, sh)
    # the wavefront DDA walks stochastic shadows to the end; the kernel
    # frame does with exact_fallback (shadow walks past shadow_rounds
    # voxels continue on the DDA's shadow mode)
    exact = MegaIntersector(mv, shadow_rounds=WH_SHADOW_ROUNDS, compact=True,
                            exact_fallback=True)
    k_exact = render_whitted_mega(exact, sd, s_cam, sw, sh, 0, config=s_cfg)
    r = Renderer(s_cfg, device=device, isect=composite.PLAIN).render(sd, s_cam, frame=0)
    compare_whitted_wavefront(f"whitted {sw}x{sh}", k_exact, r)

    acc = WhittedMegaRenderer(isect, sd, whitted_config(w, h, accumulate=True))
    for i in range(4):
        a_out = acc.render(glass_box_camera(merged, WH_THETA + 0.002 * i, w, h))
    require(acc.frame == 4 and a_out["accu"].shape == (h, w, 4), "accumulated frames")
    for f in ("image", "accu", "irradiance"):
        require(bool(torch.isfinite(a_out[f]).all()), f"accumulated frame: non-finite {f}")
    log(f"[whitted] 4 accumulated frames: accu {tuple(a_out['accu'].shape)}, finite")
    res = dict(launches=launches, expected=expected, err=err, frac=frac, shares=shares)
    if device == "cpu":
        return res
    # the ray lists B2 traces in the main path's frame, replayed alone
    cap = ListCapture()
    render_whitted_mega(MegaIntersector(mv, shadow_rounds=WH_SHADOW_ROUNDS, compact=True,
                                        trace_fn=cap), sd, cam, w, h, 0, config=cfg)
    res["lists"] = replay_lists("whitted", cap.lists)

    cams = [glass_box_camera(merged, WH_THETA + 0.001 * i, w, h) for i in range(16)]

    def frame(i):
        return render_whitted_mega(isect, sd, cams[i % 16], w, h, 0, config=cfg)

    frame(0)
    r = alternating_rounds(frame, counts, WH_ROUNDS, log=lambda m: log(f"[whitted] {m}"))
    ms, agree = r.ms, r.agree
    slope = (ms[1] * counts[1] - ms[0] * counts[0]) / (counts[1] - counts[0])
    # RenderConfig.compact=False (the default) shades every primary ray at
    # every stage with no host sync for a live count
    u_cfg = whitted_config(w, h, compact=False)
    render_whitted_mega(isect, sd, cams[0], w, h, 0, config=u_cfg)
    ms_u = cuda_ms(lambda i: render_whitted_mega(isect, sd, cams[i % 16], w, h, 0,
                                                 config=u_cfg), counts[0])
    log(f"[whitted] compact=False: {ms_u:.4f} ms/frame over {counts[0]} frames "
        f"(compact=True {ms[0]:.4f} over {counts[0]}, {ms[1]:.4f} over {counts[1]})")
    before = mega.KERNEL_LAUNCHES["mega_rays"]
    wall, busy, kernels = device_busy(lambda: [frame(i) for i in range(4)])
    per_frame = (mega.KERNEL_LAUNCHES["mega_rays"] - before) / 4
    b2_dev = kernel_device_ms(lambda: frame(0), 2, "mega_rays_kernel")
    idle = "not measured" if busy is None else f"{1.0 - busy / wall:.4f}"
    log(f"[whitted] timing {w}x{h}: {ms[0]:.4f} ms/frame over {counts[0]} frames, "
        f"{ms[1]:.4f} over {counts[1]} (means of {WH_ROUNDS} rounds each, in turns), "
        f"{'agree' if agree else 'do NOT agree'} within "
        f"{SLOPE_RTOL:.0%} (differential {slope:.4f} ms/frame); "
        f"{w * h / ms[1] * 1e3:.4g} primary rays/s; profiled 4 frames: wall "
        f"{wall / 4:.4f} ms/frame, device busy "
        f"{'not measured' if busy is None else f'{busy / 4:.4f} ms/frame'} in "
        f"{kernels / 4:.1f} kernels/frame, idle share {idle}; mega_rays launches "
        f"{per_frame:.1f} a frame over the window's 4 cameras (main path "
        f"{launches['mega_rays']}, bench_suite's formula {expected - 1}), device time per "
        f"launch {'not measured' if b2_dev is None else f'{b2_dev:.4f} ms'}")
    require(agree, f"whitted frame times disagree: {ms}")
    res.update(ms=ms[1], diff_ms=slope, uncompacted_ms=ms_u, wall=wall / 4,
               busy=None if busy is None else busy / 4, kernels=kernels / 4,
               idle=None if busy is None else 1.0 - busy / wall,
               b2_window_per_frame=per_frame, b2_dev_ms=b2_dev)
    return res


@timed_phase
def phase_lambert_accumulate(mv):
    """[lit accumulate] render_lambert_mega with prev_accu on the bench
    frame: identical deterministic frames make the 95 % history blend a
    fixed point on hit pixels inside evenly lit regions.  Next to an edge
    it need not be (the reference's own float32 arithmetic,
    renderer.cpp:298-305): where uv * W lands a few ulps below a pixel
    coordinate the bilinear weights leak a few 1e-4 onto the neighbours,
    and where a tap's base + 1 rounds up across a power of two (x = 512,
    1024) the sample lands one pixel over; JAX's reproject_accumulate
    moves edge pixels alike at this frame size
    (tests/test_torch_shading.py::test_reproject_full_frame_edges_match_jax).
    The kernel frame equals the plain one."""
    from voxel_tracer_tpu_torch.ops.cuda import mega
    from voxel_tracer_tpu_torch.renderer import empty_accu
    cam = bench_camera(0.0, W / H)
    base = mega.render_lambert_mega(mv, cam, W, H, sun_dir=SUN)
    accu = empty_accu(W, H, "cuda")
    for _ in range(3):
        out = mega.render_lambert_mega(mv, cam, W, H, sun_dir=SUN, prev_accu=accu,
                                       prev_planes=cam.planes)
        accu = out["accu"]
    plain = mega.render_lambert_mega_plain(mv, cam, W, H, sun_dir=SUN, prev_accu=accu,
                                           prev_planes=cam.planes)
    k = mega.render_lambert_mega(mv, cam, W, H, sun_dir=SUN, prev_accu=accu,
                                 prev_planes=cam.planes)
    torch.cuda.synchronize()
    hit = base["depth"] < mega.BIG
    irr = base["irradiance"]
    # hit pixels whose 8 neighbours are hits of the same irradiance: a
    # sample moved one pixel over lands on the same value
    flat = hit.clone()
    flat[0, :] = flat[-1, :] = False
    flat[:, 0] = flat[:, -1] = False
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            nb = (dy, dx)
            flat &= torch.roll(hit, nb, (0, 1)) & (torch.roll(irr, nb, (0, 1)) == irr).all(-1)
    d = (out["irradiance"] - irr).abs().amax(-1)
    d_flat, d_edge = float(d[flat].max()), float(d[hit & ~flat].max())
    dk = {f: float((k[f] - plain[f]).abs().max()) for f in ("irradiance", "accu", "depth")}
    log(f"[lit accumulate] render_lambert_mega with prev_accu at {W}x{H}: 3 frames; "
        f"irradiance vs the frame without history: max |d| {d_flat:.3g} on the "
        f"{int(flat.sum())} of {int(hit.sum())} hit pixels inside evenly lit regions, "
        f"{d_edge:.3g} on the rest (edges: {int((hit & ~flat & (d > 1e-4)).sum())} "
        f"pixels off by more than 1e-4); kernel vs plain {dk}")
    require(int(flat.sum()) > int(hit.sum()) // 2, "lit accumulate: few evenly lit pixels")
    require(d_flat <= 1e-4, f"lit accumulate is not a fixed point: {d_flat}")
    require(all(v <= T_ATOL for v in dk.values()), f"lit accumulate kernel vs plain {dk}")



# ---------------------------------------------------------------------------
# D1: the DDA of ops/dda.py as one kernel, on its own lists and under the
# slice's two frames (the exact Whitted frame, the wavefront Renderer)
# ---------------------------------------------------------------------------

DDA_OPS_PER_RAY = 80            # slab test 38, both levels' set-up 42 (dda.cu)
DDA_OPS_PER_STEP = 8            # compares and add of a step 4, a brick entry's 31 amortized
DDA_OUT_BYTES = 42              # t, slab tmin / tmax, step sign, mat, axis, steps,
                                # entry axis, valid, resolved
DDA_EQUAL = ("mat", "axis", "steps", "entry_axis", "valid", "resolved", "step_sign")
DDA_T = ("t", "slab_tmin", "slab_tmax")
DDA_BUDGET_STEPS = 6            # tests/test_torch_dda.py::test_dda_medium_step_budget_exit
DDA_SHAPE_N = 1 << 18           # rays of the medium, scan, shadow and stacked lists
DDA_EDITS = 64                  # voxels carved, and as many filled, between two D1 calls
DF_SIZE = (WH_W, WH_H)          # the slice's two frames (full_whitted_720p's size)
DF_SMALL = (WH_SMALL_W, WH_SMALL_H)
DF_PLAIN_LIMIT_S = 60.0         # a plain frame over this is held at DF_HALF instead
DF_HALF = (640, 384)


def _dirs(rng, n, axis_share=16):
    """n random unit directions, 1/axis_share of them axis-parallel with
    zero components of random sign."""
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    k = n // axis_share
    zeros = np.where(rng.rand(k, 3) < 0.5, -0.0, 0.0).astype(np.float32)
    zeros[np.arange(k), rng.randint(0, 3, k)] = np.where(rng.rand(k) < 0.5, -1.0, 1.0)
    d[:k] = zeros
    return d


def _cells_rays(grid, gid, vpu, n, rng):
    """n local rays from random points inside voxels of id ``gid``,
    random directions."""
    cells = np.argwhere(grid == gid)[:, ::-1]
    pick = cells[rng.randint(0, len(cells), n)]
    o = ((pick + rng.uniform(0.05, 0.95, (n, 3))) / np.float32(vpu)).astype(np.float32)
    return o, _dirs(rng, n)


def _stacked_grids(n_side=64):
    """The stacked grids of tests/test_torch_dda.py's oid test at 64^3:
    a sphere, a noise volume and a smaller sphere of another material."""
    from voxel_tracer_tpu_torch.models.volume import VoxelVolume
    z, y, x = np.meshgrid(*[np.arange(n_side)] * 3, indexing="ij")
    c = (n_side - 1) / 2.0
    r = np.sqrt((x - c) ** 2 + (y - c) ** 2 + (z - c) ** 2)
    grids = [np.where(r < 0.4 * n_side, 5, 0).astype(np.uint8),
             VoxelVolume.noise_filled((n_side,) * 3).grid,
             np.where(r < 0.3 * n_side, 40, 0).astype(np.uint8)]
    return grids, np.array([20.0, 16.0, 25.0], np.float32)


def dda_lists(vol, o_rand, d_rand, device="cuda", n=DDA_SHAPE_N):
    """D1's lists: (tag, grid, brick_occ, origins, dirs, vpu, keywords),
    all on ``device``; ``n`` rays in the glass and stacked lists."""
    from voxel_tracer_tpu_torch.models.volume import VoxelVolume, compute_brick_occ
    from voxel_tracer_tpu_torch.utils import profiling

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    def tables(grid):
        return dev(grid.astype(np.int32)), dev(compute_brick_occ(grid))

    out = [("random", *tables(vol.grid), o_rand, d_rand, vol.vpu, {})]
    g, o, d, vpu = profiling.budget_scene(length=4096, n_rays=65536)
    out.append(("budget", *tables(g), dev(o), dev(d), vpu, {}))
    rng = np.random.RandomState(3)
    nv = VoxelVolume.noise_filled((32, 32, 32))
    o = (rng.uniform(0.02, 0.98, (n, 3)) * nv.size).astype(np.float32)
    med = np.where(rng.rand(n) < 0.5, 16, 0).astype(np.int32)
    out.append(("medium budget", *tables(nv.grid), dev(o), dev(_dirs(rng, n)), nv.vpu,
                dict(medium=dev(med), max_steps=DDA_BUDGET_STEPS)))
    merged, _scene = profiling.glass_box_scene(128)
    gt = tables(merged.grid)
    o, d = _cells_rays(merged.grid, 4, merged.vpu, n, rng)
    four = dev(np.full(n, 4, np.int32))
    out.append(("glass interior", *gt, dev(o), dev(d), merged.vpu, dict(medium=four)))
    out.append(("glass scan", *gt, dev(o), dev(d), merged.vpu, dict(ignore=four)))
    o = (rng.uniform(-0.3, 1.3, (n, 3)) * merged.size).astype(np.float32)
    seed = rng.randint(0, 2 ** 32, n, dtype=np.uint64)
    seed[:n // 4] |= np.uint64(1 << 31)                      # seeds >= 2**31
    out.append(("shadow", *gt, dev(o), dev(_dirs(rng, n)), merged.vpu,
                dict(shadow=True, shadow_seed=dev(seed.astype(np.int64)))))
    grids, vpus = _stacked_grids()
    sg = dev(np.stack(grids).astype(np.int32))
    sb = dev(np.stack([compute_brick_occ(x) for x in grids]))
    oid = rng.randint(0, 3, n)
    o = (rng.uniform(-0.3, 1.3, (n, 3)) * (64.0 / vpus[oid])[:, None]).astype(np.float32)
    d = _dirs(rng, n)
    med = np.where(rng.rand(n) < 0.5, 5, 0).astype(np.int32)
    for tag, kw in (("stacked", {}), ("stacked medium", dict(medium=dev(med)))):
        out.append((tag, sg, sb, dev(o), dev(d), dev(vpus[oid]), dict(kw, oid=dev(oid))))
    return out


def compare_dda(tag, k, p, quiet=False, rays=None):
    """D1 against the plain DDA: integer fields, flags and step signs
    equal, t / slab tmin / slab tmax NaN on the same rays and within
    T_ATOL elsewhere; ``rays`` a mask of the rays compared (default all).
    Returns max |d|."""
    if rays is not None:
        k, p = ({f: x[f][rays] for f in x} for x in (k, p))
    bad = [f for f in DDA_EQUAL if not torch.equal(k[f], p[f])]
    bad += [f for f in DDA_T if not torch.equal(torch.isnan(k[f]), torch.isnan(p[f]))]
    err = max(float(torch.nan_to_num(k[f] - p[f]).abs().max()) if k[f].numel() else 0.0
              for f in DDA_T)
    if not quiet or bad or err > T_ATOL:
        log(f"[{tag}] D1 vs plain: {k['t'].numel()} rays, unequal fields {bad}, "
            f"t / slab max |d| {err:.3g}")
    require(not bad and err <= T_ATOL, f"{tag}: D1 differs from the plain DDA: {bad}, {err}")
    return err


def d1_device_ms(fn, reps, medium):
    """D1's device ms a call: the mean span of its pass 1 and, with a
    medium, of its pass 2 (`kernel_device_ms` each; None if either shows
    no device events)."""
    spans = [kernel_device_ms(fn, reps, "dda_kernel")]
    if medium:
        spans.append(kernel_device_ms(fn, reps, "dda_exhaust_kernel"))
    return None if None in spans else sum(spans)


def _dda_bound(n, steps, kw, per_ray_vpu, grid, bocc):
    """Each ray's inputs read and outputs written once; of the grid and the
    brick table at most one 32-byte sector a step, and never more than the
    two tables (as `list_bound_bytes`); operations a ray and a step
    (`DDA_OPS_*`)."""
    extra = (4 if per_ray_vpu else 0) + (8 if "oid" in kw else 0) + \
        (4 if "medium" in kw else 0) + (4 if "ignore" in kw else 0) + \
        (8 if kw.get("shadow") else 0)
    tables = grid.numel() * grid.element_size() + bocc.numel() * bocc.element_size()
    nbytes = n * (24 + extra + DDA_OUT_BYTES) + min(SECTOR * steps, tables)
    return bound(nbytes, n * DDA_OPS_PER_RAY + steps * DDA_OPS_PER_STEP)


def dda_split(tag, grid, bocc, o, d, vpu, kw, full_p):
    """The batch rule: the medium rays that the one-call trace marked
    exhausted, traced alone, are not all marked (the rays that walked
    longest run out with the loop).  D1 equals the plain DDA on each part,
    and the parts differ from the one call."""
    from voxel_tracer_tpu_torch.ops import dda
    from voxel_tracer_tpu_torch.ops.cuda import dda as d1
    out_of_budget = (kw["medium"] > 0) & ~full_p["resolved"]
    marked = out_of_budget & (full_p["t"] < 1e30)          # exit at the slab tmax
    stuck = out_of_budget & (full_p["t"] >= 1e30)          # still walking at the end
    err, changed = 0.0, 0
    for part in (marked, ~marked):
        sub = dict(kw, medium=kw["medium"][part])
        args = (grid, bocc, o[part], d[part], vpu)
        kp = d1.intersect_volume_local(*args, **sub)
        pp = dda.intersect_volume_local(*args, **sub)
        err = max(err, compare_dda(f"{tag} split", kp, pp, quiet=True))
        changed += int((pp["t"] != full_p["t"][part]).sum())
    log(f"[{tag}] batch rule: one call marks {int(marked.sum())} exhausted medium rays "
        f"(exit at the slab tmax) and leaves {int(stuck.sum())} walking; traced apart, "
        f"{changed} rays change; D1 = plain on both parts")
    require(int(marked.sum()) > 0 and changed > 0, f"{tag}: the split changes nothing")
    return err


def _voxels_along(o, d, t, vpu, shape, n):
    """Up to n distinct voxels (z, y, x) at o + d * t of the rays whose t
    is finite, in ray order."""
    p = (o + d * t[:, None]) * vpu
    ok = torch.isfinite(p).all(dim=1) & (t < 1e30)
    zyx = torch.floor(p[ok]).long().flip(1).cpu().numpy()
    zyx = zyx[((zyx >= 0) & (zyx < np.array(shape))).all(axis=1)]
    _, first = np.unique(zyx, axis=0, return_index=True)
    return zyx[np.sort(first)[:n]]


def dda_edits(vol, o, d, device="cuda", n=DDA_EDITS):
    """D1 across in-place edits of its tables: the bench volume packed
    (`mega.pack_tables`: a uint8 grid) and packed with the voxels of its
    commonest id as the only air (ids 256 | id: D1 reads a solid voxel's id
    from the int32 grid), each traced, edited with `mega.set_voxel_tables`
    (``n`` of the voxels the rays hit carved, ``n`` voxels just in front of
    hits filled), and traced again.  Both calls equal the plain DDA on the
    tables as they stand, and the edits change the second call's hits (a
    stale derived table would leave them)."""
    from voxel_tracer_tpu_torch.ops import dda
    from voxel_tracer_tpu_torch.ops.cuda import dda as d1
    from voxel_tracer_tpu_torch.ops.cuda import mega
    grid = vol.grid
    ids, counts = np.unique(grid[grid > 0], return_counts=True)
    g = int(ids[np.argmax(counts)])
    res, err = {}, 0.0
    for tag, occupied in (("uint8 grid", None), ("ids past 255", grid != g)):
        tb = mega.pack_tables(grid, vol.palette, vol.vpu, device, occupied=occupied)

        def both(when):
            args = (tb.grid, tb.brick_occ, o, d, vol.vpu)
            k = d1.intersect_volume_local(*args)
            e = compare_dda(f"dda edits {tag} {when}", k, dda.intersect_volume_local(*args),
                            quiet=True)
            return k, e

        before, e0 = both("before")
        half = 0.5 / vol.vpu
        carve = _voxels_along(o, d, before["t"] + half, vol.vpu, grid.shape, n)
        fill = _voxels_along(o, d, before["t"] - half, vol.vpu, grid.shape, n)
        for (z, y, x), val, solid in [(v, 0, False) for v in carve] + \
                                     [(v, 200, True) for v in fill]:
            mega.set_voxel_tables(tb, x, y, z, val,
                                  occupied=None if occupied is None else solid)
        after, e1 = both("after")
        changed = int((after["t"] != before["t"]).sum())
        log(f"[dda] edits, {tag}: {len(carve)} voxels carved and {len(fill)} filled in "
            f"place between two D1 calls on {o.shape[0]} rays; {changed} rays change; each "
            f"call equal to the plain DDA (t max |d| {max(e0, e1):.3g})")
        require(changed > 0, f"dda edits {tag}: the edits changed no ray")
        err = max(err, e0, e1)
        res[tag.replace(" ", "_")] = dict(carved=len(carve), filled=len(fill), changed=changed)
    return res, err


def dda_parent_turns(calls, device_ms=None):
    """Device ms a replay of ``calls`` [((args, kw), ...)] on D1 and on the
    parent design, timed in turns (D1, parent, parent, D1); the parent's
    outputs held equal to D1's first (on the rays it agrees with the plain
    DDA on: `parent_rays`)."""
    from voxel_tracer_tpu_torch.ops.cuda import _build
    mod, lib = parent_design("torch_dda_trials")
    committed = _build.load("dda")
    runs = {"d1": mod.runner("committed", committed, calls),
            "parent": mod.runner("parent", lib, calls)}
    for (args, _kw), k, p in zip(calls, runs["d1"](), runs["parent"]()):
        compare_dda("dda parent", p, k, quiet=True, rays=mod.parent_rays(args))
    got = {"d1": [], "parent": []}
    for name in ("d1", "parent", "parent", "d1"):
        got[name].append(mod.dda_device_ms(runs[name], 2, len(calls)))
    return {k: None if None in v else sum(v) / len(v) for k, v in got.items()}


@timed_phase
def phase_dda(vol, o_rand, d_rand, device="cuda", n=DDA_SHAPE_N):
    """[dda] D1 against the plain DDA (`ops/dda.py`) on the same CUDA inputs,
    list by list: timed (events, device, plain), bounded, and beside the
    parent design; the batch rule on the medium budget list split in two;
    the stacked list with the bitmap read from global memory; in-place
    edits between two calls (`dda_edits`).  On the CPU (a rehearsal) the
    wrapper runs the plain DDA and nothing is timed."""
    from voxel_tracer_tpu_torch.ops import dda
    from voxel_tracer_tpu_torch.ops.cuda import dda as d1
    res, err = {}, 0.0
    for tag, grid, bocc, o, d, vpu, kw in dda_lists(vol, o_rand, d_rand, device, n):
        args = (grid, bocc, o, d, vpu)
        k = d1.intersect_volume_local(*args, **kw)
        p = dda.intersect_volume_local(*args, **kw)
        err = max(err, compare_dda(tag, k, p))
        if tag == "medium budget":
            err = max(err, dda_split(tag, *args, kw, p))
        if tag == "stacked":
            d1.GLOBAL_BITMAP = True
            try:
                err = max(err, compare_dda(f"{tag}, bitmap from global memory",
                                           d1.intersect_volume_local(*args, **kw), p))
            finally:
                d1.GLOBAL_BITMAP = False
        if device == "cpu":
            continue
        rays, steps = o.shape[0], int(k["steps"].sum())
        bnd = _dda_bound(rays, steps, kw, isinstance(vpu, torch.Tensor), grid, bocc)
        ms = cuda_ms(lambda i: d1.intersect_volume_local(*args, **kw), 10)
        dev = d1_device_ms(lambda: d1.intersect_volume_local(*args, **kw), 3, "medium" in kw)
        plain_ms = cuda_ms(lambda i: dda.intersect_volume_local(*args, **kw), 1)
        hits = float((k["t"] < 1e30).float().mean())
        log(f"[dda] {tag}: {rays} rays, {steps} steps ({steps / rays:.2f} a ray), hit share "
            f"{hits:.4f}, unresolved {int((~k['resolved']).sum())}; D1 {ms:.4f} ms a call "
            f"(events), device {'not measured' if dev is None else f'{dev:.4f} ms'}; plain "
            f"{plain_ms:.1f} ms; bound {bnd[0]:.4f} ms ({bnd[1]}); t max |d| 0 expected")
        turns = dda_parent_turns([(args, kw)])
        log(f"[dda] {tag}: device ms a call in turns (D1, parent, parent, D1): D1 "
            f"{_opt_ms(turns['d1'])}, parent design (PR 14) {_opt_ms(turns['parent'])}")
        res[tag] = dict(rays=rays, steps=steps, ms=ms, device_ms=dev, plain_ms=plain_ms,
                        bound_ms=bnd[0], bound_by=bnd[1], turns_device_ms=turns["d1"],
                        parent_device_ms=turns["parent"])
    edits, e = dda_edits(vol, o_rand[:n], d_rand[:n], device)
    res["edits"] = edits
    return res, max(err, e)


def _opt_ms(x):
    return "not measured" if x is None else f"{x:.4f} ms"


def _frame_numbers(tag, frame, reps):
    """ms a frame (events, ``reps`` frames), and from one device window of
    2 frames: busy ms, kernels, D1 launches and D1 device ms a frame; host
    syncs of one frame."""
    from voxel_tracer_tpu_torch.bench.measure import label_of
    from voxel_tracer_tpu_torch.ops.cuda import dda as d1
    from voxel_tracer_tpu_torch.utils.timer import busy_ms
    frame(0)
    ms = cuda_ms(frame, reps)
    before = d1.KERNEL_LAUNCHES["dda"]
    _wall, events = device_window(lambda: [frame(i) for i in range(2)])
    launches = (d1.KERNEL_LAUNCHES["dda"] - before) / 2
    busy = busy_ms(events) / 2 if events else None
    d1_ms = sum(b - a for n, a, b in events if label_of(n) == "D1") / 2e3 if events else None
    c1 = {k: sum(b - a for n, a, b in events if k in n) / 2e3 if events else None
          for k in C1_KERNELS.values()}
    syncs = count_host_syncs(lambda: frame(0))
    log(f"[{tag}] {ms:.4f} ms a frame over {reps} frames (events); device busy "
        f"{'not measured' if busy is None else f'{busy:.4f} ms'} in {len(events) / 2:.1f} "
        f"kernels a frame, idle share "
        f"{'not measured' if busy is None else f'{1.0 - busy / ms:.4f}'}; {syncs} host syncs "
        f"a frame; D1 {launches:.1f} launches, "
        f"{'not measured' if d1_ms is None else f'{d1_ms:.4f} ms'} device a frame")
    return dict(ms=ms, device_busy_ms=busy, kernels_per_frame=len(events) / 2,
                idle_share=None if busy is None else 1.0 - busy / ms,
                host_syncs_per_frame=syncs, d1_launches_per_frame=launches,
                d1_device_ms_per_frame=d1_ms,
                c1_device_ms_per_frame={k: c1[v] for k, v in C1_KERNELS.items()})


def d1_frame_bound(frame, ix=None):
    """D1's bound over one frame: the sum over the frame's D1 calls of each
    call's `_dda_bound` (its rays and the steps they took), and what bounds
    most of it.  ``ix`` a MegaIntersector, whose D1 function is bound at
    construction."""
    from voxel_tracer_tpu_torch.ops.cuda import dda as d1
    real, calls = d1.intersect_volume_local, []

    def record(grid, bocc, o, d, vpu, **kw):
        out = real(grid, bocc, o, d, vpu, **kw)
        calls.append(_dda_bound(o.shape[0], int(out["steps"].sum()), kw,
                                isinstance(vpu, torch.Tensor), grid, bocc))
        return out

    d1.intersect_volume_local = record
    if ix is not None:
        ix.dda_fn = record
    try:
        frame()
    finally:
        d1.intersect_volume_local = real
        if ix is not None:
            ix.dda_fn = real
    by = {k: sum(ms for ms, b in calls if b == k) for k in ("bytes", "operations")}
    return sum(by.values()), max(by, key=by.get), len(calls)


C1_KERNELS = {"composite_local": "composite_local_kernel",
              "composite_record": "composite_record_kernel"}


def c1_frame_bound(frame):
    """C1's bound over one frame: per kernel, the bytes its calls must move
    (each ray's inputs read once and its outputs written once, and the
    running record read where a call merges into it; the group's tables, a
    few hundred bytes, left out) over PEAK_BYTES_PER_S, in ms, and its
    calls."""
    from voxel_tracer_tpu_torch.ops.cuda import composite as ck
    real_local, real_record = ck.to_local, ck.record
    moved = {k: [] for k in C1_KERNELS}

    def to_local(group, origins, dirs, oid=0, obj=None, obj_base=0):
        per = 12 + (0 if dirs.stride(0) == 0 else 12) + 24   # origin, direction; o_l, d_l
        if obj is not None:                                   # obj; vpu and D1's oid out
            per += 4 + 4 + (8 if group.grid.shape[0] > 1 else 0)
        elif not isinstance(oid, int):                        # oid; vpu out
            per += 8 + 4
        moved["composite_local"].append(origins.shape[0] * per)
        return real_local(group, origins, dirs, oid=oid, obj=obj, obj_base=obj_base)

    def record(group, res, best=None, oid=0, obj=None, obj_base=0, live=None, select=False):
        per = 28 + 40 + (1 if live is not None else 0)        # D1's t, mat, axis, steps,
        per += 4 if obj is not None else 0 if isinstance(oid, int) else 8   # step_sign; record
        if best is not None and not select:                   # a merge reads the record
            per += 40
        moved["composite_record"].append(res["t"].shape[0] * per)
        return real_record(group, res, best, oid=oid, obj=obj, obj_base=obj_base, live=live,
                           select=select)

    ck.to_local, ck.record = to_local, record
    try:
        frame()
    finally:
        ck.to_local, ck.record = real_local, real_record
    return {k: (sum(v) / PEAK_BYTES_PER_S * 1e3, len(v)) for k, v in moved.items()}


@contextlib.contextmanager
def d1_calls():
    """Counts the calls of D1's wrapper (`ops/cuda/dda.intersect_volume_local`)
    inside the block, whichever branch runs: [count]."""
    from voxel_tracer_tpu_torch.ops.cuda import dda as d1
    real, count = d1.intersect_volume_local, [0]

    def counted(*args, **kw):
        count[0] += 1
        return real(*args, **kw)

    d1.intersect_volume_local = counted
    try:
        yield count
    finally:
        d1.intersect_volume_local = real


@contextlib.contextmanager
def tables_derived():
    """Counts the derivations of D1's tables (`ops/cuda/dda.dda_tables`)
    inside the block: [count]."""
    from voxel_tracer_tpu_torch.ops.cuda import dda as d1
    real, count = d1.dda_tables, [0]

    def counted(*args):
        count[0] += 1
        return real(*args)

    d1.dda_tables = counted
    try:
        yield count
    finally:
        d1.dda_tables = real


def _require_cached(tag, derived):
    """D1's tables were derived in the frame before the timed ones: the
    timed frames, which edit nothing, must find them all cached."""
    log(f"[{tag}] D1's tables derived {derived[0]} times over the timed frames (cached)")
    require(derived[0] == 0, f"{tag}: D1's tables were derived again without an edit")


def _plain_frame(fn, sync):
    """(frame, host seconds) of one plain frame, ended by ``sync()``."""
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


@timed_phase
def phase_dda_frames(device="cuda", size=DF_SIZE, small=DF_SMALL):
    """[dda frames] The slice's path at full width, launch counts at 0 just
    before each frame and read just after: the exact Whitted frame
    (render_whitted_mega, exact_fallback, full_whitted_720p's configuration)
    and the wavefront Renderer (RenderConfig's defaults: full shading, 8
    bounces) on the glass box scene at 1280x768, each equal field for field
    to its plain frame and timed beside it.  On the CPU (a rehearsal at a
    small ``size``) nothing is timed and D1 is not launched."""
    from voxel_tracer_tpu_torch.ops import composite, dda
    from voxel_tracer_tpu_torch.ops.cuda import composite as ck
    from voxel_tracer_tpu_torch.ops.cuda import dda as d1
    from voxel_tracer_tpu_torch.ops.cuda import mega
    from voxel_tracer_tpu_torch.ops.cuda.whitted import MegaIntersector, render_whitted_mega
    from voxel_tracer_tpu_torch.renderer import RenderConfig, Renderer
    from voxel_tracer_tpu_torch.utils.profiling import glass_box_camera, glass_box_scene
    merged, scene = glass_box_scene(128)
    sd = scene.data(device)
    mv = mega.MegaVolume(merged, device)
    on_card = device != "cpu"
    kw = dict(shadow_rounds=WH_SHADOW_ROUNDS, compact=True, exact_fallback=True)
    exact = MegaIntersector(mv, **kw)
    plain = MegaIntersector(mv, trace_fn=mega.trace_rays_plain,
                            tiles_fn=mega.render_mega_tiles_plain,
                            dda_fn=dda.intersect_volume_local, **kw)
    w, h = size
    res = {}

    def sync():
        if on_card:
            torch.cuda.synchronize()

    def whitted(ix, size, theta=WH_THETA):
        sw, sh = size
        return render_whitted_mega(ix, sd, glass_box_camera(merged, theta, sw, sh), sw, sh, 0,
                                   config=whitted_config(sw, sh))

    d1.reset_launch_counts()
    out = whitted(exact, size)
    sync()
    launches = d1.KERNEL_LAUNCHES["dda"]
    check_whitted_frame("dda frames exact", out, w, h)
    require(launches > 0 or not on_card, "D1 was not launched on the exact Whitted frame")
    err = compare_whitted(f"dda frames exact {small[0]}x{small[1]}",
                          whitted(exact, small), whitted(plain, small))
    p, plain_s = _plain_frame(lambda: whitted(plain, size), sync)
    err = max(err, compare_whitted(f"dda frames exact {w}x{h}", out, p))
    log(f"[dda frames] exact Whitted {w}x{h}: D1 launches {launches}; plain-traced frame "
        f"(B1, B2 and the DDA plain) in {plain_s:.1f} s")
    res["exact_whitted"] = dict(launches=launches, plain_ms=plain_s * 1e3, max_abs_err=err)
    if on_card:
        with tables_derived() as derived:
            res["exact_whitted"].update(_frame_numbers(
                "dda frames exact", lambda i: whitted(exact, size, WH_THETA + 0.001 * (i % 8)),
                4))
        _require_cached("dda frames exact", derived)
        bnd = d1_frame_bound(lambda: whitted(exact, size), exact)
        log(f"[dda frames] exact Whitted: D1 bound {bnd[0]:.4f} ms a frame ({bnd[1]}) over "
            f"its {bnd[2]} calls")
        res["exact_whitted"].update(bound_ms=bnd[0], bound_by=bnd[1])

    cfg = RenderConfig(width=w, height=h)
    cam = glass_box_camera(merged, WH_THETA, w, h)
    d1.reset_launch_counts()
    ck.reset_launch_counts()
    with d1_calls() as calls:
        k = Renderer(cfg, device=device).render(sd, cam, frame=0)
        sync()
    launches = d1.KERNEL_LAUNCHES["dda"]
    c1 = dict(ck.KERNEL_LAUNCHES)
    require(launches > 0 or not on_card, "D1 was not launched on the wavefront frame")
    # one group a traversal call (the merged volume): one launch of each C1 kernel a call,
    # and no prepass (C2 runs on stacked groups alone)
    log(f"[dda frames] wavefront: {calls[0]} traversal calls, C1 counts {c1}")
    fused = calls[0] if on_card else 0
    require(c1 == {"composite_fused": fused, "composite_glue": calls[0] - fused,
                   "composite_local": fused, "composite_record": fused,
                   "composite_topk": 0} and calls[0] > 0,
            f"wavefront frame: C1 counts {c1} against {calls[0]} traversal calls")
    check_whitted_frame("dda frames wavefront", k, w, h)
    p, plain_s = _plain_frame(lambda: Renderer(cfg, device=device, isect=composite.PLAIN)
                              .render(sd, cam, frame=0), sync)
    held = size
    if plain_s > DF_PLAIN_LIMIT_S:
        held = DF_HALF
        log(f"[dda frames] the plain wavefront frame took {plain_s:.1f} s at {w}x{h}: "
            f"held at {held[0]}x{held[1]}")
        h_cfg = RenderConfig(width=held[0], height=held[1])
        h_cam = glass_box_camera(merged, WH_THETA, *held)
        k = Renderer(h_cfg, device=device).render(sd, h_cam, frame=0)
        p, plain_s = _plain_frame(lambda: Renderer(h_cfg, device=device, isect=composite.PLAIN)
                                  .render(sd, h_cam, frame=0), sync)
    wf_err = compare_whitted(f"dda frames wavefront {held[0]}x{held[1]}", k, p)
    log(f"[dda frames] wavefront Renderer {w}x{h} (full shading, {cfg.max_bounces} bounces): "
        f"D1 launches {launches}; plain-DDA frame at {held[0]}x{held[1]} in {plain_s:.1f} s")
    res["wavefront"] = dict(launches=launches, plain_ms=plain_s * 1e3, plain_size=list(held),
                            max_abs_err=wf_err, traversal_calls=calls[0],
                            c1_launches={k: c1[k] for k in C1_KERNELS})
    if on_card:
        r = Renderer(cfg, device=device)
        cams = [glass_box_camera(merged, WH_THETA + 0.001 * i, w, h) for i in range(4)]
        with tables_derived() as derived:
            res["wavefront"].update(_frame_numbers(
                "dda frames wavefront", lambda i: r.render(sd, cams[i % 4], frame=0), 3))
        _require_cached("dda frames wavefront", derived)
        bnd = d1_frame_bound(lambda: r.render(sd, cams[0], frame=0))
        log(f"[dda frames] wavefront Renderer: D1 bound {bnd[0]:.4f} ms a frame ({bnd[1]}) "
            f"over its {bnd[2]} calls")
        res["wavefront"].update(bound_ms=bnd[0], bound_by=bnd[1])
        c1_bnd = c1_frame_bound(lambda: r.render(sd, cams[0], frame=0))
        c1_ms = res["wavefront"]["c1_device_ms_per_frame"]
        for key, (b_ms, n_calls) in c1_bnd.items():
            log(f"[dda frames] wavefront Renderer: {key} device {_opt_ms(c1_ms[key])} a frame, "
                f"bound {b_ms:.4f} ms (bytes) over its {n_calls} calls")
        res["wavefront"]["c1_bound_ms_per_frame"] = {k: v[0] for k, v in c1_bnd.items()}
        # each frame's D1 calls, captured and replayed on D1 and on the parent
        mod, _lib = parent_design("torch_dda_trials")
        for key, calls in mod.frame_calls(size).items():
            turns = dda_parent_turns(calls)
            log(f"[dda frames] {key}: its {len(calls)} D1 calls replayed, device ms a frame in "
                f"turns (D1, parent, parent, D1): D1 {_opt_ms(turns['d1'])}, parent design "
                f"(PR 14) {_opt_ms(turns['parent'])}")
            res["exact_whitted" if key == "exact whitted" else "wavefront"].update(
                replay_calls=len(calls), replay_device_ms=turns["d1"],
                parent_replay_device_ms=turns["parent"])
    return res


# ---------------------------------------------------------------------------
# The default scene as a live game: five moving volumes on B2, the game loop,
# and the differentiable surface path
# ---------------------------------------------------------------------------

MU_W, MU_H = 1280, 768                 # game_demo's frame
MU_SMALL_W, MU_SMALL_H = 320, 192
MU_BOUNCES, MU_SHADOW_ROUNDS = 2, WH_SHADOW_ROUNDS   # game_demo: --bounces 2, shadow_rounds 2
MU_FULL_PLAIN_S = 15.0                 # hold the 1280x768 frame to the plain one when
                                       # its predicted time is under this
MU_EDITS = 200
MU_COUNTS, MU_ROUNDS = (1, 3), 8       # frame timing: 32 frames, the counts in turns
GAME_FRAMES = 14                       # game_demo fires every other frame
SF_W = 512                             # BASELINE config 2: 512^2 diff. Lambertian
SF_STEPS = 20
SF_MIN_MATERIALS = 200                 # materials with a gradient in the varied copy
SF_WAVEFRONT_ATOL = 1e-4               # vs the wavefront on pixels both hit, same material
SF_WAVEFRONT_SHARE = 0.99              # of those pixels within SF_WAVEFRONT_ATOL


class ListCapture:
    """A ray-list launcher that records each list it traces, then
    launches B2 on it: the lists a frame hands the kernel."""

    def __init__(self):
        self.lists = []

    def __call__(self, o, d, tables, *, fetch_mat=False):
        from voxel_tracer_tpu_torch.ops.cuda import mega
        self.lists.append((o, d, tables, fetch_mat))
        return mega.trace_rays(o, d, tables, fetch_mat=fetch_mat)


SECTOR = 32                            # bytes: the least a load moves from memory


def list_bound_bytes(n, steps, tb, fetch_mat):
    """Bytes B2 must move for one list of n rays that takes ``steps`` DDA
    steps: each ray's origin and direction read and its 8 bytes of result
    written once; the brick bitmap once; of the occupancy words at most one
    sector a step, and of the material bytes (read only with fetch_mat) at
    most one sector a ray, neither more than the whole table."""
    nb = n * (24 + 8) + tb.bitmap.numel() * 4 + min(tb.occw.numel() * 4, SECTOR * steps)
    return nb + (min(tb.matb.numel(), SECTOR * n) if fetch_mat else 0)


def replay_lists(tag, lists):
    """B2 on every ray list of one frame, in the frame's order: held to its
    plain version list by list, CUDA-event ms for all lists, profiler
    device ms per launch, plain ms for all lists, and the bound summed
    over the lists (`list_bound_bytes`; operations from the DDA steps)."""
    from voxel_tracer_tpu_torch.ops.cuda import mega

    def run(fn):
        return [fn(o, d, tb, fetch_mat=f) for o, d, tb, f in lists]

    ks = run(mega.trace_rays)
    t0 = time.perf_counter()
    ps = run(mega.trace_rays_plain)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max((compare_traces(f"{tag} list {i}", k, p, quiet=True)
               for i, (k, p) in enumerate(zip(ks, ps))), default=0.0)
    rays = sum(o.shape[0] for o, *_ in lists)
    steps = sum(int(k["steps"].sum()) for k in ks)
    b_bytes = b_ops = 0
    for (o, _d, tb, f), k in zip(lists, ks):
        n, n_steps = o.shape[0], int(k["steps"].sum())
        b_bytes += list_bound_bytes(n, n_steps, tb, f)
        b_ops += n * MEGA_OPS_PER_RAY + n_steps * MEGA_OPS_PER_STEP
    bnd = bound(b_bytes, b_ops)
    run(mega.trace_rays)
    ms = cuda_ms(lambda i: run(mega.trace_rays), 4)
    dev = kernel_device_ms(lambda: run(mega.trace_rays), 2, "mega_rays_kernel")
    log(f"[{tag}] the frame's {len(lists)} B2 ray lists, {rays} rays "
        f"({min(o.shape[0] for o, *_ in lists)}..{max(o.shape[0] for o, *_ in lists)} a list), "
        f"{steps} DDA steps: kernel {ms:.4f} ms for all lists (events, host work included), "
        f"device {'not measured' if dev is None else f'{dev:.4f} ms a launch, {dev * len(lists):.4f} ms in all'}; "
        f"plain {plain_ms:.1f} ms; bound {bnd[0]:.4f} ms ({bnd[1]}, {b_bytes} bytes); "
        f"kernel = plain on every list (t max |d| {err:.3g})")
    return dict(lists=len(lists), rays=rays, steps=steps, ms=ms, dev_ms=dev,
                dev_total_ms=None if dev is None else dev * len(lists), plain_ms=plain_ms,
                bound=bnd, err=err)


def multi_config(width, height):
    return _multi_config(width, height, MU_BOUNCES)


def check_tables_equal(tag, isect):
    """Every device table of ``isect`` equals `pack_tables` of its volume's
    grid (full and inverted), and the DDA grid equals the grid."""
    from voxel_tracer_tpu_torch.ops.cuda import mega
    vol, dev = isect.mv.volume, isect.device
    sets = [("full", isect.full_tables, mega.pack_tables(vol.grid, vol.palette, vol.vpu, dev))]
    sets += [(f"inverted {g}", isect.inv_tables[g],
              mega.pack_tables(vol.grid, vol.palette, vol.vpu, dev, occupied=vol.grid != g))
             for g in sorted(int(g) for g in np.unique(vol.grid) if 1 <= g <= 8)]
    for name, tb, ref in sets:
        for f in ("matb", "occw", "bocc", "bitmap", "grid", "brick_occ"):
            require(bool(torch.equal(getattr(tb, f), getattr(ref, f))),
                    f"{tag}: {name} table {f} differs from a repack")
    require(bool(torch.equal(isect.grid_dda,
                             torch.from_numpy(vol.grid.astype(np.int32)).to(dev))),
            f"{tag}: grid_dda differs")
    require(bool(torch.equal(isect.brick_occ, sets[0][2].brick_occ)), f"{tag}: brick_occ")
    return len(sets)


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def multi_edits(multi_k):
    """[multi] O(1) edits: seeded set_voxel edits of drone 1 and of the
    box's glass, a drone brick carved empty and an empty box brick filled;
    every table against a repack; us per edit against MegaVolume.refresh."""
    rng = np.random.RandomState(9)
    drone, box = multi_k.vols[1], multi_k.vols[0]
    dev = box.device
    glass = np.argwhere(box.mv.volume.grid == 4)
    edits = []
    for k in range(MU_EDITS):
        if k % 2:
            z, y, x = glass[rng.randint(len(glass))]
            edits.append((box, x, y, z, int(rng.choice([0, 4, 12, 40]))))
        else:
            x, y, z = rng.randint(16, size=3)
            edits.append((drone, x, y, z, int(rng.choice([0, 17, 41, 12]))))
    sync(dev)
    t0 = time.perf_counter()
    for isect, x, y, z, val in edits:
        isect.set_voxel(int(x), int(y), int(z), val)
    sync(dev)
    us_edit = (time.perf_counter() - t0) / len(edits) * 1e6
    # a drone brick carved empty, an empty box brick filled (64 voxels)
    bz, by, bx = np.argwhere(drone.mv.volume.brick_occ > 0)[0]
    solid = np.argwhere(drone.mv.volume.grid[bz * 8:bz * 8 + 8, by * 8:by * 8 + 8,
                                             bx * 8:bx * 8 + 8] != 0)
    for z, y, x in solid + np.array([bz * 8, by * 8, bx * 8]):
        drone.set_voxel(int(x), int(y), int(z), 0)
    empty = np.argwhere(box.mv.volume.brick_occ == 0)
    require(len(empty) > 0, "the box has no empty brick to fill")
    ez, ey, ex = empty[len(empty) // 2]
    for z in range(4):
        for y in range(4):
            for x in range(4):
                box.set_voxel(int(ex * 8 + x), int(ey * 8 + y), int(ez * 8 + z), 40)
    sync(dev)
    bsx, bsy, _ = drone.full_tables.bsize
    require(int(drone.full_tables.bocc[(bz * bsy + by) * bsx + bx]) == 0,
            "carved brick still flagged")
    n_sets = (check_tables_equal("multi edits drone", drone)
              + check_tables_equal("multi edits box", box))
    t0 = time.perf_counter()
    box.mv.refresh()
    sync(dev)
    us_refresh = (time.perf_counter() - t0) * 1e6
    box.refresh_tables()
    log(f"[multi] O(1) edits: {len(edits)} seeded set_voxel edits of drone 1 and the box's "
        f"glass, {len(solid)} to carve a drone brick empty, 64 to fill an empty box brick; "
        f"{n_sets} table sets equal a repack field for field (matb, occw, bocc, bitmap, "
        f"grid, brick_occ) and grid_dda equals the grid; {us_edit:.1f} us per edit (host "
        f"clock over the {len(edits)} seeded edits, synchronized) vs MegaVolume.refresh of "
        f"the box {us_refresh:.0f} us")
    return dict(us_per_edit=us_edit, us_refresh=us_refresh,
                edits=len(edits) + len(solid) + 64)


@timed_phase
def phase_multi(device="cuda", size=(MU_W, MU_H), small=(MU_SMALL_W, MU_SMALL_H)):
    """[multi] render_whitted_multi on the reference's default scene (five
    separate volumes, drones turned) with game_demo's config at 1280x768
    (launch counts at 0 just before, read just after); the same frame
    traced by B2's plain version at 320x192 (and 1280x768 when that is
    predicted under MU_FULL_PLAIN_S), the wavefront Renderer with
    exact_fallback at 320x192, a moved drone, the frame's B2 lists alone,
    O(1) edits, frame time."""
    from voxel_tracer_tpu_torch.models.volume import VoxelVolume
    from voxel_tracer_tpu_torch.ops import composite
    from voxel_tracer_tpu_torch.ops.cuda import mega
    from voxel_tracer_tpu_torch.ops.cuda.multi import MultiMegaIntersector, render_whitted_multi
    from voxel_tracer_tpu_torch.ops.cuda.whitted import MegaIntersector
    from voxel_tracer_tpu_torch.renderer import Renderer
    t0 = time.perf_counter()
    vols, scene = multi_scene()
    sd = scene.data(device)
    mvs = [mega.MegaVolume(v, device) for v in vols]
    multi_k = build_multi(mvs)
    (w, h), (sw, sh) = size, small
    cfg, s_cfg = multi_config(w, h), multi_config(sw, sh)
    cam, s_cam = multi_camera(0.0, w, h), multi_camera(0.0, sw, sh)
    log(f"[multi] scene: {[v.grid.shape[::-1] for v in vols]} volumes, glass ids "
        f"{[i.glass_ids for i in multi_k.vols]}, {len(scene.capsules)} capsules; built in "
        f"{time.perf_counter() - t0:.1f} s")

    mega.reset_launch_counts()
    out = render_whitted_multi(multi_k, sd, cam, w, h, 0, config=cfg)
    sync(device)
    launches = dict(mega.KERNEL_LAUNCHES)
    frac, shares = check_whitted_frame("multi", out, w, h)
    log(f"[multi] render_whitted_multi at {w}x{h}, {MU_BOUNCES} bounces, {WH_GLASS_REFL} "
        f"glass reflections, {MU_SHADOW_ROUNDS} shadow rounds, compact: launches "
        f"{launches}; hit fraction {frac:.4f}, rows of hits {shares}")
    if device != "cpu":
        require(launches["mega_rays"] > 0, "kernel mega_rays was not launched on the multi path")

    res = dict(launches=launches, frac=frac, shares=shares)
    predicted = None
    if device != "cpu":
        # the lists B2 traces in this frame, replayed alone: their plain
        # time is most of the plain-traced frame's
        cap = ListCapture()
        render_whitted_multi(build_multi(mvs, trace_fn=cap), sd, cam, w, h, 0, config=cfg)
        res["lists"] = replay_lists("multi", cap.lists)
        predicted = res["lists"]["plain_ms"] / 1e3 * 1.25
    plain = build_multi(mvs, trace_fn=mega.trace_rays_plain)
    err = compare_whitted(f"multi {sw}x{sh}",
                          render_whitted_multi(multi_k, sd, s_cam, sw, sh, 0, config=s_cfg),
                          render_whitted_multi(plain, sd, s_cam, sw, sh, 0, config=s_cfg))
    if predicted is not None and predicted < MU_FULL_PLAIN_S:
        t0 = time.perf_counter()
        err = max(err, compare_whitted(f"multi {w}x{h}", out, render_whitted_multi(
            plain, sd, cam, w, h, 0, config=cfg)))
        log(f"[multi] plain-traced {w}x{h} frame in {time.perf_counter() - t0:.1f} s")
    else:
        log(f"[multi] {w}x{h} plain-traced frame not run: predicted "
            f"{'(no timing)' if predicted is None else f'{predicted:.0f} s'} from its "
            f"lists' plain time (limit {MU_FULL_PLAIN_S:.0f} s)")
    del plain

    exact = build_multi(mvs, exact_fallback=True)
    k_exact = render_whitted_multi(exact, sd, s_cam, sw, sh, 0, config=s_cfg)
    r = Renderer(s_cfg, device=device, isect=composite.PLAIN).render(sd, s_cam, frame=0)
    compare_whitted_wavefront(f"multi {sw}x{sh}", k_exact, r)
    del exact

    # a drone moved and turned by with_transforms == an intersector built
    # from the moved volume
    rot2 = np.asarray(vols[1].rot) @ np.array([[0.8, 0.6, 0.0], [-0.6, 0.8, 0.0],
                                              [0.0, 0.0, 1.0]], np.float32)
    pos2 = np.asarray(vols[1].pos) + np.array([0.3, -0.2, 0.25], np.float32)
    moved = multi_k.with_transforms([None, (rot2, pos2), None, None, None])
    v1 = VoxelVolume(vols[1].grid.copy(), vols[1].palette, pos=pos2, rot=rot2)
    fresh = MultiMegaIntersector([multi_k.vols[0],
                                  MegaIntersector(mega.MegaVolume(v1, device),
                                                  shadow_rounds=MU_SHADOW_ROUNDS, compact=True)]
                                 + multi_k.vols[2:])
    k_moved = render_whitted_multi(moved, sd, s_cam, sw, sh, 0, config=s_cfg)
    err = max(err, compare_whitted(f"multi moved drone {sw}x{sh}", k_moved,
                                   render_whitted_multi(fresh, sd, s_cam, sw, sh, 0,
                                                        config=s_cfg)))
    still = render_whitted_multi(multi_k, sd, s_cam, sw, sh, 0, config=s_cfg)
    moved_px = int((k_moved["depth"] != still["depth"]).sum())
    log(f"[multi] with_transforms moved drone 1 by (0.3, -0.2, 0.25) and turned it: "
        f"{moved_px} of {sw * sh} depths changed; equal to a fresh intersector's frame")
    require(moved_px > 0, "the moved drone changed no pixel")

    res["edits"] = multi_edits(multi_k)
    fresh = build_multi([mega.MegaVolume(VoxelVolume(v.grid.copy(), v.palette, pos=v.pos,
                                                     rot=v.rot), device) for v in vols])
    res["err"] = max(err, compare_whitted(
        f"multi edited {sw}x{sh}",
        render_whitted_multi(multi_k, sd, s_cam, sw, sh, 0, config=s_cfg),
        render_whitted_multi(fresh, sd, s_cam, sw, sh, 0, config=s_cfg)))
    if device == "cpu":
        return res

    # one camera: the compacted lists keep their sizes from frame to frame,
    # so each count times the same work
    def frame(_i):
        return render_whitted_multi(multi_k, sd, cam, w, h, 0, config=cfg)

    frame(0)
    counts = MU_COUNTS
    r = alternating_rounds(frame, counts, MU_ROUNDS, log=lambda m: log(f"[multi] {m}"))
    ms, agree = r.ms, r.agree
    before = mega.KERNEL_LAUNCHES["mega_rays"]
    wall, busy, kernels = device_busy(lambda: [frame(i) for i in range(3)])
    per_frame = (mega.KERNEL_LAUNCHES["mega_rays"] - before) / 3
    b2_dev = kernel_device_ms(lambda: frame(0), 1, "mega_rays_kernel")
    # each per-volume slab mask is one masked_apply gather: one host sync
    slab_masks = []
    slab_mask = multi_k._slab_mask
    multi_k._slab_mask = lambda v, o, d: slab_masks.append(1) or slab_mask(v, o, d)
    syncs = count_host_syncs(lambda: frame(0))
    del multi_k._slab_mask
    idle = None if busy is None else 1.0 - busy / wall
    log(f"[multi] timing {w}x{h} (after the edits): {ms[0]:.4f} ms/frame over "
        f"{counts[0]} frames, {ms[1]:.4f} over {counts[1]} (means of {MU_ROUNDS} rounds "
        f"each, in turns), {'agree' if agree else 'do NOT agree'} within {SLOPE_RTOL:.0%}; profiled 3 "
        f"frames: wall {wall / 3:.4f} ms/frame, device busy "
        f"{'not measured' if busy is None else f'{busy / 3:.4f} ms/frame'} in "
        f"{kernels / 3:.1f} kernels/frame, idle share "
        f"{'not measured' if idle is None else f'{idle:.4f}'}; mega_rays {per_frame:.1f} "
        f"launches a frame, device time per launch "
        f"{'not measured' if b2_dev is None else f'{b2_dev:.4f} ms'}; {syncs} host syncs a "
        f"frame (sync debug mode), {len(slab_masks)} of them the volumes' slab masks")
    require(agree, f"multi frame times disagree: {ms}")
    res.update(ms=ms[1], wall=wall / 3, busy=None if busy is None else busy / 3,
               kernels=kernels / 3, idle=idle, b2_per_frame=per_frame, b2_dev_ms=b2_dev,
               host_syncs=syncs, slab_mask_syncs=len(slab_masks))
    return res


PP_W, PP_H = 1280, 720                 # the wavefront frame's default size
C2_REPS = 50                           # serialized launches timed at the largest call
RACE_REPS = 20                         # the race's, at its largest call


def _same_bits(a, b):
    """Two tensors of one shape and dtype with the same bytes (NaN too)."""
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8)))


def c2_bytes(n, dirs, k):
    """The bytes a prepass call must move: each ray's origin (12 B) and
    direction (12, or none where one row is broadcast) read once, its K
    slots of t and id (8 K) written once; the group's tables, a few hundred
    bytes, left out."""
    return n * (12 + (0 if dirs.stride(0) == 0 else 12) + 8 * k)


def race_slots(group, origins, dirs, cand_t, cand_id, best=None, obj_base=0,
               max_steps=None, record=None, **kw):
    """`ops/cuda/dda.race`'s signature on its plain version, the slot loop
    (`composite._race_slots`) with C1 and D1 around each slot; ``record``
    in place of C1's record stage."""
    from voxel_tracer_tpu_torch.ops import composite, dda
    from voxel_tracer_tpu_torch.ops.cuda import composite as ck
    from voxel_tracer_tpu_torch.ops.cuda import dda as d1
    return composite._race_slots(group, origins, dirs, cand_t, cand_id, best, obj_base,
                                 dda.MAX_STEPS if max_steps is None else max_steps,
                                 ck.to_local, record or ck.record, d1.intersect_volume_local, kw)


def _cloned(x):
    return x.clone() if isinstance(x, torch.Tensor) else x


def _dirs_copy(dirs):
    """A copy of a direction array that keeps a broadcast row broadcast."""
    return dirs[:1].clone().expand_as(dirs) if dirs.stride(0) == 0 else dirs.clone()


def race_replay(fn, call):
    """``fn`` (the race or `race_slots`) on a recorded race call, merging
    into a fresh copy of the call's running record."""
    from voxel_tracer_tpu_torch.ops.composite import HitResult
    group, o, d, ct, ci, best, kw = call
    best = None if best is None else HitResult(*(x.clone() for x in best))
    return fn(group, o, d, ct, ci, best, **kw)


def race_walk_bound(call):
    """(rows, steps, (least ms, what bounds it)) of the slots a race call
    walks: the live rows of each slot of the slot loop and their steps, on
    D1's conventions (`_dda_bound`, each walked row a D1 ray with an
    object index and a per-ray vpu), and the slot loop's record."""
    from voxel_tracer_tpu_torch.ops.cuda import composite as ck
    walked = [0, 0]

    def counting(group, res, best=None, live=None, **kw):
        walked[0] += int(live.sum())
        walked[1] += int(res["steps"][live].sum())
        return ck.record(group, res, best, live=live, **kw)

    out = race_replay(lambda *a, **kw: race_slots(*a, record=counting, **kw), call)
    group, kw = call[0], call[6]
    return walked[0], walked[1], _dda_bound(walked[0], walked[1], dict(kw, oid=True), True,
                                           group.grid, group.brick_occ), out


@timed_phase
def phase_prepass(device="cuda", size=(PP_W, PP_H)):
    """[prepass] C2 and D1's candidate race on their main path: the
    wavefront Renderer (RenderConfig's defaults: full shading, 8 bounces)
    on the default scene, whose four drones are one stacked group, at
    1280x720, launch counts at 0 just before the frame: one C2 launch and
    one launch of D1's candidate race for each of the frame's prepass
    calls and no traversal on the glue; the frame equal field for field,
    bit for bit, to the same frame on the plain prepass (`composite._topk`)
    and the plain race (the slot loop, `race_slots`); then the frame's
    prepass calls replayed on C2 and on `_topk`, and its race calls on the
    race and on the slot loop, equal bit for bit, timed, and bounded: C2
    by the bytes each call must move (`c2_bytes`), the race by the slots
    it walks (`race_walk_bound`).  Returns C2's numbers and the race's for
    the `kernels` line."""
    from voxel_tracer_tpu_torch.ops import composite
    from voxel_tracer_tpu_torch.ops.cuda import composite as ck
    from voxel_tracer_tpu_torch.ops.cuda import dda as d1
    from voxel_tracer_tpu_torch.renderer import RenderConfig, Renderer
    _vols, scene = multi_scene()
    sd = scene.data(device)
    w, h = size
    cfg = RenderConfig(width=w, height=h)
    cam = multi_camera(0.0, w, h)
    real, prepass, real_race = ck.topk, composite._slab_prepass_topk, d1.race
    calls, races, n_prepass = [], [], [0]

    def recorded(group, origins, dirs, k):
        calls.append((group, origins.clone(), _dirs_copy(dirs), k))
        return real(group, origins, dirs, k)

    def recorded_race(group, origins, dirs, cand_t, cand_id, best=None, **kw):
        races.append((group, origins.clone(), _dirs_copy(dirs), cand_t.clone(),
                      cand_id.clone(), None if best is None else [x.clone() for x in best],
                      {k: _cloned(v) for k, v in kw.items()}))
        return real_race(group, origins, dirs, cand_t, cand_id, best, **kw)

    def counted(*args):
        n_prepass[0] += 1
        return prepass(*args)

    ck.reset_launch_counts()
    d1.reset_launch_counts()
    ck.topk, composite._slab_prepass_topk, d1.race = recorded, counted, recorded_race
    try:
        out = Renderer(cfg, device=device).render(sd, cam, frame=0)
        sync(device)
    finally:
        ck.topk, composite._slab_prepass_topk, d1.race = real, prepass, real_race
    counts, d1_counts = dict(ck.KERNEL_LAUNCHES), dict(d1.KERNEL_LAUNCHES)
    shapes = sorted({(c[1].shape[0], c[3], c[0].grid.shape[0], c[2].stride(0) == 0)
                     for c in calls})
    log(f"[prepass] default scene {w}x{h}, {cfg.max_bounces} bounces: {n_prepass[0]} prepass "
        f"calls, counts {counts}, D1 {d1_counts}; calls (rays, K, objects, broadcast "
        f"direction): {shapes}")
    require(counts["composite_topk"] == n_prepass[0] == len(calls) > 0,
            f"prepass: {counts['composite_topk']} C2 launches for {n_prepass[0]} calls")
    require(counts["composite_glue"] == 0, f"prepass: traversals on the glue: {counts}")
    require(d1_counts["dda_race"] == n_prepass[0] == len(races),
            f"prepass: {d1_counts['dda_race']} candidate races ({len(races)} calls) for "
            f"{n_prepass[0]} prepass calls")

    d1.reset_launch_counts()
    ck.topk, d1.race = (lambda group, o, d, k: composite._topk(group, o, d, k)), race_slots
    try:
        ref = Renderer(cfg, device=device).render(sd, cam, frame=0)
    finally:
        ck.topk, d1.race = real, real_race
    ref_d1 = dict(d1.KERNEL_LAUNCHES)
    differ = [f for f in out if isinstance(out[f], torch.Tensor)
              and not _same_bits(out[f], ref[f])]
    log(f"[prepass] the frame on the plain prepass and the slot loop: fields {sorted(out)}, "
        f"differing {differ}; D1 {ref_d1}")
    require(ref_d1["dda_race"] == 0 and ref_d1["dda_rays"] == d1_counts["dda_rays"],
            f"prepass: the slot loop's frame launched races or handed D1 other rays: "
            f"{ref_d1} against {d1_counts}")
    require(set(out) == set(ref) and not differ, f"prepass: frame fields differ: {differ}")

    unequal = sum(not all(torch.equal(a, b) for a, b in zip(real(*c), composite._topk(*c)))
                  for c in calls)
    log(f"[prepass] {len(calls)} calls replayed on C2 and on _topk: {unequal} differ")
    require(unequal == 0, f"prepass: {unequal} replayed calls differ from _topk")
    walks, race_unequal = [], 0
    for c in races:
        rows, steps, bnd_call, plain = race_walk_bound(c)
        walks.append((rows, steps, bnd_call))
        race_unequal += not all(_same_bits(a, b)
                                for a, b in zip(race_replay(real_race, c), plain))
    log(f"[prepass] {len(races)} race calls replayed on the race and on the slot loop: "
        f"{race_unequal} differ")
    require(race_unequal == 0, f"prepass: {race_unequal} replayed race calls differ from "
            f"the slot loop")

    big = max(calls, key=lambda c: (c[1].shape[0], c[3], c[2].stride(0) != 0))
    n_big, k_big = big[1].shape[0], big[3]
    ms = cuda_ms(lambda i: real(*big), C2_REPS)
    plain_ms = cuda_ms(lambda i: composite._topk(*big), 3)
    dev_frame = None
    _wall, events = device_window(lambda: [real(*c) for c in calls])
    spans = [b - a for n, a, b in events if "composite_topk_kernel" in n]
    if spans:
        dev_frame = sum(spans) / 1e3
    plain_frame = cuda_ms(lambda i: [composite._topk(*c) for c in calls], 1)
    bnd = c2_bytes(n_big, big[2], k_big) / PEAK_BYTES_PER_S * 1e3
    bnd_frame = sum(c2_bytes(c[1].shape[0], c[2], c[3]) for c in calls) / PEAK_BYTES_PER_S * 1e3
    dev = None if dev_frame is None else dev_frame / len(calls)
    log(f"[prepass] C2 at the largest call ({n_big} rays, K {k_big}): {ms:.4f} ms a call "
        f"over {C2_REPS} serialized calls (events), device {_opt_ms(dev)} a launch; _topk "
        f"{plain_ms:.4f} ms; bound {bnd:.4f} ms (bytes).  A frame's {len(calls)} calls: "
        f"device {_opt_ms(dev_frame)}, _topk {plain_frame:.4f} ms, bound {bnd_frame:.4f} ms")
    c2 = dict(launches=counts["composite_topk"], max_abs_err=0.0, ms=ms, device_ms=dev,
              plain_ms=plain_ms, bound_ms=bnd, bound_by="bytes", library_ms=None,
              rays=n_big, k=k_big, objects=big[0].grid.shape[0], calls=len(calls),
              device_ms_per_frame=dev_frame, plain_ms_per_frame=plain_frame,
              bound_ms_per_frame=bnd_frame)

    # the race: its largest call (the most rows walked) and the frame's calls
    ib = max(range(len(races)), key=lambda i: walks[i][0])
    rb = races[ib]
    # one running record, merged into again by each timed launch
    fixed = None if rb[5] is None else composite.HitResult(*(x.clone() for x in rb[5]))
    r_ms = cuda_ms(lambda i: real_race(*rb[:5], fixed, **rb[6]), RACE_REPS)
    r_plain = cuda_ms(lambda i: race_replay(race_slots, rb), 3)
    r_dev_frame = None
    _wall, events = device_window(lambda: [race_replay(real_race, c) for c in races])
    spans = [b - a for n, a, b in events if "RaceArgs" in n]
    if spans:
        r_dev_frame = sum(spans) / 1e3
    r_plain_frame = cuda_ms(lambda i: [race_replay(race_slots, c) for c in races], 1)
    r_bnd, r_by = walks[ib][2]
    r_bnd_frame = sum(wk[2][0] for wk in walks)
    by = {b: sum(wk[2][0] for wk in walks if wk[2][1] == b) for b in ("bytes", "operations")}
    rows = sum(c[3].numel() for c in races)
    walked, steps = sum(wk[0] for wk in walks), sum(wk[1] for wk in walks)
    r_dev = None if r_dev_frame is None else r_dev_frame / len(races)
    share = None if not r_dev_frame else 100.0 * r_bnd_frame / r_dev_frame
    log(f"[prepass] the race at its largest call ({rb[1].shape[0]} rays, K {rb[3].shape[1]}, "
        f"{walks[ib][0]} slots walked): {r_ms:.4f} ms a call over {RACE_REPS} serialized "
        f"calls (events); slot loop {r_plain:.4f} ms; bound {r_bnd:.4f} ms ({r_by}).  A "
        f"frame's {len(races)} calls: {rows} slot rows, {walked} walked in {steps} steps; "
        f"device {_opt_ms(r_dev_frame)} ({_opt_ms(r_dev)} a launch), slot loop "
        f"{r_plain_frame:.4f} ms, bound {r_bnd_frame:.4f} ms over the walked slots, "
        f"{'not measured' if share is None else f'{share:.1f} %'} of it")
    race = dict(launches=d1_counts["dda_race"], max_abs_err=0.0, ms=r_ms, device_ms=r_dev,
                plain_ms=r_plain, bound_ms=r_bnd, bound_by=r_by, library_ms=None,
                rays=rb[1].shape[0], k=rb[3].shape[1], objects=rb[0].grid.shape[0],
                calls=len(races), slot_rows_per_frame=rows, walked_rows_per_frame=walked,
                walked_steps_per_frame=steps, device_ms_per_frame=r_dev_frame,
                plain_ms_per_frame=r_plain_frame, bound_ms_per_frame=r_bnd_frame,
                bound_by_per_frame=max(by, key=by.get))
    return c2, race


@timed_phase
def phase_game():
    """[game] game_demo's main for GAME_FRAMES frames at 1280x768 on the card: the
    laser must carve voxels.  Returns the demo's JSON."""
    import tempfile
    from voxel_tracer_tpu_torch.examples import game_demo
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "game.json")
        t0 = time.perf_counter()
        rc = game_demo.main(["--frames", str(GAME_FRAMES), "--size", f"{MU_W}x{MU_H}",
                             "--json", path])
        with open(path) as f:
            res = json.load(f)
    log(f"[game] game_demo: {GAME_FRAMES} frames at {MU_W}x{MU_H} in "
        f"{time.perf_counter() - t0:.1f} s, exit code {rc}, {res['voxels_carved']} voxels carved, score {res['score']}")
    require(rc == 0 and res["voxels_carved"] > 0, "game_demo carved no voxel")
    return res


def palette_varied(vol, seed=13):
    """A copy of ``vol`` whose solid voxels carry seeded material ids
    1..255 (the bench grid holds one id): every palette row the surface
    path's gather and its backward touch is a different row."""
    from voxel_tracer_tpu_torch.models.volume import VoxelVolume
    ids = np.random.RandomState(seed).randint(1, 256, vol.grid.shape).astype(np.uint8)
    return VoxelVolume(np.where(vol.grid != 0, ids, 0).astype(np.uint8), vol.palette,
                       pos=vol.pos, vpu=vol.vpu)


def surface_grad(tag, mv, cam, size, pal0, tgt):
    """render_lambert_surface_mega's colour and palette gradient with the
    kernels and with render_lambert_mega_plain; fails unless the hits and
    materials are equal, the colour within SF_COLOR_ATOL and the gradient
    within SF_GRAD_RTOL x max|g|.  Returns (kernel output, gradient, launches
    of the kernel run counted from 0, colour |d|, gradient |d| / max|g|)."""
    from voxel_tracer_tpu_torch.ops import diff_surface
    from voxel_tracer_tpu_torch.ops.cuda import mega

    def color_and_grad(**kw):
        pal = pal0.clone().requires_grad_(True)
        out = diff_surface.render_lambert_surface_mega(pal, mv, cam, size, size, **kw)
        loss = torch.mean((out["color"] - tgt) ** 2)
        (g,) = torch.autograd.grad(loss, pal)
        return out, g

    mega.reset_launch_counts()
    out, g = color_and_grad()
    sync(pal0.device)
    launches = dict(mega.KERNEL_LAUNCHES)
    p_out, p_g = color_and_grad(lambert_fn=mega.render_lambert_mega_plain)
    d_col = _maxabs(out["color"].detach() - p_out["color"].detach())
    d_g = _maxabs(g - p_g) / float(p_g.abs().max())
    require(bool(torch.equal(out["hit"], p_out["hit"])) and bool(torch.equal(out["mat"],
                                                                             p_out["mat"])),
            f"{tag}: hits differ from the plain version")
    require(d_col <= SF_COLOR_ATOL, f"{tag}: colour differs by {d_col}")
    require(d_g <= SF_GRAD_RTOL, f"{tag}: gradient differs by {d_g} x max|g|")
    return out, g, launches, d_col, d_g


def surface_fit(mv, cam, size, target, steps):
    """``steps`` Adam steps of palette_fit_loss_mega from a grey palette:
    (losses, ms a step over all but the first on the host clock, profiled
    (wall ms, busy ms or None, kernels) a step or None on the CPU)."""
    from voxel_tracer_tpu_torch.ops import diff_surface
    dev = target.device
    pal = torch.full((256, 3), 0.5, device=dev, requires_grad=True)
    opt = torch.optim.Adam([pal], lr=0.05)

    def step():
        opt.zero_grad()
        loss = diff_surface.palette_fit_loss_mega(pal, mv, cam, size, size, target)
        loss.backward()
        opt.step()
        return loss.detach()

    losses = [step()]                       # the first step, untimed
    sync(dev)
    t0 = time.perf_counter()
    losses += [step() for _ in range(steps - 1)]
    sync(dev)
    ms_step = (time.perf_counter() - t0) / (steps - 1) * 1e3
    prof = None
    if dev.type != "cpu":
        wall, busy, kernels = device_busy(lambda: [step() for _ in range(3)])
        prof = (wall / 3, None if busy is None else busy / 3, kernels / 3)
    return [float(v) for v in losses], ms_step, prof


@timed_phase
def phase_surface(vol, device="cuda", size=SF_W, steps=SF_STEPS):
    """[surface] render_lambert_surface_mega on the bench scene at 512x512
    (BASELINE config 2): colour and palette gradient on the kernels equal
    the same computation on render_lambert_mega_plain, on the bench grid
    (one material) and on a palette-varied copy (`palette_varied`);
    agreement with the wavefront render_lambert_surface on pixels both hit;
    a palette fit with Adam on each."""
    from voxel_tracer_tpu_torch.models.camera import rays_for_image
    from voxel_tracer_tpu_torch.models.scene import Scene
    from voxel_tracer_tpu_torch.models.skydome import SkyDome
    from voxel_tracer_tpu_torch.ops import composite, diff_surface
    from voxel_tracer_tpu_torch.ops.cuda import mega
    mv = mega.MegaVolume(vol, device)
    mv_v = mega.MegaVolume(palette_varied(vol), device)
    cam = bench_camera(0.0, 1.0)
    n = size * size
    rng = np.random.RandomState(12)
    pal0 = torch.from_numpy(rng.rand(256, 3).astype(np.float32)).to(device)
    tgt = torch.from_numpy(rng.rand(n, 3).astype(np.float32)).to(device)

    # the main path: the bench grid's colour and gradient, counts from 0
    out, g, launches, d_col, d_g = surface_grad("surface", mv, cam, size, pal0, tgt)
    out_v, g_v, _l, d_col_v, d_g_v = surface_grad("surface varied", mv_v, cam, size, pal0,
                                                  tgt)
    mats = int((g.abs().sum(1) > 0).sum())
    mats_v = int((g_v.abs().sum(1) > 0).sum())
    require(mats_v >= SF_MIN_MATERIALS, f"surface varied: {mats_v} materials with a gradient")

    # the wavefront surface path on the same scene and palette
    sd = Scene(volumes=[vol], skydome=SkyDome.procedural(64, 32)).data(device)
    o, d = rays_for_image(cam, size, size, device=device)
    with torch.no_grad():
        wf = diff_surface.render_lambert_surface(pal0, sd, o, d, isect=composite.PLAIN)
    both = out["hit"] & wf["hit"] & (out["mat"] == wf["mat"])
    dw = (out["color"].detach() - wf["color"]).abs().amax(-1)[both]
    share = float((dw <= SF_WAVEFRONT_ATOL).float().mean())
    hit_diff = int((out["hit"] != wf["hit"]).sum())
    log(f"[surface] render_lambert_surface_mega {size}x{size}, bench scene: launches "
        f"{launches}; vs render_lambert_mega_plain: colour max |d| {d_col:.3g}, palette "
        f"gradient max |d| {d_g:.3g} x max|g| ({mats} materials with a gradient); "
        f"palette-varied copy: colour max |d| {d_col_v:.3g}, gradient max |d| {d_g_v:.3g} "
        f"x max|g| ({mats_v} materials with a gradient); vs the wavefront "
        f"render_lambert_surface: {hit_diff} of {n} hit flags differ, {int(both.sum())} "
        f"pixels hit with one material, {share:.5f} of them within {SF_WAVEFRONT_ATOL} "
        f"(max |d| {float(dw.max()):.3g})")
    require(float(out["hit"].float().mean()) > 0.1, "surface: few hits")
    require(share >= SF_WAVEFRONT_SHARE, f"surface vs wavefront: {share} within tolerance")
    require(hit_diff <= n // 1000, f"surface vs wavefront: {hit_diff} hit flags differ")

    b1 = None
    if device != "cpu":
        from voxel_tracer_tpu_torch.models.scene import SUN_DIR
        cam_p = mega.mega_camera(mv, cam, SUN_DIR, size, size)
        kw = dict(width=size, height=size, sky_mode="none", shading="raw")
        _rgba, _t, aux = mega.render_mega_tiles(cam_p, mv.tables, **kw)
        steps_b1 = int(((aux >> mega.AUX_STEPS_SHIFT) & 0x7ffff).sum())
        _nb, bnd = mega_bound(n, 12, mv.tables, steps_b1, True)
        b1 = time_kernel(f"surface B1 {size}x{size}",
                         lambda: mega.render_mega_tiles(cam_p, mv.tables, **kw),
                         lambda: mega.render_mega_tiles_plain(cam_p, mv.tables, **kw),
                         (16, 64), "mega_camera_kernel", n, bnd)

    fits = {}
    for name, m, o_ in (("bench", mv, out), ("varied", mv_v, out_v)):
        losses, ms_step, prof = surface_fit(m, cam, size, o_["color"].detach(), steps)
        fits[name] = dict(loss0=losses[0], loss1=losses[-1], ms_step=ms_step,
                          busy=None if prof is None else prof[1],
                          kernels=None if prof is None else prof[2])
        log(f"[surface] {name} grid: {steps} Adam steps of palette_fit_loss_mega (lr "
            f"0.05): loss {losses[0]:.5g} -> {losses[-1]:.5g}; {ms_step:.3f} ms a step "
            f"over the last {steps - 1} (host clock, synchronized)"
            + ("" if prof is None else
               f"; profiled 3 steps: wall {prof[0]:.3f} ms a step, device busy "
               f"{'not measured' if prof[1] is None else f'{prof[1]:.3f} ms'} in "
               f"{prof[2]:.1f} kernels a step"))
        require(losses[-1] < losses[0], f"surface {name}: the palette fit did not lower "
                                        "the loss")
    fb, fv = fits["bench"], fits["varied"]
    return dict(launches=launches, err_color=max(d_col, d_col_v), err_grad=max(d_g, d_g_v),
                materials_varied=mats_v, wavefront_share=share, wavefront_hit_diff=hit_diff,
                ms_step=fb["ms_step"], loss0=fb["loss0"], loss1=fb["loss1"], b1=b1,
                step_busy_ms=fb["busy"], step_kernels=fb["kernels"],
                ms_step_varied=fv["ms_step"], step_busy_ms_varied=fv["busy"])


# ---------------------------------------------------------------------------
# D2 / D3: the differentiable march of ops/diff.py as two kernels, on its
# own inputs and under the wavefront trainer (Trainer.fit)
# ---------------------------------------------------------------------------

MARCH_ATOL = 1e-6               # D2's fields vs the plain march: the same float32
                                # program, expf may differ in the last bit
MARCH_GRAD_RTOL = GRAD_RTOL     # D3 x max|g|: atomics and index_add_ sum in
                                # run-dependent orders, as B7 is held
MARCH_OPS_PER_RAY = 75          # slab test, reciprocals, entry cells and first
                                # crossings (diff.cu)
MARCH_OPS_PER_STEP = 10         # argmin, t_next, segment length, the step, exit tests
MARCH_OPS_PER_SEGMENT = {"fwd": 24, "bwd": 58}   # a valid segment: expf (8), alpha,
                                # w, C, D, T; D3 also the suffixes, d sigma, d albedo
MARCH_FIT_COUNTS = (2, 4)       # Trainer.fit steps of the two timed runs (D2 / D3)
MARCH_PLAIN_STEPS = 2           # steps of the plain march's timed run


def march_edge_scene():
    """tests/test_torch_diff.py's edge scene: a 16^3 random field, a fan of
    256 rays, axis-parallel rays with +-0 components and two misses (vpu
    10); and rays with one, two and three NaN direction components from
    inside the grid, from outside toward it and from outside away from it
    (their depth NaN, their first segment walked, as JAX's scan has it)."""
    rng = np.random.default_rng(0)
    sigma = rng.uniform(0, 8.0, (16, 16, 16)).astype(np.float32)
    albedo = rng.uniform(0, 1, (16, 16, 16, 3)).astype(np.float32)
    yy, zz = np.meshgrid(np.linspace(0.2, 1.4, 16), np.linspace(0.2, 1.4, 16))
    tgt = np.stack([np.full(yy.size, 1.6), yy.ravel(), zz.ravel()], -1)
    o = np.tile(np.array([-0.9, 0.8, 0.8]), (tgt.shape[0], 1))
    d = tgt - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    nan = np.nan
    nan_o = [[0.8, 0.8, 0.8]] * 6 + [[-0.5, 0.3, 0.7]] * 3 + [[3.0, 3.0, 3.0]] * 3
    nan_d = [[nan, nan, nan], [nan, 0.6, 0.8], [0.6, nan, 0.8], [0.6, 0.8, nan],
             [nan, nan, 1.0], [1.0, nan, nan], [nan, 0.6, 0.8], [1.0, nan, nan],
             [nan, 0.0, 1.0], [nan, 0.6, 0.8], [nan, -1.0, nan], [0.0, nan, 0.0]]
    o = np.concatenate([o, [[0.55, 0.85, -0.5], [-0.5, 0.3, 0.7],
                            [3.0, 3.0, 3.0], [-1.0, -1.0, -1.0]], nan_o]).astype(np.float32)
    d = np.concatenate([d, [[-0.0, 0.0, 1.0], [1.0, -0.0, 0.0],
                            [1.0, 0.0, 0.0], [0.0, 0.0, -1.0]], nan_d]).astype(np.float32)
    return sigma, albedo, o, d


def march_inputs(device="cuda", scale=1):
    """[march]'s inputs, (tag, sigma, albedo, origins, dirs, vpu, max_steps)
    on ``device``; ``scale`` divides the ray counts and grid sides (a CPU
    rehearsal).  The sixth is the wavefront Trainer.fit's first batch at
    inverse_128's width: random single rays of the step's ring views
    (`trainer.draw_batch`, seed 0), gathered in the sampler's order."""
    from voxel_tracer_tpu_torch.bench.workloads import plane_rays
    from voxel_tracer_tpu_torch.parallel import worker
    from voxel_tracer_tpu_torch.parallel.grid_train import slab_origins
    from voxel_tracer_tpu_torch.trainer import draw_batch
    from voxel_tracer_tpu_torch.utils.profiling import blob_field, ring_views

    def dev(*xs):
        return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(device) for x in xs)

    g4, n4 = 64 // scale, (512 // scale) ** 2         # workload 4 (bench_suite.py:218-247)
    s4, a4 = dev(*blob_field(g4, 0, 40.0, 0.25))
    o4, d4 = dev(*plane_rays(n4, g4, 0))
    if scale == 1:                                   # inverse_128's step
        s1, a1, o1, d1, _kw = worker.train_problem("inverse_128")
    else:
        s1, a1 = blob_field(128 // scale, 1)
        o1, d1 = ring_views(128 // scale, 32 // scale, 32, 20.0)
    n1 = o1.shape[0]
    batch = draw_batch(np.random.RandomState(0), n1, n1, "wavefront")
    ob, db = dev(o1[batch], d1[batch])
    s1, a1, o1, d1 = dev(s1, a1, o1, d1)
    zs = s1.shape[0] // 2                            # grid rank 1's slab of two
    z0 = np.float32(1) * np.float32(zs / 20.0)
    rng = np.random.RandomState(21)
    s5 = torch.where(torch.from_numpy(rng.rand(*s4.shape) < 0.5).to(device), 0.0, s4)
    a5 = a4 - 0.5
    return [("workload 4", s4, a4, o4, d4, 20.0, 128),
            ("inverse_128 step", s1, a1, o1, d1, 20.0, 192),
            ("edge rays", *dev(*march_edge_scene()), 10.0, 192),
            ("z-slab", s1[zs:], a1[zs:], slab_origins(o1, z0), d1, 20.0, 192),
            ("zeros and negatives", s5, a5, o4, d4, 20.0, 128),
            ("inverse_128 trainer batch", s1, a1, ob, db, 20.0, 192)]


def march_counts(sigma, o, d, vpu, max_steps):
    """(steps, valid segments) the march takes on these inputs, counted by
    the plain march's own set-up and step (`ops/diff.py`)."""
    from voxel_tracer_tpu_torch.ops import diff
    size3_i, (st, stepi, delta, _, t_exit) = diff._setup(sigma, o, d, vpu)
    steps = valid = 0
    for _ in range(max_steps):
        alive = int(st.alive.sum())
        if alive == 0:
            break
        steps += alive
        st, _, _, v = diff._step(st, stepi, delta, size3_i, t_exit)
        valid += int(v.sum())
    return steps, valid


def march_bound(mode, n, steps, valid, sigma):
    """Each ray's inputs read and outputs written once (D3: the saved
    outputs and cotangents read, the gradient grids written); of sigma and
    albedo a 32-byte sector each a valid segment, never more than the two
    grids; operations a ray, a step and a segment (`MARCH_OPS_*`)."""
    grids = sigma.numel() * 16
    rays = n * (24 + 20) if mode == "fwd" else n * (24 + 40) + grids
    nbytes = rays + min(2 * SECTOR * valid, grids)
    ops = n * MARCH_OPS_PER_RAY + steps * MARCH_OPS_PER_STEP + \
        valid * MARCH_OPS_PER_SEGMENT[mode]
    return bound(nbytes, ops)


def _march_loss(out, target):
    """A loss on color, trans and depth (the depth's NaN rays left out)."""
    return (torch.mean((out["color"] - target) ** 2) + 0.1 * torch.mean(out["trans"])
            + 0.01 * torch.mean(torch.nan_to_num(out["depth"], nan=0.0)))


def grad_diff(got, ref):
    """(NaN entries equal, max |d| over the reference's finite entries
    relative to its largest finite |g|, that max |d|) of gradient pairs."""
    eq, rel, ab = True, 0.0, 0.0
    for g, r in zip(got, ref):
        nan = torch.isnan(r)
        eq = eq and torch.equal(torch.isnan(g), nan)
        dd = _maxabs(torch.where(nan, 0.0, g - r))
        ab = max(ab, dd)
        rel = max(rel, dd / max(_maxabs(torch.where(nan, 0.0, r)), 1e-30))
    return eq, rel, ab


def march_pair(tag, sigma, albedo, o, d, vpu, max_steps, smi=None):
    """D2 and D3 against the plain march on one input: the fields, the
    gradients of `_march_loss` (NaN on the same entries, within
    MARCH_GRAD_RTOL elsewhere), and (given ``smi``, the card's name and
    power limit) each kernel's event and device ms, the plain halves' ms
    and the bound, D2 on the plain grids, the record's pack against
    torch's, and D2 and D3 in turns with the parent design."""
    from voxel_tracer_tpu_torch.ops import diff
    from voxel_tracer_tpu_torch.ops.cuda import diff as diff_kernel
    n = o.shape[0]
    target = torch.from_numpy(np.random.RandomState(7).rand(n, 3).astype(np.float32)).to(o.device)
    res = []
    for fn in (diff_kernel.render_density, diff.render_density):
        s, a = sigma.detach().clone().requires_grad_(), albedo.detach().clone().requires_grad_()
        out = fn(s, a, o, d, vpu, max_steps)
        outs = [out[k] for k in ("color", "trans", "depth")]
        cts = torch.autograd.grad(_march_loss(out, target), outs, retain_graph=True)
        torch.autograd.backward(outs, cts)
        res.append(([x.detach() for x in outs], cts, s.grad, a.grad))
    (ok, cts, sk, ak), (op, _, sp, ap) = res
    nan_k = [int(torch.isnan(x).sum()) for x in ok]
    nan_eq = all(torch.equal(torch.isnan(k), torch.isnan(p)) for k, p in zip(ok, op))
    err = max(_maxabs(torch.where(torch.isnan(p), 0.0, k - p)) for k, p in zip(ok, op))
    g_eq, g_rel, g_abs = grad_diff((sk, ak), (sp, ap))
    g_nan = int(torch.isnan(sk).sum()) + int(torch.isnan(ak).sum())
    zero_ok = not bool(sk[sigma <= 0].any())
    log(f"[march] {tag}: {n} rays, grid {tuple(sigma.shape)}, {max_steps} steps; D2 vs plain "
        f"color / trans / depth max |d| {err:.3g} (atol {MARCH_ATOL}), NaN depth on "
        f"{nan_k[2]} rays, equal masks {nan_eq}; D3 vs plain grad rel err {g_rel:.3g} "
        f"(rtol {MARCH_GRAD_RTOL}), max |d| {g_abs:.3g}, {g_nan} NaN entries, equal masks "
        f"{g_eq}, d sigma 0 where sigma <= 0: {zero_ok}")
    require(nan_eq and err <= MARCH_ATOL, f"{tag}: D2 differs from the plain march: {err}")
    require(g_eq and g_rel <= MARCH_GRAD_RTOL, f"{tag}: D3 differs from the plain march: {g_rel}")
    require(zero_ok, f"{tag}: D3 gives d sigma where sigma <= 0")
    require(bool((op[1] < 1).any()), f"{tag}: no ray met density")
    out = dict(rays=n, err_fwd=err, err_bwd=g_abs, grad_err_rel=g_rel)
    if smi is None:
        return out
    steps, valid = march_counts(sigma, o, d, vpu, max_steps)
    c, t, dp = (x.contiguous() for x in ok)
    s, a = sigma.contiguous(), albedo.contiguous()
    rec = diff_kernel.pack_record(s, a)

    def fwd_k():            # D2 on the record (packed once a step, beside it)
        return diff_kernel.march_fwd(s, a, o, d, vpu, max_steps, rec)

    def bwd_k():            # D3 on the record the forward saved, and its glue
        return diff_kernel.march_bwd(s, a, o, d, vpu, max_steps, c, t, dp, *cts, rec=rec)

    for mode, kfn, pfn, name in (
            ("fwd", fwd_k, lambda: diff._render_fwd_only(s, a, o, d, vpu, max_steps),
             "diff_fwd_kernel"),
            ("bwd", bwd_k, lambda: diff._render_bwd(s, a, o, d, vpu, max_steps, c, t, dp, *cts),
             "diff_bwd_kernel")):
        ms = cuda_ms(lambda i: kfn(), 10)
        dev_ms = kernel_device_ms(kfn, 3, name)
        plain_ms = cuda_ms(lambda i: pfn(), 1)
        bnd = march_bound(mode, n, steps, valid, sigma)
        log(f"[march] {tag}: {'D2' if mode == 'fwd' else 'D3'} {ms:.4f} ms a call (events), "
            f"device {'not measured' if dev_ms is None else f'{dev_ms:.4f} ms'}; plain "
            f"{plain_ms:.2f} ms; bound {bnd[0]:.4f} ms ({bnd[1]}): {steps} steps "
            f"({steps / n:.1f} a ray), {valid} valid segments; {smi}")
        out[mode] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bnd[0],
                         bound_by=bnd[1], steps=steps, valid_segments=valid)

    def fwd_grids():        # D2 on the plain grids (forward-only calls, few rays)
        return diff_kernel.march_fwd(s, a, o, d, vpu, max_steps)

    chk = diff_kernel.march_fwd(s, a, o, d, vpu, max_steps)
    g_err = max(_maxabs(torch.where(torch.isnan(p), 0.0, k - p)) for k, p in zip(chk, ok))
    require(all(torch.equal(torch.isnan(k), torch.isnan(p)) for k, p in zip(chk, ok))
            and g_err <= MARCH_ATOL, f"{tag}: D2 on the plain grids differs: {g_err}")
    out["fwd"]["grids"] = dict(ms=cuda_ms(lambda i: fwd_grids(), 10), max_abs_err=g_err,
                               device_ms=kernel_device_ms(fwd_grids, 3, "diff_fwd_kernel"))
    log(f"[march] {tag}: D2 on the plain grids {out['fwd']['grids']['ms']:.4f} ms a call "
        f"(device {_opt_ms(out['fwd']['grids']['device_ms'])}), max |d| {g_err:.3g}; {smi}")
    out["pack"] = record_pack(tag, s, a, smi)
    out["fwd"].update(march_parent_turns(tag, "fwd", (s, a, o, d, vpu, max_steps), smi))
    out["bwd"].update(march_parent_turns(tag, "bwd", (s, a, o, d, vpu, max_steps), smi))
    return out


def record_pack(tag, sigma, albedo, smi):
    """The record's pack kernel against torch's copy (`pack_record_plain`)
    on one grid: bit for bit, then timed (events; the kernel's device
    span), beside torch's copy and its library call torch.cat, and
    bounded (16 bytes a voxel read, 16 written)."""
    from voxel_tracer_tpu_torch.ops.cuda import diff as diff_kernel
    m = sigma.numel()
    rec = diff_kernel.pack_record(sigma, albedo)
    require(torch.equal(rec, diff_kernel.pack_record_plain(sigma, albedo)),
            f"{tag}: the pack kernel differs from torch's")

    def kfn():
        return diff_kernel.pack_record(sigma, albedo)

    ms = cuda_ms(lambda i: kfn(), 10)
    dev = kernel_device_ms(kfn, 3, "diff_pack_kernel")
    bnd = bound(32 * m, 0)
    out = dict(ms=ms, device_ms=dev,
               plain_ms=cuda_ms(lambda i: diff_kernel.pack_record_plain(sigma, albedo), 10),
               library_ms=cuda_ms(lambda i: torch.cat([sigma[..., None], albedo], dim=-1), 10),
               bound_ms=bnd[0], bound_by=bnd[1], max_abs_err=0.0)
    log(f"[march] {tag}: pack kernel {ms:.4f} ms (device {_opt_ms(dev)}), equal to torch's "
        f"bit for bit; torch {out['plain_ms']:.4f} ms, torch.cat {out['library_ms']:.4f} ms; "
        f"bound {bnd[0]:.4f} ms ({m} voxels); {smi}")
    return out


def march_parent_turns(tag, mode, args, smi):
    """D2's (mode "fwd": the kernel, and with the pack) or D3's (mode
    "bwd": the kernel, and with its glue: zeroed record and unpack) device
    ms beside the parent design's (the first D2 and D3: the plain grids; D3
    into two zeroed gradient grids), in turns (new, parent, parent, new)
    on march_fwd's arguments ``args``, the parent held to the plain march
    first.  The parent clamps a NaN delta: where the input has
    NaN-direction rays, both run on the others."""
    from voxel_tracer_tpu_torch.ops import diff
    from voxel_tracer_tpu_torch.ops.cuda import diff as diff_kernel
    mod, lib = parent_design("torch_diff_trials")
    (s, a, o, d, vpu, steps), dropped = mod.finite_rays(args)
    fargs = (s, a, o, d, vpu, steps)
    ref = diff._render_fwd_only(*fargs)
    if mode == "fwd":
        runs = {"new": lambda: diff_kernel.march_fwd(*fargs, diff_kernel.pack_record(s, a)),
                "parent": lambda: mod.parent_fwd(lib, *fargs)}
        mod.check_fwd(f"parent {tag}", runs["parent"](), ref)
        name = "diff_fwd_kernel"
    else:
        cts = mod.cotangents(ref)
        bargs = (*fargs, *ref, *cts)
        rec = diff_kernel.pack_record(s, a)
        runs = {"new": lambda: diff_kernel.march_bwd(*bargs, rec=rec),
                "parent": lambda: mod.parent_bwd(lib, *bargs)}
        mod.check_bwd(f"parent {tag}", runs["parent"](), diff._render_bwd(*bargs), s)
        name = "diff_bwd_kernel"
    turns = {"new": [], "parent": []}
    for who in ("new", "parent", "parent", "new"):
        turns[who].append(mod.device_ms(runs[who], 3, name))
    mean = {k: [None if any(x[j] is None for x in v) else sum(x[j] for x in v) / len(v)
                for j in (0, 1)] for k, v in turns.items()}
    kern = "D2" if mode == "fwd" else "D3"
    glue = "its pack" if mode == "fwd" else "its glue"
    log(f"[march] {tag}: {kern} in turns with the parent design (the first D2 / D3)"
        f"{', NaN-direction rays left out' if dropped else ''}, device ms a call: {kern} "
        f"{_opt_ms(mean['new'][0])}, with {glue} {_opt_ms(mean['new'][1])}; parent "
        f"{_opt_ms(mean['parent'][0])}, with its zeroing {_opt_ms(mean['parent'][1])}; {smi}")
    whole = "with_pack_device_ms" if mode == "fwd" else "whole_device_ms"
    return {"turns_device_ms": mean["new"][0], whole: mean["new"][1],
            "parent_device_ms": mean["parent"][0],
            "parent_whole_device_ms": mean["parent"][1]}


def _step_numbers(tag, run, counts, smi):
    """ms a step (CUDA events over ``counts`` steps each, run(k) runs k
    steps), and of one step: device busy, idle share, kernels (a device
    window) and host syncs."""
    ms = [cuda_ms(lambda i, k=k: run(k), 1) / k for k in counts]
    wall, busy, kernels = device_busy(lambda: run(1))
    syncs = count_host_syncs(lambda: run(1))
    idle = None if busy is None else 1.0 - busy / ms[-1]
    over = ", ".join(f"{m:.3f} ms a step over {k} steps" for m, k in zip(ms, counts))
    log(f"[march] {tag}: {over}; one profiled step: wall {wall:.3f} ms, device busy "
        f"{'not measured' if busy is None else f'{busy:.3f} ms'} in {kernels} kernels, idle "
        f"share {'not measured' if idle is None else f'{idle:.4f}'}, {syncs} host syncs; "
        f"{smi}")
    return dict(ms_per_step=ms[-1], busy_ms=busy, idle_share=idle, kernels=kernels,
                host_syncs=syncs)


def _step_split(run, ms_per_step, smi):
    """One step's device time by kernel label (D2: the pack and D2; D3)
    and glue, from a device window (up to 3, until both labels show), and
    the step's peak device memory (torch's allocator, one more step)."""
    from voxel_tracer_tpu_torch.bench.measure import split_events
    split = None
    for _ in range(3):      # a window late in a long process may miss events
        _wall, events = device_window(lambda: run(1))
        split = split_events(events, 1, ms_per_step) if events else None
        if split is not None and {"D2", "D3"} <= set(split["kernel_ms"]):
            break
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    run(1)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    log(f"[march] Trainer.fit step split: "
        + ("not measured" if split is None else
           f"{', '.join(f'{k} {v:.4f} ms' for k, v in split['kernel_ms'].items())}, glue "
           f"{split['glue_ms']:.4f} ms "
           f"({', '.join(g['name'][:40] for g in split['top_glue'][:3])})")
        + f"; peak memory {peak / 2**20:.1f} MiB ({base / 2**20:.1f} MiB held before); {smi}")
    return dict(kernel_ms=None if split is None else split["kernel_ms"],
                glue_ms=None if split is None else split["glue_ms"],
                peak_mem_bytes=peak, mem_before_bytes=base)


@timed_phase
def phase_march():
    """[march] D2 and D3 against the plain march (`ops/diff.py`) on six
    inputs: workload 4's (262,144 plane rays, 64^3 blob, 128 steps),
    inverse_128's step (131,072 ring rays, 128^3, 192 steps), the edge
    rays (+-0 and NaN directions, misses), a z-slab with shifted origins
    (as `grid_train.render_grid_sharded` passes it), sigma with zeros and
    albedo with negative entries, and the wavefront trainer's first batch
    (inverse_128's rays drawn at random); each timed and bounded, beside
    the parent design, with the record's pack kernel against torch's
    copy.  Then the main path, `Trainer.fit` (wavefront) at
    inverse_128's width, with the launch counts at 0 just before and read
    just after (one pack a step: D3 reads the record the forward saved);
    its step timed, split by kernel and glue, its peak memory, beside the
    same step through the plain march (a local loss here)."""
    from voxel_tracer_tpu_torch.ops import diff
    from voxel_tracer_tpu_torch.ops.cuda import diff as diff_kernel
    from voxel_tracer_tpu_torch.parallel import worker
    from voxel_tracer_tpu_torch.parallel.grid_train import make_optimizer
    from voxel_tracer_tpu_torch.trainer import TrainConfig, Trainer, draw_batch
    smi = nvidia_smi()
    res = {}
    for tag, *args in march_inputs():
        res[tag] = march_pair(tag, *args, smi=smi)
    err_fwd = max(r["err_fwd"] for r in res.values())
    err_bwd = max(r["err_bwd"] for r in res.values())

    s, a, o, d, kw = worker.train_problem("inverse_128")
    vpu, steps = kw["vpu"], kw["max_steps"]
    c = worker.targets(s, a, o, d, vpu, steps, "cuda").cpu().numpy()
    n = o.shape[0]
    cfg = TrainConfig(grid_size=(TRAIN_G,) * 3, vpu=vpu, lr=kw["lr"], steps=0,
                      rays_per_batch=n, march_steps=steps, sigma_init=kw["sigma_init"])
    tr = Trainer(cfg)
    losses = []

    def fit(k):
        tr.cfg.steps += k
        losses.extend(tr.fit(o, d, c, log_every=1, log_fn=lambda m: None))

    diff_kernel.reset_launch_counts()
    fit(3)                                   # the main path
    torch.cuda.synchronize()
    launches = dict(diff_kernel.KERNEL_LAUNCHES)
    log(f"[march] Trainer.fit (wavefront), {TRAIN_G}^3, {n} rays a step, {steps} march "
        f"steps: losses {[f'{v:.6g}' for v in losses]}; launches {launches}")
    require(all(np.isfinite(losses)) and losses[-1] < losses[0],
            f"the wavefront trainer's loss did not fall: {losses}")
    require(launches == {"diff_fwd": 3, "diff_bwd": 3, "diff_pack": 3},
            f"Trainer.fit did not run each step on D2 and D3 with one pack: {launches}")
    kernel = _step_numbers("Trainer.fit on D2 / D3", fit, MARCH_FIT_COUNTS, smi)
    kernel.update(_step_split(fit, kernel["ms_per_step"], smi))

    # the same step through the plain march: Trainer.fit's sampler and
    # batch copy, make_train_step's loss and Adam, on a mesh of one
    params = {k: torch.full_like(v.detach(), fill) for (k, v), fill in
              zip(tr.params.items(), (kw["sigma_init"], 0.5))}
    for v in params.values():
        v.requires_grad_()
    opt = make_optimizer(params, kw["lr"])
    rng = np.random.RandomState(0)
    plain_losses = []

    def plain_fit(k):
        for _ in range(k):
            idx = draw_batch(rng, n, n, "wavefront")
            ob, db, cb = (torch.as_tensor(np.asarray(x[idx], np.float32), device="cuda")
                          for x in (o, d, c))
            out = diff.render_density(params["sigma"], params["albedo"], ob, db, vpu, steps)
            color = out["color"] + out["trans"][:, None] * torch.zeros(3, device="cuda")
            loss = torch.mean((color - cb) ** 2)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            plain_losses.append(float(loss.detach()))

    plain_fit(1)
    rel = abs(plain_losses[0] - losses[0]) / abs(losses[0])
    log(f"[march] first step's loss: plain march {plain_losses[0]:.8g}, D2 {losses[0]:.8g}, "
        f"rel diff {rel:.3g} (rtol {PAR_RTOL_TWO}: the same forward within {MARCH_ATOL})")
    require(rel <= PAR_RTOL_TWO, f"the first step's loss differs: {rel}")
    plain = _step_numbers("the same step on the plain march", plain_fit,
                          (MARCH_PLAIN_STEPS,), smi)
    log(f"[march] Trainer.fit step at inverse_128's width: {kernel['ms_per_step']:.3f} ms on "
        f"D2 / D3, {plain['ms_per_step']:.3f} ms on the plain march "
        f"({plain['ms_per_step'] / kernel['ms_per_step']:.1f}x); {smi}")
    return dict(inputs=res, launches=launches, err_fwd=err_fwd, err_bwd=err_bwd,
                fit=kernel, fit_plain=plain)


# ---------------------------------------------------------------------------
# Sixth slice: the parallel layer (parallel/ on torch.distributed) and the
# render_vox example
# ---------------------------------------------------------------------------

PAR_STEPS = 3
PAR_RTOL_ONE = 1e-6        # the Trainer under an NCCL world of one vs one device
PAR_RTOL_TWO = 1e-5        # two ranks vs one: the same compute (test_distributed.py:94)
PAR_SLAB_RTOL = 2e-4       # overlap_slabs 4 vs 1, grid- vs ray-sharded (test_grid_train.py:111)
PAR_FULL_STEPS = 384       # > 382, the most cells a ray crosses in 128^3: no ray runs out
PAR_CHILD_TIMEOUT_S = 420  # a rank that outlives this is killed and fails the phase
PAR_TRACE_MISMATCH_BUDGET = 2   # test_grid_shard.py:59's pinned budget
PAR_TRACE_T_ATOL = 2e-3
RV_SIZE = (640, 384)


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(world, modes, backend, device, problem, timeout=PAR_CHILD_TIMEOUT_S):
    """The worker on ``world`` fresh processes (a CUDA context does not
    survive a fork, and this one holds one); rank 0's JSON line.  A rank
    that exits non-zero or outlives ``timeout`` fails the phase."""
    init = f"tcp://127.0.0.1:{free_port()}"
    cmd = [sys.executable, "-m", "voxel_tracer_tpu_torch.parallel.worker", "--world",
           str(world), "--init-method", init, "--backend", backend, "--device", device,
           "--problem", problem, "--mode", ",".join(modes), "--timeout", str(timeout)]
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(cmd + ["--rank", str(r)], cwd=ROOT, env=env, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        require(p.returncode == 0, f"rank {r} of {world} exited {p.returncode}:\n{err[-3000:]}")
    return json.loads(outs[0][0].strip().splitlines()[-1])


def _close(tag, got, ref, rtol):
    err = float(np.max(np.abs(np.asarray(got) - np.asarray(ref)) / np.abs(np.asarray(ref))))
    log(f"[parallel] {tag}: losses {[f'{v:.8g}' for v in got]} vs "
        f"{[f'{v:.8g}' for v in ref]}, max rel diff {err:.3g} (rtol {rtol})")
    require(err <= rtol, f"{tag}: losses differ by {err} (rtol {rtol})")
    return err


def _ms(res):
    """Mean ms/step after the first (warm-up) step."""
    return float(np.mean(res["ms_per_step"][1:]))


@timed_phase
def phase_parallel():
    """[parallel] The parallel layer at the width of inverse_128_32views
    (128^3 sigma + albedo, 32 ring views of 64x64 = 131,072 rays a step,
    vpu 20, Adam lr 1e-2, 192 march steps) on the wavefront march:
    Trainer.fit on one device, then under an NCCL world of one (the
    ray-sharded make_train_step), the Trainer there also built JAX-style
    with Trainer(cfg, make_ray_mesh(1)); two processes on cuda:0 over gloo: the
    ray-sharded step, overlap_slabs 4 against 1 and the grid-sharded step
    (GRID 2) against the ray-sharded one, the grid-sharded trace, and
    sharded_render against the unsharded frame."""
    import torch.distributed as dist
    from voxel_tracer_tpu_torch.parallel import distributed, mesh as pmesh, worker
    problem = worker.train_problem("inverse_128")
    one = worker.run_trainer(problem, "cuda", PAR_STEPS)
    require(one["world"] == 1, "the one-device Trainer ran on a mesh")
    distributed.initialize(init_method=f"tcp://127.0.0.1:{free_port()}", num_processes=1,
                           process_id=0, backend="nccl", device="cuda:0")
    try:
        require(dist.get_backend() == "nccl", f"backend {dist.get_backend()}, not nccl")
        nccl_tr = worker.run_trainer(problem, "cuda", PAR_STEPS, profile=device_busy)
        jax_tr = worker.run_trainer(problem, "cuda", PAR_STEPS, mesh=pmesh.make_ray_mesh(1))
        nccl = worker.run_train("replicated", problem, "cuda", PAR_STEPS)
        try:
            pmesh.make_ray_mesh(2)
            two_err = None
        except ValueError as e:
            two_err = str(e)
    finally:
        distributed.shutdown()
    require(nccl_tr["world"] == 1 and jax_tr["world"] == 1,
            "the NCCL Trainer did not run on the mesh")
    log(f"[parallel] JAX-style Trainer(cfg, make_ray_mesh(1)) under the NCCL world of one: "
        f"losses {jax_tr['losses']} vs Trainer(cfg)'s {nccl_tr['losses']}; "
        f"make_ray_mesh(2): ValueError {two_err!r}")
    require(jax_tr["losses"] == nccl_tr["losses"],
            "Trainer(cfg, make_ray_mesh(1)) trains unlike Trainer(cfg)")
    require(two_err is not None, "make_ray_mesh(2) under a world of one did not raise ValueError")
    _close("Trainer under an NCCL world of one vs one device", nccl_tr["losses"],
           one["losses"], PAR_RTOL_ONE)
    wall, busy, kernels = nccl_tr["profile"]
    idle = "not measured" if busy is None else f"{1.0 - busy / wall:.4f}"
    log(f"[parallel] NCCL world of one on {torch.cuda.get_device_name(0)}: Trainer.fit "
        f"{_ms(nccl_tr):.3f} ms/step (one device, no group: {_ms(one):.3f}); "
        f"make_train_step {_ms(nccl):.3f} ms/step, {nccl['rays_per_rank']} rays, "
        f"{nccl['march_steps']} march steps; profiled step: wall {wall:.3f} ms, device "
        f"busy {'not measured' if busy is None else f'{busy:.3f} ms'} in {kernels} "
        f"kernels, idle share {idle}")

    full = PAR_FULL_STEPS
    modes = ("probe", "replicated", f"replicated:{full}", f"overlap:{full}", f"grid:{full}",
             "trace:2", "render")
    t0 = time.perf_counter()
    two = spawn_ranks(2, modes, "gloo", "cuda:0", "inverse_128")
    wall = time.perf_counter() - t0
    m = two["modes"]
    probe = m["probe"]
    require(two["backend"] == "gloo" and two["world"] == 2 and two["device"] == "cuda:0",
            f"world of two ran as {two['backend']}, {two['world']}, {two['device']}")
    log(f"[parallel] gloo (not NCCL), two processes on cuda:0 ({wall:.1f} s with start-up): "
        f"gloo on CUDA tensors: {probe}; the mesh passes them as they are, nothing is "
        f"staged through the host")
    require(all(r == "ok" for r in probe.values()),
            f"gloo refuses CUDA tensors: {probe}; the mesh would need to stage them")
    rep, rep_full = m["replicated"], m[f"replicated:{full}"]
    _close("ray-sharded step, two ranks vs the NCCL world of one", rep["losses"],
           nccl["losses"], PAR_RTOL_TWO)
    _close(f"overlap_slabs 4 vs 1 at {full} march steps", m[f"overlap:{full}"]["losses"],
           rep_full["losses"], PAR_SLAB_RTOL)
    grid = m[f"grid:{full}"]
    _close(f"grid-sharded (GRID 2) vs ray-sharded at {full} march steps", grid["losses"],
           rep_full["losses"], PAR_SLAB_RTOL)
    slab = [TRAIN_G // 2, TRAIN_G, TRAIN_G]
    require(grid["slab_shapes"] == {"sigma": slab, "albedo": slab + [3]}
            and grid["moment_shapes"] == {"sigma": [slab] * 2, "albedo": [slab + [3]] * 2},
            f"grid ranks hold {grid['slab_shapes']}, moments {grid['moment_shapes']}")
    log(f"[parallel] two ranks sharing one card (not a scaling figure): ray-sharded "
        f"{_ms(rep):.3f} ms/step ({rep['rays_per_rank']} rays a rank, 192 march steps), "
        f"{_ms(rep_full):.3f} at {full}; overlap_slabs 4 {_ms(m[f'overlap:{full}']):.3f}; "
        f"grid-sharded {_ms(grid):.3f} (each rank's sigma, albedo and Adam moments "
        f"{slab})")
    tr = m["trace:2"]
    log(f"[parallel] grid-sharded trace, 2 slabs of the 128^3 punched sphere, "
        f"{tr['rays']} rays along +z: {tr['hits']} hits, {tr['mismatches']} hit mismatches "
        f"vs replicated (budget {PAR_TRACE_MISMATCH_BUDGET}), t max |d| {tr['t_max_diff']:.3g}, "
        f"material equal {tr['mat_equal']:.6f}, normal equal {tr['normal_equal']:.6f}; "
        f"{tr['ms']:.1f} ms")
    require(tr["mismatches"] <= PAR_TRACE_MISMATCH_BUDGET, f"trace: {tr['mismatches']} mismatches")
    require(tr["t_max_diff"] <= PAR_TRACE_T_ATOL, f"trace: t differs by {tr['t_max_diff']}")
    require(tr["mat_equal"] > 0.99 and tr["normal_equal"] > 0.99, "trace: fields differ")
    rd = m["render"]
    log(f"[parallel] sharded_render, glass box at {rd['size'][0]}x{rd['size'][1]}, full "
        f"shading over two ranks: max |d| per field vs the unsharded frame "
        f"{rd['max_abs_diff']}; hit fraction {rd['hit_fraction']:.4f}, glass "
        f"{rd['glass_hits']} and mirror {rd['mirror_hits']} hits; {rd['ms']:.1f} ms")
    require(all(v == 0.0 for v in rd["max_abs_diff"].values()),
            f"sharded frame differs: {rd['max_abs_diff']}")
    require(rd["glass_hits"] > 0 and rd["mirror_hits"] > 0, "glass and mirror not in view")
    return dict(nccl_ms=_ms(nccl), trainer_ms=_ms(nccl_tr), one_ms=_ms(one),
                gloo_ms=_ms(rep), probe=probe, trace_mismatches=tr["mismatches"],
                step_wall_ms=wall, step_busy_ms=busy, step_kernels=kernels)


@timed_phase
def phase_render_vox():
    """[render_vox] The example on a .vox file of the glass-box stand-in
    (pillar, hollow glass box, mirror, floor, drones), read back by the C
    parser and held against the numpy parse, at 640x384: flat,
    lambert and full with --fast (B1; B1 + B2; B1 + B2), launch counts at
    0 just before each and read just after; each frame held against the
    same frame through the kernels' plain versions, and its hit mask
    against the wavefront frame's (without --fast)."""
    from voxel_tracer_tpu_torch.examples import render_vox
    from voxel_tracer_tpu_torch.models import vox
    from voxel_tracer_tpu_torch.models.vox import grid_vox_bytes
    from voxel_tracer_tpu_torch.ops.cuda import mega
    from voxel_tracer_tpu_torch.utils.profiling import glass_box_scene
    merged, _ = glass_box_scene(128)
    out_dir = os.path.join(ROOT, "build", "render_vox")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "glass_box.vox")
    data = grid_vox_bytes(merged.grid, merged.palette)
    with open(path, "wb") as f:
        f.write(data)
    require(vox._native_module() is not None, "the C .vox parser (native/_voxnative) did not import")
    native, walk = vox.parse_vox(data, use_native=True), vox.parse_vox(data, use_native=False)
    require(len(native) == len(walk) == 1
            and np.array_equal(native[0].grid, walk[0].grid)
            and np.array_equal(native[0].palette, walk[0].palette)
            and np.array_equal(native[0].grid, merged.grid),
            "the C .vox parser's model differs from the numpy parse")
    log(f"[render_vox] {path}: the C parser's model equals the numpy parse "
        f"({native[0].grid.shape} grid, palette)")
    w, h = RV_SIZE
    cam = (4.5, 3.0, -7.5)
    t0 = time.perf_counter()
    ref = render_vox.render(path, w, h, "flat", cam_pos=cam)
    ref_hit = ref["depth"] < 1e29
    frac = float(ref_hit.float().mean())
    log(f"[render_vox] {w}x{h}, wavefront Renderer, flat: hit fraction {frac:.4f}, "
        f"{time.perf_counter() - t0:.2f} s")
    require(bool(torch.isfinite(ref["image"]).all()), "wavefront frame: non-finite pixels")
    require(0.05 < frac < 0.95, f"wavefront frame: hit fraction {frac}")
    launches, err = {}, 0.0
    for mode in ("flat", "lambert", "full"):
        mega.reset_launch_counts()
        t0 = time.perf_counter()
        out = render_vox.render(path, w, h, mode, fast=True, cam_pos=cam)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches[mode] = dict(mega.KERNEL_LAUNCHES)
        hit = out["depth"] < 1e29
        flips = int((hit != ref_hit).sum())
        log(f"[render_vox] {mode} --fast: hit fraction {float(hit.float().mean()):.4f}, "
            f"{flips} pixels' hit differs from the wavefront frame's (budget 0), launches "
            f"{launches[mode]}, {dt:.2f} s")
        require(bool(torch.isfinite(out["image"]).all()), f"{mode}: non-finite pixels")
        require(flips == 0, f"{mode}: hit mask differs from the wavefront frame's")
        require(launches[mode]["mega_camera"] > 0, f"{mode}: B1 was not launched")
        require(mode == "flat" or launches[mode]["mega_rays"] > 0,
                f"{mode}: B2 was not launched")
        plain = render_vox.render(path, w, h, mode, fast=True, cam_pos=cam, plain=True)
        tag = f"render_vox {mode} {w}x{h}"
        err = max(err, compare_whitted(tag, out, plain) if mode == "full"
                  else compare_frame_fields(tag, out, plain))
    png = os.path.join(out_dir, "glass_box.png")
    require(render_vox.main(["--vox", path, "--out", png, "--size", f"{w}x{h}", "--mode",
                             "full", "--fast", "--cam", ",".join(map(str, cam))]) == 0,
            "render_vox's command line failed")
    res = {k: sum(v[k] for v in launches.values()) for k in ("mega_camera", "mega_rays")}
    return dict(res, err=err)


# the suite's timed rounds of each frame count and profiled frames here
# (its defaults 5 and 8): what checks every workload within this script's
# time limit
SUITE_ROUNDS, SUITE_PROFILE_FRAMES = 1, 1
SUITE_TIMEOUT_S = 600


@timed_phase
def phase_suite(rounds=SUITE_ROUNDS, profile_frames=SUITE_PROFILE_FRAMES):
    """[suite] The port's benchmark, `python -m voxel_tracer_tpu_torch.bench`
    (every workload, one after the other in one process, `rounds` timed
    rounds of each frame count, `profile_frames` in the profiler window),
    in a subprocess: exit code 0, one line a workload, every line correct.
    Each line is printed here."""
    from voxel_tracer_tpu_torch.bench.workloads import WORKLOADS
    torch.cuda.empty_cache()
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    args = ["--rounds", str(rounds), "--profile-frames", str(profile_frames), "--one-process"]
    proc = subprocess.run([sys.executable, "-m", "voxel_tracer_tpu_torch.bench", *args],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=SUITE_TIMEOUT_S)
    lines = []
    for text in proc.stdout.splitlines():
        if text.startswith("{"):
            lines.append(json.loads(text))
            log(f"[suite] {text}")
    names = [ln.get("metric") for ln in lines]
    log(f"[suite] python -m voxel_tracer_tpu_torch.bench {' '.join(args)}: exit code "
        f"{proc.returncode}, {len(lines)} lines in {time.perf_counter() - t0:.1f} s; "
        f"correct: {[ln.get('correct') for ln in lines]}")
    require(proc.returncode == 0, f"the suite exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    require(names == list(WORKLOADS), f"the suite's lines are {names}")
    require(all(ln.get("correct") is True for ln in lines), "a suite line is not correct")
    return lines


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from voxel_tracer_tpu_torch.models.volume import VoxelVolume
    from voxel_tracer_tpu_torch.ops.cuda import mega

    t_start = time.perf_counter()
    smi = nvidia_smi()
    log(f"[device] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    phase_build()

    vol = VoxelVolume.noise_filled((64, 64, 64), pos=(0, 0, 0), vpu=20.0)
    mv = mega.MegaVolume(vol, device="cuda")
    launches, frame_steps = phase_main_path(mv)
    err_cam = phase_small_reference()
    o_rand, d_rand = random_rays()
    rays = phase_trace_rays("trace_rays random", mv, o_rand, d_rand, True)
    err_cam = max(err_cam, phase_flat("flat frame", mv, bench_camera(0.0, W / H)))
    err_cam = max(err_cam, phase_lit(mv))
    phase_lambert_accumulate(mv)
    o_sh, d_sh = lit_shadow_rays(mv, bench_camera(0.0, W / H))
    shadow = phase_trace_rays("trace_rays lit shadow", mv, o_sh, d_sh, False)
    del o_sh, d_sh
    err_rays = max(rays["err"], shadow["err"], phase_budget())
    err_cam = max(err_cam, phase_large_grid())
    times = phase_timing(mv)
    cam_bytes, cam_bound = mega_bound(W * H, 12, mv.tables, frame_steps, True)
    dev = times["flat kernel device"]
    log(f"[timing] camera kernel bound {cam_bound[0]:.4f} ms ({cam_bound[1]}): "
        f"{cam_bytes} bytes, {frame_steps} DDA steps; "
        f"{'not measured' if dev is None else f'{frame_steps / dev * 1e3:.4g}'} "
        f"DDA steps/s (device time)")

    scene = diff_scene()
    diffint_res = phase_diffint(scene)
    phase_finite_difference(scene)
    phase_slabs(scene)
    del scene
    train = phase_train()

    kr = phase_kernel_renderer()
    phase_two_volumes()
    api = phase_api()
    ind = phase_indep(mv, o_rand, d_rand)
    new_times = phase_new_timing(kr, api, ind, mv, o_rand, d_rand)
    wh = phase_whitted()
    dda_lists_res, dda_err = phase_dda(vol, o_rand, d_rand)
    dfr = phase_dda_frames()
    mu = phase_multi()
    c2, race = phase_prepass()
    game = phase_game()
    surf = phase_surface(vol)
    march = phase_march()
    par = phase_parallel()
    rv = phase_render_vox()
    phase_suite()

    log(f"[phases] seconds: {json.dumps({k: round(v, 1) for k, v in PHASE_S.items()})}")
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    log(smi)
    src = "voxel_tracer_tpu_torch/csrc/mega.cu"
    isrc = "voxel_tracer_tpu_torch/csrc/diffint.cu"

    def row(t):
        return dict(ms=t["ms"], differential_ms=t["diff_ms"], device_ms=t["dev_ms"],
                    plain_ms=t["plain_ms"], bound_ms=t["bound"][0], bound_by=t["bound"][1])

    # launches: the main path's 1280x768 frame, counted from 0
    whitted = dict(launches=wh["launches"]["mega_rays"],
                   camera_launches=wh["launches"]["mega_camera"],
                   window_launches_per_frame=wh["b2_window_per_frame"],
                   device_ms=wh["b2_dev_ms"], frame_ms=wh["ms"],
                   frame_uncompacted_ms=wh["uncompacted_ms"],
                   frame_differential_ms=wh["diff_ms"],
                   frame_device_busy_ms=wh["busy"], kernels_per_frame=wh["kernels"],
                   idle_share=wh["idle"], max_abs_err=wh["err"],
                   bench_suite_launches_per_frame=wh["expected"] - 1,
                   lists=wh["lists"]["lists"], lists_rays=wh["lists"]["rays"],
                   lists_ms=wh["lists"]["ms"], lists_device_ms=wh["lists"]["dev_total_ms"],
                   lists_plain_ms=wh["lists"]["plain_ms"],
                   lists_bound_ms=wh["lists"]["bound"][0],
                   lists_bound_by=wh["lists"]["bound"][1])
    # launches: the default scene's 1280x768 frame, counted from 0
    multi = dict(launches=mu["launches"]["mega_rays"],
                 window_launches_per_frame=mu["b2_per_frame"], device_ms=mu["b2_dev_ms"],
                 frame_ms=mu["ms"], frame_device_busy_ms=mu["busy"],
                 kernels_per_frame=mu["kernels"], idle_share=mu["idle"],
                 host_syncs_per_frame=mu["host_syncs"],
                 slab_mask_syncs_per_frame=mu["slab_mask_syncs"], max_abs_err=mu["err"],
                 lists=mu["lists"]["lists"], lists_rays=mu["lists"]["rays"],
                 lists_ms=mu["lists"]["ms"], lists_device_ms=mu["lists"]["dev_total_ms"],
                 lists_plain_ms=mu["lists"]["plain_ms"],
                 lists_bound_ms=mu["lists"]["bound"][0],
                 lists_bound_by=mu["lists"]["bound"][1],
                 us_per_edit=mu["edits"]["us_per_edit"],
                 us_per_refresh=mu["edits"]["us_refresh"],
                 game=dict((k, game.get(k)) for k in (
                     "wall_fps", "render_ms_per_frame", "sim_ms_per_frame", "voxels_carved",
                     "score", "kernels_per_frame", "b2_launches_per_frame",
                     "host_syncs_per_frame", "idle_share")))
    surface = dict(launches=surf["launches"]["mega_camera"],
                   shadow_launches=surf["launches"]["mega_rays"],
                   max_abs_err=surf["err_color"], grad_err_rel=surf["err_grad"],
                   wavefront_share=surf["wavefront_share"], ms_per_step=surf["ms_step"],
                   step_device_busy_ms=surf["step_busy_ms"],
                   step_kernels=surf["step_kernels"],
                   materials_varied=surf["materials_varied"],
                   ms_per_step_varied=surf["ms_step_varied"],
                   step_device_busy_ms_varied=surf["step_busy_ms_varied"],
                   loss_first=surf["loss0"], loss_last=surf["loss1"], **row(surf["b1"]))
    kernels = [
        dict(name="mega_camera", route="cuda", source=src,
             replaces="voxel_tracer_tpu/ops/pallas/mega.py:2536",
             launches=launches["mega_camera"], max_abs_err=err_cam,
             ms=times["flat kernel"], differential_ms=times["flat kernel differential"],
             device_ms=times["flat kernel device"], plain_ms=times["flat plain"],
             bound_ms=cam_bound[0], bound_by=cam_bound[1], library_ms=None,
             surface=surface, render_vox=dict(launches=rv["mega_camera"], max_abs_err=rv["err"])),
        dict(name="mega_rays", route="cuda", source=src,
             replaces="voxel_tracer_tpu/ops/pallas/mega.py:2810",
             launches=launches["mega_rays"], max_abs_err=err_rays,
             ms=rays["ms"], differential_ms=rays["diff_ms"], device_ms=rays["dev_ms"],
             plain_ms=rays["plain_ms"], bound_ms=rays["bound"][0],
             bound_by=rays["bound"][1], library_ms=None,
             lit_shadow_rays=dict(ms=shadow["ms"], differential_ms=shadow["diff_ms"],
                                  device_ms=shadow["dev_ms"], plain_ms=shadow["plain_ms"],
                                  bound_ms=shadow["bound"][0], bound_by=shadow["bound"][1]),
             whitted=whitted, multi=multi, render_vox=dict(launches=rv["mega_rays"], max_abs_err=rv["err"]))]
    for name, mode, line, err in (
            ("integrate_fwd", "fwd", 511, max(train["err_fwd"], diffint_res["err_fwd"])),
            ("integrate_bwd", "bwd", 544, max(train["err_bwd"], diffint_res["err_bwd"]))):
        t, t_dl = train[mode], diffint_res[mode]
        kernels.append(dict(
            name=name, route="cuda", source=isrc,
            replaces=f"voxel_tracer_tpu/ops/pallas/diffint.py:{line}",
            launches=train["launches"][name], max_abs_err=err,
            ms=t["ms"], differential_ms=t["diff_ms"], device_ms=t["dev_ms"],
            plain_ms=t["plain_ms"], bound_ms=t["bound"][0], bound_by=t["bound"][1],
            library_ms=None, dup_warp_step_share=train["dup"],
            diff_lambert_512=dict(ms=t_dl["ms"], differential_ms=t_dl["diff_ms"],
                                  device_ms=t_dl["dev_ms"], bound_ms=t_dl["bound"][0],
                                  dup_warp_step_share=diffint_res["dup"])))
    coherent_rows = {key.replace(" ", "_"): row(new_times[f"coherent {key}"])
                     for key in ("crate shadow", "random", "bench primary", "bench shadow",
                                 "turned volume")}
    for name, src_name, line, launches_n, err, t, extra in (
            ("coherent", "coherent", "coherent.py:444", kr["launches"], kr["err"],
             new_times["coherent crate primary"],
             dict(coherent_rows, bench_launches=kr["bench_launches"],
                  indep_rays_bench_primary=row(new_times["indep_rays bench primary"]),
                  api=dict(launches=api["launches"], max_abs_err=api["err"]))),
            ("indep_camera", "indep", "indep.py:468", ind["launches"]["indep_camera"],
             ind["err_cam"], new_times["indep_camera"],
             {"grid_128": row(new_times["indep_camera 128^3"])}),
            ("indep_rays", "indep", "indep.py:523", ind["launches"]["indep_rays"],
             ind["err_rays"], new_times["indep_rays"],
             {"budget_rays": row(new_times["indep_rays budget"])})):
        kernels.append(dict(
            name=name, route="cuda", source=f"voxel_tracer_tpu_torch/csrc/{src_name}.cu",
            replaces=f"voxel_tracer_tpu/ops/pallas/{line}", launches=launches_n,
            max_abs_err=err, **row(t), library_ms=None, **extra))
    rnd = dda_lists_res["random"]
    kernels.append(dict(
        name="dda", route="cuda", source="voxel_tracer_tpu_torch/csrc/dda.cu",
        replaces="voxel_tracer_tpu/ops/dda.py:169",
        launches=dfr["exact_whitted"]["launches"] + dfr["wavefront"]["launches"],
        max_abs_err=max(dda_err, dfr["exact_whitted"]["max_abs_err"],
                        dfr["wavefront"]["max_abs_err"]),
        ms=rnd["ms"], device_ms=rnd["device_ms"], plain_ms=rnd["plain_ms"],
        bound_ms=rnd["bound_ms"], bound_by=rnd["bound_by"], library_ms=None,
        parent_device_ms=rnd["parent_device_ms"],
        edits=dda_lists_res.pop("edits"),
        lists={k.replace(" ", "_"): v for k, v in dda_lists_res.items()},
        exact_whitted=dfr["exact_whitted"], wavefront=dfr["wavefront"]))
    wf = dfr["wavefront"]
    for name, line in (("composite_local", 69), ("composite_record", 76)):
        n = wf["c1_launches"][name]
        dev, bnd = wf["c1_device_ms_per_frame"][name], wf["c1_bound_ms_per_frame"][name]
        kernels.append(dict(
            name=name, route="cuda", source="voxel_tracer_tpu_torch/csrc/composite.cu",
            replaces=f"voxel_tracer_tpu/ops/composite.py:{line}", launches=n,
            max_abs_err=wf["max_abs_err"], ms=None,
            device_ms=None if dev is None else dev / n, plain_ms=None, bound_ms=bnd / n,
            bound_by="bytes", library_ms=None, device_ms_per_frame=dev,
            bound_ms_per_frame=bnd, traversal_calls=wf["traversal_calls"]))
    kernels.append(dict(name="composite_topk", route="cuda",
                        source="voxel_tracer_tpu_torch/csrc/composite.cu",
                        replaces="voxel_tracer_tpu/ops/composite.py:98", **c2))
    kernels.append(dict(name="dda_race", route="cuda", source="voxel_tracer_tpu_torch/csrc/dda.cu",
                        replaces="voxel_tracer_tpu/ops/composite.py:144", **race))
    inv = march["inputs"]["inverse_128 step"]
    for name, mode, line in (("diff_fwd", "fwd", 87), ("diff_bwd", "bwd", 140)):
        t = inv[mode]
        whole = "with_pack_device_ms" if mode == "fwd" else "whole_device_ms"
        kernels.append(dict(
            name=name, route="cuda", source="voxel_tracer_tpu_torch/csrc/diff.cu",
            replaces=f"voxel_tracer_tpu/ops/diff.py:{line}", launches=march["launches"][name],
            max_abs_err=march[f"err_{mode}"], ms=t["ms"], device_ms=t["device_ms"],
            plain_ms=t["plain_ms"], bound_ms=t["bound_ms"], bound_by=t["bound_by"],
            library_ms=None, **{whole: t[whole], "parent_device_ms": t["parent_device_ms"]},
            grad_err_rel=max(r["grad_err_rel"] for r in march["inputs"].values()),
            inputs={k.replace(" ", "_"): v[mode] for k, v in march["inputs"].items()},
            trainer_fit=march["fit"], trainer_fit_plain=march["fit_plain"]))
    # the record's pack feeds D2 and D3 (the forward packs once a step)
    t = inv["pack"]
    kernels.append(dict(
        name="diff_pack", route="cuda", source="voxel_tracer_tpu_torch/csrc/diff.cu",
        replaces="voxel_tracer_tpu/ops/diff.py:87", launches=march["launches"]["diff_pack"],
        max_abs_err=t["max_abs_err"], ms=t["ms"], device_ms=t["device_ms"],
        plain_ms=t["plain_ms"], bound_ms=t["bound_ms"], bound_by=t["bound_by"],
        library_ms=t["library_ms"],
        grids={k.replace(" ", "_"): v["pack"] for k, v in march["inputs"].items()}))
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
