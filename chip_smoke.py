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
  grid, `render_lambert_fast` and `render_flat_fast` at 1920x1088 on the
  coherent kernel (B5), then B5 against its plain version on the frame's
  own primary and shadow ray lists, and an unbaked two-volume scene;
- the independent DDA: `render_indep` flat and lambert at 1920x1088 on the
  bench scene (B3) and `trace_rays_indep` on 1 M random rays (B4).

Each main path runs with the launch counts set to 0 just before it and
read just after.  It prints one line per phase, then the card's name and
power limit as nvidia-smi reports them, then

    {"kernels": [{"name", "route", "source", "replaces", "launches",
                  "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
                  "bound_by", "library_ms"}, ...]}

and, as the last line, {"ok": true, "device": {...}}.  `ms` is CUDA-event
time per call over serialized calls, host work of the wrapper included;
`device_ms` the kernel's own span per launch in a `torch.profiler` window
(null where the profiler shows no device events).  `bound_ms` is the
larger of the bytes the call must move over 3.35 TB/s and its FP32
operations (counted from this run's data, per-unit counts read off the
kernel sources) over 67 TFLOP/s, the H100 SXM's published peaks.  The
two integrate rows (B6, B7) also carry `differential_ms` (per-call time
from two call counts), `dup_warp_step_share` (share of warp-steps in which
two of 32 consecutive rays meet one voxel, counted by the plain march) at
training shapes, and the same numbers on diff_lambert_512.  Serialized
calls find their tables warm in L2, as the trainer's backward finds the
forward's.
Any failed check raises, and the script exits non-zero without printing a
result; so does a machine without a CUDA device, or a directory without
the repository.

Run from the repository root:  python3 chip_smoke.py
"""

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
W, H = 1920, 1088
SUN = (-0.619501, 0.465931, -0.631765)
N_RAYS = 1 << 20
# kernel vs plain version on identical rays: the traversal is the same
# float32 program, so hits, materials, axes and steps must be equal
HIT_MISMATCH_BUDGET = 0
T_ATOL = 1e-5       # depth, kernel vs plain
LSB = 1             # image, kernel vs plain (expf may differ by an ulp)
SLOPE_RTOL = 0.10   # per-frame times at two frame counts agree within this

# integrate kernels (B6/B7) vs their plain versions on identical inputs
INT_ATOL = 1e-5     # color, trans, depth (expf may differ by an ulp)
GRAD_RTOL = 1e-4    # x max|g|: atomics and index_add_ sum in run-dependent orders
# render_density_slabs(n_slabs=2) vs render_density_mega (the CPU tests')
SLAB_ATOL = 5e-5
SLAB_GRAD_RTOL = 5e-3
FD_RTOL = 0.05      # central difference vs the kernel gradient
DIFF_G, DIFF_W, DIFF_VPU, T_EPS = 64, 512, 20.0, 1e-4
TRAIN_G, TRAIN_VIEWS, TRAIN_PX, TRAIN_VPU = 128, 32, 64, 20.0

# bounds: H100 SXM published peaks (HBM3 rate, FP32 non-tensor rate)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
# FP32 operations per unit of work, counted off the kernel sources
MEGA_OPS_PER_RAY = 120          # raygen, slab test, DDA set-up, shading (mega.cu)
MEGA_OPS_PER_STEP = 8           # one DDA step, brick entry amortized
INT_OPS_PER_RAY = 65            # slab test, signs, first brick (diffint.cu)
INT_OPS_PER_BRICK_STEP = 38     # brick planes, [tn, tf], exit axis
INT_OPS_PER_VISIT = 43          # fine entry of an occupied brick
INT_OPS_PER_FINE_STEP = {"fwd": 29, "bwd": 60}
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


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def bench_camera(theta, aspect):
    """bench.py's orbit camera."""
    from voxel_tracer_tpu_torch.models.camera import Camera
    px = 2.0 * math.cos(theta) + 2.4 * math.sin(theta)
    pz = -2.4 * math.cos(theta) + 2.0 * math.sin(theta)
    return Camera.create((px, 1.4, pz), (0.0, 0.0, 0.0), aspect)


def require(cond, what):
    if not cond:
        raise AssertionError(what)


def bound(nbytes, ops):
    """(least ms, what bounds it) for moving nbytes and doing ops FP32
    operations at the card's published peaks."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FP32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_ms(fn, reps):
    """Device time per call of ``fn(i)`` over ``reps`` serialized calls."""
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for i in range(reps):
        fn(i)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


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


def phase_trace_rays(mv, o_t, d_t):
    from voxel_tracer_tpu_torch.ops.cuda import mega
    kr = mega.trace_rays(o_t, d_t, mv.tables, fetch_mat=True)
    pr = mega.trace_rays_plain(o_t, d_t, mv.tables, fetch_mat=True)
    torch.cuda.synchronize()
    hk, hp = kr["t"] < mega.BIG, pr["t"] < mega.BIG
    both = hk & hp
    dt = float((kr["t"][both] - pr["t"][both]).abs().max())
    eq = {f: bool(torch.equal(kr[f], pr[f])) for f in ("mat", "ax", "steps", "resolved")}
    log(f"[trace_rays] {N_RAYS} random local rays: hit mismatches "
        f"{int((hk != hp).sum())}, equal {eq}, t max |d| {dt:.3g}, "
        f"hit fraction {float(hk.float().mean()):.4f}, "
        f"unresolved {int((~kr['resolved']).sum())}")
    require(bool(torch.equal(hk, hp)), "trace_rays hit masks differ")
    require(all(eq.values()), f"trace_rays fields differ: {eq}")
    require(dt <= T_ATOL, f"trace_rays t differs by {dt}")
    ms = cuda_ms(lambda i: mega.trace_rays(o_t, d_t, mv.tables, fetch_mat=True), 20)
    dev_ms = kernel_device_ms(lambda: mega.trace_rays(o_t, d_t, mv.tables, fetch_mat=True),
                              20, "mega_rays_kernel")
    plain_ms = cuda_ms(lambda i: mega.trace_rays_plain(o_t, d_t, mv.tables,
                                                       fetch_mat=True), 2)
    dev = "not measured" if dev_ms is None else f"{dev_ms:.4f} ms"
    log(f"[trace_rays] kernel {ms:.4f} ms (device time per launch {dev}), plain "
        f"{plain_ms:.2f} ms per {N_RAYS} rays ({N_RAYS / ms * 1e3:.4g} vs "
        f"{N_RAYS / plain_ms * 1e3:.4g} rays/s)")
    tb = mv.tables
    nbytes = N_RAYS * (24 + 8) + tb.bocc.numel() * 4 + tb.occw.numel() * 4 + tb.matb.numel()
    b = bound(nbytes, N_RAYS * MEGA_OPS_PER_RAY
              + int(kr["steps"].sum()) * MEGA_OPS_PER_STEP)
    log(f"[trace_rays] bound {b[0]:.4f} ms ({b[1]}): {nbytes} bytes, "
        f"{int(kr['steps'].sum())} DDA steps")
    return dict(err=dt, ms=ms, dev_ms=dev_ms, plain_ms=plain_ms, bound=b)


def phase_flat(tag, mv, cam):
    from voxel_tracer_tpu_torch.ops.cuda import mega
    cam_p = mega.mega_camera(mv, cam, SUN, W, H)
    k = mega.render_mega_tiles(cam_p, mv.tables, width=W, height=H)
    p = mega.render_mega_tiles_plain(cam_p, mv.tables, width=W, height=H)
    torch.cuda.synchronize()
    return compare_frames(tag, k, p)


def phase_lit(mv):
    from voxel_tracer_tpu_torch.ops.cuda import mega
    cam = bench_camera(0.0, W / H)
    k = mega.render_lambert_mega(mv, cam, W, H, sun_dir=SUN)
    p = mega.render_lambert_mega_plain(mv, cam, W, H, sun_dir=SUN)
    torch.cuda.synchronize()
    hk, hp = k["depth"] < mega.BIG, p["depth"] < mega.BIG
    flips = int((hk != hp).sum())
    both = hk & hp
    lsb = int((k["image"].int() - p["image"].int()).abs().max())
    dt = float((k["depth"][both] - p["depth"][both]).abs().max())
    dirr = float((k["irradiance"] - p["irradiance"]).abs().max())
    eq = {f: bool(torch.equal(k[f], p[f])) for f in ("normal", "material", "steps")}
    log(f"[lit frame] render_lambert_mega {W}x{H}: hit-mask mismatches {flips}, "
        f"image {lsb} LSB, depth {dt:.3g}, irradiance {dirr:.3g}, equal {eq}")
    require(flips <= HIT_MISMATCH_BUDGET, f"lit frame: {flips} hit-mask mismatches")
    require(lsb <= LSB and dt <= T_ATOL and dirr <= T_ATOL, "lit frame differs")
    require(all(eq.values()), f"lit frame fields differ: {eq}")
    return dt


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
    dev_ms = kernel_device_ms(lambda: flat(mega.render_mega_tiles)(0), 16,
                              "mega_camera_kernel")
    log(f"[timing] flat kernel device time per launch "
        f"{'not measured' if dev_ms is None else f'{dev_ms:.4f} ms'}")
    out["flat kernel device"] = dev_ms
    return out


# ---------------------------------------------------------------------------
# Training slice: the integrate kernels B6 / B7 and Trainer.fit
# ---------------------------------------------------------------------------

def blob_field(g, seed, peak, scale):
    """bench_suite.py's sparse blob: a Gaussian with exact zeros outside
    (~15 % of voxels occupied), random density inside, random albedo."""
    rng = np.random.RandomState(seed)
    zz, yy, xx = np.meshgrid(*[np.linspace(0, 1, g)] * 3, indexing="ij")
    r2 = (xx - 0.5) ** 2 + (yy - 0.5) ** 2 + (zz - 0.5) ** 2
    blob = peak * np.exp(-r2 * 60.0)
    sigma = np.where(blob > 0.05, rng.rand(g, g, g) * blob * scale, 0.0)
    albedo = rng.rand(g, g, g, 3)
    return (torch.tensor(sigma, dtype=torch.float32, device="cuda"),
            torch.tensor(albedo, dtype=torch.float32, device="cuda"))


def diff_scene():
    """diff_lambert_512 (bench_suite.py:183-210) made with numpy: the 64^3
    blob and 512x512 camera rays in 32x32-pixel tile order, taken as
    volume-local rays, with random targets."""
    from voxel_tracer_tpu_torch.models.camera import Camera, rays_for_image
    from voxel_tracer_tpu_torch.ops.cuda import diffint
    sigma, albedo = blob_field(DIFF_G, 0, 40.0, 0.25)
    cam = Camera.create((2.0, 1.4, -2.4), (0.0, 0.0, 0.0), 1.0)
    o, d = (diffint.tile_raster(x, DIFF_W, DIFF_W).contiguous()
            for x in rays_for_image(cam, DIFF_W, DIFF_W))
    n = o.shape[0]
    target = torch.from_numpy(np.random.RandomState(7).rand(n, 3).astype(np.float32)).cuda()
    return dict(sigma=sigma, albedo=albedo, o=o, d=d, target=target, vpu=DIFF_VPU)


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


def phase_diffint(scene):
    """[diffint fwd] + [diffint bwd]: the diff_lambert_512 scene."""
    return integrate_pair("diffint", scene["sigma"], scene["albedo"], scene["o"],
                          scene["d"], scene["vpu"], scene["target"], (20, 80))


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


def train_views():
    """inverse_128_32views (bench_suite.py:480-506): 32 ring views of
    64x64 pixels around the 128^3 grid, rays in tile order (numpy)."""
    from voxel_tracer_tpu_torch.models.camera import Camera, rays_for_image
    from voxel_tracer_tpu_torch.ops.cuda import diffint
    center = TRAIN_G / (2 * TRAIN_VPU)
    os_, ds_ = [], []
    for v in range(TRAIN_VIEWS):
        th = 2 * np.pi * v / TRAIN_VIEWS
        r = 2.2 * TRAIN_G / TRAIN_VPU / 4
        pos = (center + r * np.cos(th), center * 1.35, center + r * np.sin(th))
        cam = Camera.create(pos, (center,) * 3, 1.0)
        o, d = rays_for_image(cam, TRAIN_PX, TRAIN_PX, device="cpu")
        os_.append(diffint.tile_raster(o.numpy(), TRAIN_PX, TRAIN_PX))
        ds_.append(diffint.tile_raster(d.numpy(), TRAIN_PX, TRAIN_PX))
    return (np.ascontiguousarray(np.concatenate(os_)),
            np.ascontiguousarray(np.concatenate(ds_)))


def kernel_device_ms(fn, reps, name):
    """Mean device time of the kernels whose name contains ``name`` over
    ``reps`` calls of fn(), from torch.profiler's kernel spans (None if
    the profiler shows no device events)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and name in e.name]
    return sum(spans) / len(spans) / 1e3 if spans else None


def device_busy(fn):
    """(wall ms, device-busy ms or None, kernels) of fn() under
    torch.profiler: busy is the union of the device kernels' spans."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, -float("inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return wall, (busy / 1e3 if spans else None), len(spans)


def phase_train():
    """[train] The training main path: Trainer.fit, kernel backend, at the
    width of inverse_128_32views, on targets rendered by the kernel forward
    of a known field.  Launch counts at 0 just before, read just after."""
    from voxel_tracer_tpu_torch.ops.cuda import diffint
    from voxel_tracer_tpu_torch.trainer import TrainConfig, Trainer
    o, d = train_views()
    n = o.shape[0]
    true_s, true_a = blob_field(TRAIN_G, 1, 40.0, 0.25)
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

def compare_traces(tag, k, p):
    """Ray-list outputs of a kernel and its plain version: hit mask and
    every integer field equal, t within T_ATOL; returns max |dt|."""
    hk, hp = k["t"] < 1e30, p["t"] < 1e30
    both = hk & hp
    dt = _maxabs(k["t"][both] - p["t"][both])
    eq = {f: bool(torch.equal(k[f], p[f]))
          for f in ("vox", "mat", "ax", "steps", "resolved") if f in p}
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
    """Rays read once (24 B), outputs written once (20 B), tables read once;
    operations counted from the walk's work on these rays."""
    nbytes = n * 44 + pk.occ.numel() * 4 + pk.words.numel() * 4
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


def phase_kernel_renderer():
    """[kernel renderer] The 512-crate profiling scene baked into one 256^3
    grid; render_lambert_fast then render_flat_fast at WxH with the launch
    counts at 0 just before; B5 against its plain version on the frame's
    own primary and shadow ray lists."""
    from voxel_tracer_tpu_torch.ops.cuda import coherent, integrate, renderer_fast
    from voxel_tracer_tpu_torch.utils import profiling
    t0 = time.perf_counter()
    vol = profiling.profiling_scene_merged()
    scene = renderer_fast.FastScene.build([vol], device="cuda")
    cam = profiling.profiling_camera(W / H)
    pk = scene.volumes[0].packed
    torch.cuda.synchronize()
    log(f"[kernel renderer] 512 crates baked into a {vol.grid.shape[::-1]} grid, "
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

    lists = frame_rays(scene, cam, lit)
    # the frame's lists barely walk (primary rays stop at the cube's face,
    # shadow rays leave it): random rays in and around the crate field walk
    # the hollow crates
    rng = np.random.RandomState(1)
    o = rng.uniform(-1.0, 13.8, (N_RAYS, 3)).astype(np.float32)   # grid: [0, 12.8]^3
    d = rng.randn(N_RAYS, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    lists["random"] = (torch.from_numpy(o).cuda(), torch.from_numpy(d).cuda())
    out = dict(launches=launches, err=0.0, scene=scene, cam=cam, lists=lists, stats={})
    unresolved = 0
    for name, (o, d) in lists.items():
        k = coherent.trace_coherent(pk.occ, pk.words, o, d, pk.bsize, pk.vpu)
        stats = {}
        p = coherent.trace_coherent_plain(pk.occ, pk.words, o, d, pk.bsize, pk.vpu,
                                          stats=stats)
        torch.cuda.synchronize()
        unresolved += int((~k["resolved"]).sum())
        out["err"] = max(out["err"], compare_traces(f"kernel renderer {name}", k, p))
        log(f"[kernel renderer {name}] work {stats}")
        out["stats"][name] = stats
    log(f"[kernel renderer] unresolved rays: {unresolved}")
    require(unresolved == 0, f"{unresolved} unresolved rays")
    return out


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
    return dict(launches=launches, err_cam=err, err_rays=ray_err, cam_p=cam_p,
                occb=occb, cam_stats=cam_stats, ray_stats=ray_stats)


def phase_new_timing(kr, ind, mv, o_t, d_t):
    """[timing] B5 on the kernel renderer's ray lists, B3 on the bench frame,
    B4 on the random rays; the lit frame of the kernel renderer end to end
    (wall and device-busy time)."""
    from voxel_tracer_tpu_torch.ops.cuda import coherent, indep, renderer_fast
    pk = kr["scene"].volumes[0].packed
    out = {}
    for name, (o, d) in kr["lists"].items():
        def fn(o=o, d=d):
            return coherent.trace_coherent(pk.occ, pk.words, o, d, pk.bsize, pk.vpu)

        def plain(o=o, d=d):
            return coherent.trace_coherent_plain(pk.occ, pk.words, o, d, pk.bsize,
                                                 pk.vpu)
        n = o.shape[0]
        out[f"coherent {name}"] = time_kernel(
            f"coherent {name} rays", fn, plain, (10, 40), "coherent_kernel", n,
            coherent_bound(n, pk, kr["stats"][name]))
    tb = mv.tables
    n_px = W * H
    out["indep_camera"] = time_kernel(
        "indep camera frame",
        lambda: indep.render_indep_tiles(ind["cam_p"], ind["occb"], tb, width=W, height=H),
        lambda: indep.render_indep_tiles_plain(ind["cam_p"], ind["occb"], tb, width=W,
                                               height=H),
        (16, 64), "indep_camera_kernel", n_px,
        indep_bound(n_px, 12, tb, ind["cam_stats"], True))
    out["indep_rays"] = time_kernel(
        "indep rays",
        lambda: indep.trace_rays_indep(o_t, d_t, ind["occb"], tb),
        lambda: indep.trace_rays_indep_plain(o_t, d_t, ind["occb"], tb),
        (10, 40), "indep_rays_kernel", N_RAYS,
        indep_bound(N_RAYS, 32, tb, ind["ray_stats"], False))

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
    rays = phase_trace_rays(mv, o_rand, d_rand)
    err_cam = max(err_cam, phase_flat("flat frame", mv, bench_camera(0.0, W / H)))
    err_cam = max(err_cam, phase_lit(mv))
    t0 = time.perf_counter()
    big = VoxelVolume.noise_filled((256, 256, 256), pos=(0, 0, 0), vpu=80.0)
    mv_big = mega.MegaVolume(big, device="cuda")
    log(f"[large grid] 256^3 noise volume built and packed in "
        f"{time.perf_counter() - t0:.1f} s")
    err_cam = max(err_cam, phase_flat("large grid", mv_big, bench_camera(0.0, W / H)))
    del mv_big
    times = phase_timing(mv)
    tb = mv.tables
    cam_bytes = (W * H * 12 + 29 * 4 + tb.bocc.numel() * 4 + tb.occw.numel() * 4
                 + tb.matb.numel() + tb.pal.numel() * 4)
    cam_bound = bound(cam_bytes, W * H * MEGA_OPS_PER_RAY + frame_steps * MEGA_OPS_PER_STEP)
    log(f"[timing] camera kernel bound {cam_bound[0]:.4f} ms ({cam_bound[1]}): "
        f"{cam_bytes} bytes, {frame_steps} DDA steps")

    scene = diff_scene()
    diffint_res = phase_diffint(scene)
    phase_finite_difference(scene)
    phase_slabs(scene)
    del scene
    train = phase_train()

    kr = phase_kernel_renderer()
    phase_two_volumes()
    ind = phase_indep(mv, o_rand, d_rand)
    new_times = phase_new_timing(kr, ind, mv, o_rand, d_rand)

    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    log(smi)
    src = "voxel_tracer_tpu_torch/csrc/mega.cu"
    isrc = "voxel_tracer_tpu_torch/csrc/diffint.cu"
    kernels = [
        dict(name="mega_camera", route="cuda", source=src,
             replaces="voxel_tracer_tpu/ops/pallas/mega.py:2536",
             launches=launches["mega_camera"], max_abs_err=err_cam,
             ms=times["flat kernel"], device_ms=times["flat kernel device"],
             plain_ms=times["flat plain"],
             bound_ms=cam_bound[0], bound_by=cam_bound[1], library_ms=None),
        dict(name="mega_rays", route="cuda", source=src,
             replaces="voxel_tracer_tpu/ops/pallas/mega.py:2810",
             launches=launches["mega_rays"], max_abs_err=rays["err"],
             ms=rays["ms"], device_ms=rays["dev_ms"], plain_ms=rays["plain_ms"],
             bound_ms=rays["bound"][0], bound_by=rays["bound"][1], library_ms=None)]
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
    for name, src_name, line, launches_n, err, t in (
            ("coherent", "coherent", "coherent.py:444", kr["launches"], kr["err"],
             new_times["coherent primary"]),
            ("indep_camera", "indep", "indep.py:468", ind["launches"]["indep_camera"],
             ind["err_cam"], new_times["indep_camera"]),
            ("indep_rays", "indep", "indep.py:523", ind["launches"]["indep_rays"],
             ind["err_rays"], new_times["indep_rays"])):
        kernels.append(dict(
            name=name, route="cuda", source=f"voxel_tracer_tpu_torch/csrc/{src_name}.cu",
            replaces=f"voxel_tracer_tpu/ops/pallas/{line}", launches=launches_n,
            max_abs_err=err, ms=t["ms"], device_ms=t["dev_ms"], plain_ms=t["plain_ms"],
            bound_ms=t["bound"][0], bound_by=t["bound"][1], library_ms=None))
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
