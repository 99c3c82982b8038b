#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

Builds the port's CUDA kernels from the sources in this checkout, drives
the port's two main paths through their public entry points, holds every
kernel against its plain PyTorch version on the same inputs, and times
both:

- serving: the bench.py frame -- dense 64^3 noise volume, orbit camera,
  1920x1088, flat (`render_mega`) and lit (`render_lambert_mega`);
- training: `Trainer.fit` with the kernel backend at the width of
  bench_suite.py's inverse_128_32views -- a 128^3 sigma + albedo grid, 32
  ring views of 64x64 (131,072 rays a step), Adam lr 1e-2 -- after the
  integrate kernels are checked on bench_suite.py's diff_lambert_512 scene
  (sparse 64^3 blob, 512x512 camera rays) and the z-slab sequencer.

Each main path runs with the launch counts set to 0 just before it and
read just after.  It prints one line per phase, then the card's name and
power limit as nvidia-smi reports them, then

    {"kernels": [{"name", "route", "source", "replaces", "launches",
                  "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                  "library_ms"}, ...]}

and, as the last line, {"ok": true, "device": {...}}.  `bound_ms` is the
larger of the bytes the call must move over 3.35 TB/s and its FP32
operations (counted from this run's data, per-unit counts read off the
kernel sources) over 67 TFLOP/s, the H100 SXM's published peaks.
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
            if "registers" in line or "spill" in line:
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


def phase_trace_rays(mv):
    from voxel_tracer_tpu_torch.ops.cuda import mega
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
    o_t = torch.from_numpy(o).cuda()
    d_t = torch.from_numpy(d).cuda()
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
    plain_ms = cuda_ms(lambda i: mega.trace_rays_plain(o_t, d_t, mv.tables,
                                                       fetch_mat=True), 2)
    log(f"[trace_rays] kernel {ms:.4f} ms, plain {plain_ms:.2f} ms per "
        f"{N_RAYS} rays ({N_RAYS / ms * 1e3:.4g} vs {N_RAYS / plain_ms * 1e3:.4g} rays/s)")
    tb = mv.tables
    nbytes = N_RAYS * (24 + 8) + tb.bocc.numel() * 4 + tb.occw.numel() * 4 + tb.matb.numel()
    b = bound(nbytes, N_RAYS * MEGA_OPS_PER_RAY
              + int(kr["steps"].sum()) * MEGA_OPS_PER_STEP)
    log(f"[trace_rays] bound {b[0]:.4f} ms ({b[1]}): {nbytes} bytes, "
        f"{int(kr['steps'].sum())} DDA steps")
    return dict(err=dt, ms=ms, plain_ms=plain_ms, bound=b)


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
    tables = diffint._pack_tables(sigma.detach(), albedo.detach())
    return tables, diffint.occ_words(tables[0]), diffint.brick_dims(sigma.shape)


def _maxabs(t):
    return float(t.abs().max()) if t.numel() else 0.0


def _int_bytes(n, tables, mode):
    """Bytes each integrate call must move: rays, carry (and cotangents and
    totals) read once, the four tables read once, the outputs written once."""
    per_ray = 24 + 20 + (24 if mode == "fwd" else 40)
    table_bytes = sum(t.numel() for t in tables) * 4
    return n * per_ray + table_bytes * (1 if mode == "fwd" else 2)


def _int_ops(n, stats, mode):
    return (n * INT_OPS_PER_RAY + stats["brick_steps"] * INT_OPS_PER_BRICK_STEP
            + stats["brick_visits"] * INT_OPS_PER_VISIT
            + stats["fine_steps"] * INT_OPS_PER_FINE_STEP[mode])


def integrate_pair(tag, sigma, albedo, o, d, vpu, target, reps):
    """B6 and B7 against their plain versions on the same inputs (the
    cotangents of mean((color - target)^2)), timed both; returns errors,
    times, bounds and the march's work."""
    from voxel_tracer_tpu_torch.ops.cuda import diffint
    tables, occ, bsize = _packed(sigma, albedo)
    n = o.shape[0]
    carry = diffint._init_carry(n, o.device)
    kw = dict(bsize=bsize, vpu=vpu, t_eps=T_EPS)
    k = diffint.integrate_fwd_tiles(0, occ, o, d, carry, *tables, **kw)
    stats = {}
    p = diffint.integrate_fwd_plain(0, occ, o, d, carry, *tables, stats=stats, **kw)
    torch.cuda.synchronize()
    require(bool(torch.equal(k[5], p[5])), f"{tag}: flags differ")
    err_f = max(float((a - b).abs().max()) for a, b in zip(k[:5], p[:5]))
    marched = float((k[5] == 2).float().mean())
    log(f"[{tag} fwd] {n} rays, {bsize} bricks: kernel vs plain max |d| "
        f"{err_f:.3g} (limit {INT_ATOL}), flags equal, marched {marched:.4f}; "
        f"work {stats}")
    require(err_f <= INT_ATOL, f"{tag}: forward differs by {err_f}")
    require(bool(torch.isfinite(k[0]).all() and torch.isfinite(k[4]).all()),
            f"{tag}: non-finite forward")

    color = torch.stack(k[:3], dim=-1)
    g_color = 2.0 * (color - target) / color.numel()
    zero = torch.zeros(n, device=o.device)
    cts = tuple(g_color[:, i].contiguous() for i in range(3)) + (zero, zero)
    kb = diffint.integrate_bwd_tiles(0, occ, o, d, carry, *tables, cts, k[:5], **kw)
    pb = diffint.integrate_bwd_plain(0, occ, o, d, carry, *tables, cts, k[:5], **kw)
    torch.cuda.synchronize()
    empty_brick = torch.repeat_interleave(
        ((occ[:, None] >> torch.arange(32, device=occ.device)) & 1).reshape(-1)
        [:tables[0].shape[0] // 4] == 0, 4)
    err_b, rel_b = 0.0, 0.0
    for name, a, b in zip(("d_sigma", "d_albedo_r", "d_albedo_g", "d_albedo_b"), kb, pb):
        scale = float(b.abs().max())
        e = float((a - b).abs().max())
        err_b, rel_b = max(err_b, e), max(rel_b, e / max(scale, 1e-30))
        require(scale > 0.0, f"{tag}: {name} is all zero")
        require(e <= GRAD_RTOL * scale, f"{tag}: {name} differs by {e} (max|g| {scale})")
        require(_maxabs(a[empty_brick]) == 0.0,
                f"{tag}: kernel {name} nonzero in an empty brick")
        require(_maxabs(b[empty_brick]) == 0.0,
                f"{tag}: plain {name} nonzero in an empty brick")
    require(_maxabs(kb[0][tables[0] == 0.0]) == 0.0,
            f"{tag}: d_sigma nonzero where sigma is 0")
    log(f"[{tag} bwd] kernel vs plain max |d| {err_b:.3g}, {rel_b:.3g} x max|g| "
        f"(limit {GRAD_RTOL}); {int(empty_brick.sum()) // 4} empty bricks exactly 0")

    out = dict(err_fwd=err_f, err_bwd=err_b, stats=stats, n=n)
    for mode, fn_k, fn_p, args in (
            ("fwd", diffint.integrate_fwd_tiles, diffint.integrate_fwd_plain,
             (0, occ, o, d, carry, *tables)),
            ("bwd", diffint.integrate_bwd_tiles, diffint.integrate_bwd_plain,
             (0, occ, o, d, carry, *tables, cts, k[:5]))):
        ms = cuda_ms(lambda i: fn_k(*args, **kw), reps)
        dev_ms = kernel_device_ms(lambda: fn_k(*args, **kw), reps,
                                  "integrate_kernel")
        plain_ms = cuda_ms(lambda i: fn_p(*args, **kw), 1)
        b = bound(_int_bytes(n, tables, mode), _int_ops(n, stats, mode))
        dev = "not measured" if dev_ms is None else f"{dev_ms:.4f} ms"
        log(f"[{tag} {mode}] kernel {ms:.4f} ms per call (CUDA events over {reps} "
            f"calls; device time per launch {dev}), plain {plain_ms:.2f} ms; "
            f"bound {b[0]:.4f} ms ({b[1]}); {n / ms * 1e3:.4g} rays/s")
        out[mode] = dict(ms=ms, plain_ms=plain_ms, bound=b)
    return out


def phase_diffint(scene):
    """[diffint fwd] + [diffint bwd]: the diff_lambert_512 scene."""
    return integrate_pair("diffint", scene["sigma"], scene["albedo"], scene["o"],
                          scene["d"], scene["vpu"], scene["target"], 20)


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
                         torch.from_numpy(c).cuda(), 10)
    res["launches"] = launches
    return res


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
    rays = phase_trace_rays(mv)
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

    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    log(smi)
    src = "voxel_tracer_tpu_torch/csrc/mega.cu"
    isrc = "voxel_tracer_tpu_torch/csrc/diffint.cu"
    kernels = [
        dict(name="mega_camera", route="cuda", source=src,
             replaces="voxel_tracer_tpu/ops/pallas/mega.py:2536",
             launches=launches["mega_camera"], max_abs_err=err_cam,
             ms=times["flat kernel"], plain_ms=times["flat plain"],
             bound_ms=cam_bound[0], bound_by=cam_bound[1], library_ms=None),
        dict(name="mega_rays", route="cuda", source=src,
             replaces="voxel_tracer_tpu/ops/pallas/mega.py:2810",
             launches=launches["mega_rays"], max_abs_err=rays["err"],
             ms=rays["ms"], plain_ms=rays["plain_ms"], bound_ms=rays["bound"][0],
             bound_by=rays["bound"][1], library_ms=None)]
    for name, mode, line, err in (
            ("integrate_fwd", "fwd", 511, max(train["err_fwd"], diffint_res["err_fwd"])),
            ("integrate_bwd", "bwd", 544, max(train["err_bwd"], diffint_res["err_bwd"]))):
        kernels.append(dict(
            name=name, route="cuda", source=isrc,
            replaces=f"voxel_tracer_tpu/ops/pallas/diffint.py:{line}",
            launches=train["launches"][name], max_abs_err=err,
            ms=train[mode]["ms"], plain_ms=train[mode]["plain_ms"],
            bound_ms=train[mode]["bound"][0], bound_by=train[mode]["bound"][1],
            library_ms=None))
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
