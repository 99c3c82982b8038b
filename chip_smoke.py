#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

Builds the port's CUDA kernels from the sources in this checkout, drives
the port's main path -- the bench.py frame: dense 64^3 noise volume,
orbit camera, 1920x1088, flat (`render_mega`) and lit
(`render_lambert_mega`) -- through its public entry points, holds every
kernel against its plain PyTorch version on the same inputs, and times
both.  It prints one line per phase, then the card's name and power limit
as nvidia-smi reports them, then

    {"kernels": [{"name", "route", "source", "replaces", "launches",
                  "max_abs_err", "ms", "plain_ms"}, ...]}

and, as the last line, {"ok": true, "device": {...}}.  Any failed check
raises, and the script exits non-zero without printing a result; so does
a machine without a CUDA device, or a directory without the repository.

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
    return launches


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
    return dt, ms, plain_ms


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
    launches = phase_main_path(mv)
    err_cam = phase_small_reference()
    err_rays, rays_ms, rays_plain_ms = phase_trace_rays(mv)
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

    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    log(smi)
    src = "voxel_tracer_tpu_torch/csrc/mega.cu"
    log(json.dumps({"kernels": [
        {"name": "mega_camera", "route": "cuda", "source": src,
         "replaces": "voxel_tracer_tpu/ops/pallas/mega.py:2536",
         "launches": launches["mega_camera"], "max_abs_err": err_cam,
         "ms": times["flat kernel"], "plain_ms": times["flat plain"]},
        {"name": "mega_rays", "route": "cuda", "source": src,
         "replaces": "voxel_tracer_tpu/ops/pallas/mega.py:2810",
         "launches": launches["mega_rays"], "max_abs_err": err_rays,
         "ms": rays_ms, "plain_ms": rays_plain_ms},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
