#!/usr/bin/env python3
"""Design trials of the port's mega kernels B1 / B2
(`voxel_tracer_tpu_torch/csrc/mega.cu`) on one NVIDIA GPU: the brick
bitmap staged in each block's shared memory in place of the read-only
path, the fine walk without its request of the next cell's occupancy word
ahead of the current cell's test, launch bounds, and the camera kernel's
block shape; optionally against an earlier `mega.cu` (``--baseline FILE``,
the launcher interface that read int32 brick flags in place of the
bitmap).

Each variant is the committed source with textual changes, compiled with
the port's nvcc flags into `build/voxel_tracer_tpu_torch/trials/` and
called through the port's launchers (`render_mega_tiles`, `trace_rays`)
with its library in place of the port's.  The inputs are `chip_smoke.py`'s:
the bench frame (1920x1088), its 1 M random rays, the lit frame's shadow-ray
list, the long sparse volume's rays (`profiling.budget_scene`) and the
256^3 noise grid's frame, whose bitmaps hold 16, 64 and 1024 words.

Every variant is held against the plain version (bench frame, random
rays, the budget volume: aux and t equal) before it is timed.  Variants
are timed in turns (A B C ... C B A), each turn with CUDA events over
serialized calls and profiler device time per launch.  Prints the ptxas
lines of each variant, one line per turn, and a JSON summary as the last
line (also written to `build/voxel_tracer_tpu_torch/trials/mega_trials.json`).

Run from the repository root on a machine with a card:
    python3 tools/torch_mega_trials.py [--baseline path/to/old/mega.cu]
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from voxel_tracer_tpu_torch.ops import dda  # noqa: E402
from voxel_tracer_tpu_torch.ops.cuda import _build, mega  # noqa: E402

OUT_DIR = _build.BUILD_DIR / "trials"
FINE_START = "      float ft = 0.0f;\n"
FINE_END = "    // one brick step"
# the fine walk that loads each cell's occupancy word only when it tests
# that cell (no request ahead); the same float operations in the same
# order
SIMPLE_FINE = """      float ft = 0.0f;
      for (;;) {
        const int bit = (fz * BRICK + fy) * BRICK + fx;
        if ((__ldg(&w[bit >> 5]) >> (bit & 31)) & 1u) {
          // entry-voxel hits keep the slab entry axis (vv.cpp:159)
          const int ha = steps == 0 ? entry_axis : axis;
          const bool hpos = ha == 0 ? px : (ha == 1 ? py : pz);
          h.t = bet + ft / v.vpu;
          h.mat = fetch_mat ? (int)__ldg(&v.matb[(size_t)b * 512 + bit]) : 0;
          h.ax = ha * 2 + (hpos ? 1 : 0);
          h.steps = steps;
          return h;
        }
        // one fine step (vv.cpp:176-202 comparison order); leaving the
        // brick discards it and takes the brick step below instead
        if ((fmx < fmy) && (fmx < fmz)) {
          if ((unsigned)(fx + sx) >= (unsigned)BRICK) break;
          fx += sx; ft = fmx; fmx = fmx + dlx; axis = 0;
        } else if (!(fmx < fmy) && (fmy < fmz)) {
          if ((unsigned)(fy + sy) >= (unsigned)BRICK) break;
          fy += sy; ft = fmy; fmy = fmy + dly; axis = 1;
        } else {
          if ((unsigned)(fz + sz) >= (unsigned)BRICK) break;
          fz += sz; ft = fmz; fmz = fmz + dlz; axis = 2;
        }
        if (++steps >= max_steps) {      // budget exhausted: a miss
          h.steps = steps;
          h.resolved = 0;
          return h;
        }
      }
    }
"""
# the bitmap staged in shared memory (at most 1024 words: the trials'
# volumes) and read from there
TRACE_SIG = "const Volume& v, bool fetch_mat) {"
BRICK_TEST = "if ((__ldg(&v.bits[b >> 5]) >> (b & 31)) & 1u) {"
PAL_STAGE = ("  for (int i = tid; i < 256 * 3; i += blockDim.x * blockDim.y) "
             "spal[i] = __ldg(&pal[i]);\n")
NWORDS = "(v.bx * v.by * v.bz + 31) / 32"
RAY_HEAD = "int32_t* __restrict__ aux_out) {\n  const size_t i"
SHARED_BITMAP = [
    (TRACE_SIG, "const Volume& v, bool fetch_mat, const uint32_t* sbits) {"),
    (BRICK_TEST, "if ((sbits[b >> 5] >> (b & 31)) & 1u) {"),
    (PAL_STAGE, PAL_STAGE + "  __shared__ uint32_t sbits[1024];\n"
     f"  for (int k = tid; k < {NWORDS}; k += blockDim.x * blockDim.y) "
     "sbits[k] = __ldg(&v.bits[k]);\n"),
    ("trace_ray(o, d, v, shading != frame::SHADE_TRACE)",
     "trace_ray(o, d, v, shading != frame::SHADE_TRACE, sbits)"),
    (RAY_HEAD, "int32_t* __restrict__ aux_out) {\n  __shared__ uint32_t sbits[1024];\n"
     f"  for (int k = threadIdx.x; k < {NWORDS}; k += blockDim.x) "
     "sbits[k] = __ldg(&v.bits[k]);\n  __syncthreads();\n  const size_t i"),
    ("trace_ray(o, d, v, fetch_mat != 0)", "trace_ray(o, d, v, fetch_mat != 0, sbits)")]
CAM_BOUNDS = "__launch_bounds__(256, 1)\nmega_camera_kernel"
RAY_BOUNDS = "__launch_bounds__(RAY_THREADS, 1)\nmega_rays_kernel"
BLOCK = "const dim3 block(8, 32);"
VARIANTS = {
    "committed": [],
    "shared_bitmap": SHARED_BITMAP,
    "no_prefetch": ["simple_fine"],
    "bounds_threads_only": [(CAM_BOUNDS, "__launch_bounds__(256)\nmega_camera_kernel"),
                            (RAY_BOUNDS, "__launch_bounds__(RAY_THREADS)\nmega_rays_kernel")],
    "block_16x16": [(BLOCK, "const dim3 block(16, 16);")],
}


def _sub(src, old, new):
    if old not in src:
        raise RuntimeError(f"mega.cu does not hold {old!r}")
    return src.replace(old, new)


def variant_source(name):
    src = (_build.CSRC / "mega.cu").read_text()
    for patch in VARIANTS[name]:
        if patch == "simple_fine":
            i = src.index(FINE_START)
            j = src.index(FINE_END, i)
            src = src[:i] + SIMPLE_FINE + src[j:]
        else:
            src = _sub(src, *patch)
    return src


def build_variants(baseline):
    """Compile every variant, one nvcc process each, all started together;
    returns {name: (CDLL, ptxas lines)}."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    sources = {name: variant_source(name) for name in VARIANTS}
    if baseline:
        with open(baseline) as f:
            sources["baseline"] = f.read()
    procs = {}
    for name, src in sources.items():
        cu = OUT_DIR / f"mega_{name}.cu"
        cu.write_text(src)
        so = OUT_DIR / f"libmega_{name}.so"
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    out = {}
    for name, (proc, so) in procs.items():
        text = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{text}")
        ptxas = [ln.strip() for ln in text.splitlines()
                 if "entry function" in ln or "registers" in ln or "spill" in ln]
        out[name] = (ctypes.CDLL(str(so)), ptxas)
    return out


def _baseline_typed(lib):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    vol = [p, p, p, i, i, i, i, i, i, f, i]
    lib.vt_mega_camera.argtypes = [p, p, *vol, i, i, i, i, f, p, p, p, p]
    lib.vt_mega_rays.argtypes = [p, p, i, *vol, i, p, p, p]
    return lib


def _baseline_vol(tb):
    return [tb.bocc.data_ptr(), tb.occw.data_ptr(), tb.matb.data_ptr(), *tb.bsize,
            *tb.gsize, tb.vpu, dda.MAX_STEPS]


def camera_call(name, lib, cam_p, tb):
    """fn() rendering the flat frame with one variant's library."""
    if name == "baseline":
        def fn():
            out = [torch.empty((cs.H, cs.W), dtype=dt, device="cuda")
                   for dt in (torch.int32, torch.float32, torch.int32)]
            err = lib.vt_mega_camera(cam_p.data_ptr(), tb.pal.data_ptr(), *_baseline_vol(tb),
                                     cs.W, cs.H, 0, 0, 0.2, *(x.data_ptr() for x in out),
                                     torch.cuda.current_stream().cuda_stream)
            _build.raise_on(lib, err, "baseline mega_camera")
            return tuple(out)
        return fn

    def fn():
        _build._LIBS["mega"] = lib
        return mega.render_mega_tiles(cam_p, tb, width=cs.W, height=cs.H)
    return fn


def rays_call(name, lib, o, d, tb, fetch_mat):
    """fn() tracing a ray list with one variant's library: (t, aux)."""
    if name == "baseline":
        def fn():
            n = o.shape[0]
            t = torch.empty((n,), dtype=torch.float32, device="cuda")
            aux = torch.empty((n,), dtype=torch.int32, device="cuda")
            err = lib.vt_mega_rays(o.data_ptr(), d.data_ptr(), n, *_baseline_vol(tb),
                                   int(fetch_mat), t.data_ptr(), aux.data_ptr(),
                                   torch.cuda.current_stream().cuda_stream)
            _build.raise_on(lib, err, "baseline mega_rays")
            return t, aux
        return fn

    def fn():
        _build._LIBS["mega"] = lib
        r = mega.trace_rays(o, d, tb, fetch_mat=fetch_mat)
        return r["t"], (r["mat"] | (r["ax"] << mega.AUX_AX_SHIFT)
                        | (r["resolved"].int() << mega.AUX_RESOLVED_SHIFT)
                        | (r["steps"] << mega.AUX_STEPS_SHIFT))
    return fn


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", help="an earlier mega.cu to time beside the variants")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_mega_trials: no CUDA device available", file=sys.stderr)
        return 2
    from voxel_tracer_tpu_torch.models.volume import VoxelVolume
    from voxel_tracer_tpu_torch.utils import profiling
    smi = cs.nvidia_smi()
    cs.log(f"[device] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    libs = build_variants(args.baseline)
    for name, (_, ptxas) in libs.items():
        for ln in ptxas:
            cs.log(f"[build] {name}: {ln}")
    if "baseline" in libs:
        _baseline_typed(libs["baseline"][0])
    for name in VARIANTS:
        _build._LIBS["mega"] = libs[name][0]
        mega._lib()                              # argtypes of the port's launchers

    cam = cs.bench_camera(0.0, cs.W / cs.H)
    mv = mega.MegaVolume(VoxelVolume.noise_filled((64, 64, 64), pos=(0, 0, 0), vpu=20.0))
    big = mega.MegaVolume(VoxelVolume.noise_filled((256, 256, 256), pos=(0, 0, 0), vpu=80.0))
    cam_p, big_p = (mega.mega_camera(v, cam, cs.SUN, cs.W, cs.H) for v in (mv, big))
    o_r, d_r = cs.random_rays()
    _build._LIBS["mega"] = libs["committed"][0]
    o_s, d_s = cs.lit_shadow_rays(mv, cam)
    g, o_b, d_b, vpu = profiling.budget_scene()
    budget = mega.pack_tables(g, np.ones((256, 3), np.float32), vpu, "cuda")
    o_b, d_b = torch.from_numpy(o_b).cuda(), torch.from_numpy(d_b).cuda()

    plain = {
        "flat": mega.render_mega_tiles_plain(cam_p, mv.tables, width=cs.W, height=cs.H),
        "random": mega._trace_aux(mv.tables, o_r, d_r, True),
        "budget": mega._trace_aux(budget, o_b, d_b, True)}
    for name, (lib, _) in libs.items():
        got = {"flat": camera_call(name, lib, cam_p, mv.tables)(),
               "random": rays_call(name, lib, o_r, d_r, mv.tables, True)(),
               "budget": rays_call(name, lib, o_b, d_b, budget, True)()}
        torch.cuda.synchronize()
        for key, k in got.items():
            p = plain[key]
            t_k, aux_k = (k[1], k[2]) if key == "flat" else k
            t_p, aux_p = (p[1], p[2]) if key == "flat" else p
            cs.require(torch.equal(aux_k, aux_p) and torch.equal(t_k, t_p),
                       f"variant {name} differs from the plain version on {key}")
        cs.log(f"[trials] {name}: flat frame, random rays, budget rays equal the plain version")

    work = {
        "flat frame": (lambda n, lib: camera_call(n, lib, cam_p, mv.tables), 64,
                       "mega_camera_kernel"),
        "random rays": (lambda n, lib: rays_call(n, lib, o_r, d_r, mv.tables, True), 40,
                        "mega_rays_kernel"),
        "shadow rays": (lambda n, lib: rays_call(n, lib, o_s, d_s, mv.tables, False), 40,
                        "mega_rays_kernel"),
        "budget rays": (lambda n, lib: rays_call(n, lib, o_b, d_b, budget, True), 40,
                        "mega_rays_kernel"),
        "large grid": (lambda n, lib: camera_call(n, lib, big_p, big.tables), 16,
                       "mega_camera_kernel")}
    order = list(libs)
    readings = {w: {v: [] for v in order} for w in work}
    for turn, name in enumerate(order + order[::-1]):
        lib = libs[name][0]
        parts = []
        for wname, (make, reps, span) in work.items():
            fn = make(name, lib)
            fn()
            ms = cs.cuda_ms(lambda i: fn(), reps)
            dev = cs.kernel_device_ms(fn, reps, span)
            readings[wname][name].append((ms, dev))
            parts.append(f"{wname} {ms:.4f} ms (device "
                         f"{'n/a' if dev is None else f'{dev:.4f}'})")
        cs.log(f"[trials] turn {turn} {name}: " + ", ".join(parts))
    for wname, per in readings.items():
        for name, r in per.items():
            devs = [x[1] for x in r]
            cs.log(f"[trials] {wname} {name}: mean {sum(x[0] for x in r) / len(r):.4f} ms, "
                   "device mean " + (f"{sum(devs) / len(devs):.4f} ms"
                                     if all(x is not None for x in devs)
                                     else "not measured"))
    summary = {"device": smi, "ptxas": {n: v[1] for n, v in libs.items()},
               "readings": readings}
    with open(OUT_DIR / "mega_trials.json", "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
