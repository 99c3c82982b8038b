#!/usr/bin/env python3
"""Design trials of the port's replay-backward kernel D3
(`voxel_tracer_tpu_torch/csrc/diff.cu`, `diff_bwd_kernel`) on one NVIDIA
GPU: the parent design (the first D3: a scalar sigma load and three
strided albedo loads a segment, up to four scalar atomic adds into the
(Z, Y, X) and (Z, Y, X, 3) gradient grids, 128-thread blocks) beside the
committed one (one float4 (sigma, r, g, b) record a voxel, the next
voxel's record requested ahead, one float4 atomicAdd a segment into a
gradient record), and the committed one with one lever moved: no record
requested ahead, sigma and albedo read from the plain grids, four scalar
atomics into the gradient record, other block shapes, launch bounds that
cap the registers.

Each variant is the committed source with textual changes, compiled with
the port's nvcc flags into `build/voxel_tracer_tpu_torch/trials/` and
called through the port's launcher (`ops/cuda/diff.march_bwd`: the record
packed, the gradient record zeroed, D3, the gradients unpacked) with its
library in place of the port's; the parent variant adds the parent's
kernel and launcher (`vt_diff_bwd_parent`, its own argument struct)
beside the committed ones and is called the way the parent's wrapper
called it (two zeroed gradient grids, D3).  The inputs are
`chip_smoke.py` [march]'s: workload 4's (262,144 plane rays, 64^3 blob,
128 steps), inverse_128's step (131,072 ring rays, 128^3, 192 steps), the
edge rays, the z-slab and sigma zeros with albedo negatives; the
cotangents are those of [march]'s loss on D2's outputs.

Every variant is held against the plain backward (`ops/diff._render_bwd`)
on every input before it is timed: within GRAD_RTOL x max|g| (atomics
sum in run-dependent order) and d sigma 0 where sigma <= 0.  Variants are
timed in turns (A B C ... C B A), each turn with CUDA events (10 calls)
and profiler device time: D3's own span and the whole backward's (D3
and its glue: pack, zeroing, unpack).  Prints the ptxas lines of each
variant, one line per turn, and a JSON summary as the last line (also
written to `build/voxel_tracer_tpu_torch/trials/diff_trials.json`).

Run from the repository root on a machine with a card:
    python3 tools/torch_diff_trials.py [--variants a,b,...]
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
from voxel_tracer_tpu_torch.ops import diff  # noqa: E402
from voxel_tracer_tpu_torch.ops.cuda import _build  # noqa: E402
from voxel_tracer_tpu_torch.ops.cuda import diff as diff_kernel  # noqa: E402

OUT_DIR = _build.BUILD_DIR / "trials"
LAUNCHER = 'extern "C" int vt_diff_fwd(const DiffArgs* args, cudaStream_t stream)'

# -- parent: the first D3 (PR 15), its own argument struct and launcher,
# beside the committed ones
PARENT_SOURCE = r"""
struct ParentDiffArgs {
  const float* sigma;         // (Z, Y, X) density
  const float* albedo;        // (Z, Y, X, 3)
  const float* orig;          // (N, 3) local origins
  const float* dirs;          // (N, 3) local directions
  float* color;               // (N, 3): D2 writes, D3 reads the saved totals
  float* trans;               // (N,)
  float* depth;               // (N,)
  const float* g_color;       // D3: cotangents (N, 3), (N,), (N,)
  const float* g_trans;
  const float* g_depth;
  float* d_sigma;             // D3: zeroed (Z, Y, X) and (Z, Y, X, 3)
  float* d_albedo;
  int n;
  int gx, gy, gz;
  int max_steps;
  float vpu;                  // float32 vpu and its float32 reciprocal
  float rvpu;
};

namespace parent {

constexpr float BIG_F32 = 1e30f;   // miss depth and clamp (math3d.py BIG_F32)
constexpr int THREADS = 128;

__device__ __forceinline__ bool neg_inf(float v) { return isinf(v) && v < 0.0f; }

// One axis of the slab test against [0, size] (dda.slab_test): the NaN
// guard maps 0 * inf on a slab plane to -BIG / +BIG; tmin starts at the
// clamp 0, tmax at the first axis's far t.
__device__ __forceinline__ void slab_axis(float o, float d, float size, int a,
                                          float& tmin, float& tmax) {
  const float rcp = 1.0f / d;
  const float t1 = (0.0f - o) * rcp;
  const float t2 = (size - o) * rcp;
  const bool nan = isnan(t1) || isnan(t2);
  const float tn = nan ? -BIG_F32 : fminf(t1, t2);
  const float tf = nan ? BIG_F32 : fmaxf(t1, t2);
  if (tn > tmin) tmin = tn;
  tmax = (a == 0) ? tf : fminf(tmax, tf);
}

// One axis of diff._march_setup for an entering ray: the clamped entry
// cell and the first crossing t.
__device__ __forceinline__ void axis_setup(float o, float d, float tmin, float vpu,
                                           float rvpu, int hi, bool pos, float rdir,
                                           int& cell, float& tm) {
  const float e = fmaf(d, tmin, o) * vpu;
  const float c = fminf(fmaxf(floorf(e), 0.0f), (float)hi);
  float v = fmaf((((c - e) + (pos ? 1.0f : 0.0f)) * rdir), rvpu, tmin);
  if (isnan(v)) v = BIG_F32;
  cell = (int)c;
  tm = fminf(v, BIG_F32);
}

// Marches ray i.  BWD = false: D2, writes (C, T, D).  BWD = true: D3,
// replays the march and adds the ray's gradients.
template <bool BWD>
__device__ __forceinline__ void march_ray(const ParentDiffArgs& a, int i) {
  const float ox = __ldg(&a.orig[3 * i]), oy = __ldg(&a.orig[3 * i + 1]),
              oz = __ldg(&a.orig[3 * i + 2]);
  const float dx = __ldg(&a.dirs[3 * i]), dy = __ldg(&a.dirs[3 * i + 1]),
              dz = __ldg(&a.dirs[3 * i + 2]);
  const float vpu = a.vpu, rvpu = a.rvpu;

  float tmin = 0.0f, tmax = 0.0f;
  slab_axis(ox, dx, (float)a.gx / vpu, 0, tmin, tmax);
  slab_axis(oy, dy, (float)a.gy / vpu, 1, tmin, tmax);
  slab_axis(oz, dz, (float)a.gz / vpu, 2, tmin, tmax);
  const bool ok = tmax - 1e-4f >= tmin;

  const bool px = !signbit(dx), py = !signbit(dy), pz = !signbit(dz);
  const int sx = px ? 1 : -1, sy = py ? 1 : -1, sz = pz ? 1 : -1;
  const float rx = 1.0f / dx, ry = 1.0f / dy, rz = 1.0f / dz;
  // clamp inf (axis-parallel rays) to BIG so 0 * delta stays 0, not NaN
  const float dlx = fminf(fabsf(rx), BIG_F32) * rvpu, dly = fminf(fabsf(ry), BIG_F32) * rvpu,
              dlz = fminf(fabsf(rz), BIG_F32) * rvpu;
  int cx, cy, cz;
  float tx, ty, tz;
  axis_setup(ox, dx, tmin, vpu, rvpu, a.gx - 1, px, rx, cx, tx);
  axis_setup(oy, dy, tmin, vpu, rvpu, a.gy - 1, py, ry, cy, ty);
  axis_setup(oz, dz, tmin, vpu, rvpu, a.gz - 1, pz, rz, cz, tz);
  // The scan steps a dead ray on.  Where the set-up leaves t_exit or a
  // first crossing at -inf, its first step ends at t = -inf, its next
  // step's segment depth t + dl / 2 is -inf or NaN, and w = 0 times it
  // leaves the depth NaN (JAX's scan and ops/diff.py alike; such a ray
  // has no valid segment).  That is the one output of a dead ray's steps
  // that is not "x + 0"; it is reproduced here.
  const bool nan_depth = a.max_steps >= 2 && (neg_inf(tmax) || neg_inf(tx) ||
                                              neg_inf(ty) || neg_inf(tz));
  if (!ok) {                  // a miss: T = 1, C = 0, D = 0; no gradient
    if (!BWD) {
      a.color[3 * i] = 0.0f;
      a.color[3 * i + 1] = 0.0f;
      a.color[3 * i + 2] = 0.0f;
      a.trans[i] = 1.0f;
      a.depth[i] = nan_depth ? NAN_F32 : 0.0f;
    }
    return;
  }

  float T = 1.0f, Cr = 0.0f, Cg = 0.0f, Cb = 0.0f, D = 0.0f;   // D3: prefix sums
  float Ctr = 0.0f, Ctg = 0.0f, Ctb = 0.0f, Dt = 0.0f, Tf = 0.0f;
  float gCr = 0.0f, gCg = 0.0f, gCb = 0.0f, gT = 0.0f, gD = 0.0f;
  if (BWD) {
    Ctr = a.color[3 * i];
    Ctg = a.color[3 * i + 1];
    Ctb = a.color[3 * i + 2];
    Tf = a.trans[i];
    Dt = a.depth[i];
    gCr = __ldg(&a.g_color[3 * i]);
    gCg = __ldg(&a.g_color[3 * i + 1]);
    gCb = __ldg(&a.g_color[3 * i + 2]);
    gT = __ldg(&a.g_trans[i]);
    gD = __ldg(&a.g_depth[i]);
  }
  float t = tmin;
  for (int s = 0; s < a.max_steps; ++s) {
    // diff._step: the first axis of least tmax3 (torch.argmin)
    int ax = 0;
    float m = tx;
    if (ty < m) { m = ty; ax = 1; }
    if (tz < m) { m = tz; ax = 2; }
    const float t_next = fminf(m, tmax);
    const float dl = fmaxf(t_next - t, 0.0f);
    if (dl > 0.0f) {          // a valid segment of the current cell
      const int64_t idx = ((int64_t)cz * a.gy + cy) * a.gx + cx;
      const float sg = __ldg(&a.sigma[idx]);
      const float ar = __ldg(&a.albedo[3 * idx]), ag = __ldg(&a.albedo[3 * idx + 1]),
                  ab = __ldg(&a.albedo[3 * idx + 2]);
      const float e = expf(-fmaxf(sg, 0.0f) * dl);
      const float alpha = 1.0f - e;
      const float w = T * alpha;
      const float seg_d = t + 0.5f * dl;
      Cr = Cr + w * ar;
      Cg = Cg + w * ag;
      Cb = Cb + w * ab;
      D = D + w * seg_d;
      if (BWD) {
        const float te = T * e;
        const float relu = sg > 0.0f ? 1.0f : 0.0f;   // sigma clamped at 0
        const float s0 = gCr * te * ar - gCr * (Ctr - Cr);
        const float s1 = gCg * te * ag - gCg * (Ctg - Cg);
        const float s2 = gCb * te * ab - gCb * (Ctb - Cb);
        const float gsig = ((((s0 + s1) + s2) + gD * (te * seg_d - (Dt - D))) - gT * Tf) *
                           dl * relu;
        if (gsig != 0.0f) atomicAdd(&a.d_sigma[idx], gsig);
        const float g0 = gCr * w, g1 = gCg * w, g2 = gCb * w;
        if (g0 != 0.0f) atomicAdd(&a.d_albedo[3 * idx], g0);
        if (g1 != 0.0f) atomicAdd(&a.d_albedo[3 * idx + 1], g1);
        if (g2 != 0.0f) atomicAdd(&a.d_albedo[3 * idx + 2], g2);
      }
      T = T * (1.0f - alpha);
    }
    // the step; only the stepped axis can leave the grid
    bool oob;
    if (ax == 0) {
      cx += sx; tx = tx + dlx;
      oob = (unsigned)cx >= (unsigned)a.gx;
    } else if (ax == 1) {
      cy += sy; ty = ty + dly;
      oob = (unsigned)cy >= (unsigned)a.gy;
    } else {
      cz += sz; tz = tz + dlz;
      oob = (unsigned)cz >= (unsigned)a.gz;
    }
    t = t_next;
    if (oob || !(t_next < tmax)) break;
  }
  if (!BWD) {
    a.color[3 * i] = Cr;
    a.color[3 * i + 1] = Cg;
    a.color[3 * i + 2] = Cb;
    a.trans[i] = T;
    a.depth[i] = nan_depth ? NAN_F32 : D;
  }
}

__global__ void __launch_bounds__(THREADS) diff_bwd_kernel(const ParentDiffArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < a.n) march_ray<true>(a, i);
}

}  // namespace parent

extern "C" int vt_diff_bwd_parent(const ParentDiffArgs* args, cudaStream_t stream) {
  const ParentDiffArgs a = *args;
  parent::diff_bwd_kernel<<<(a.n + parent::THREADS - 1) / parent::THREADS, parent::THREADS, 0,
                            stream>>>(a);
  return (int)cudaGetLastError();
}
"""

USE = "const float sg = r.x, ar = r.y, ag = r.z, ab = r.w;"
AHEAD = "const float4 rn = oob ? r : __ldg(&a.rec[nidx]);"
# -- no_ahead: each record loaded where its segment uses it
NO_AHEAD = [(AHEAD, "const float4 rn = r;"),
            (USE, "const float4 rv = __ldg(&a.rec[idx]);\n"
                  "      const float sg = rv.x, ar = rv.y, ag = rv.z, ab = rv.w;")]
# -- split_loads: sigma and albedo read from the plain grids, one scalar and
# three strided loads a segment (no record read)
SPLIT_LOADS = [(AHEAD, "const float4 rn = r;"),
               (USE, "const float sg = __ldg(&a.sigma[idx]), ar = __ldg(&a.albedo[3 * idx]),\n"
                     "                  ag = __ldg(&a.albedo[3 * idx + 1]),\n"
                     "                  ab = __ldg(&a.albedo[3 * idx + 2]);")]
# -- scalar_atomics: the gradient record, four scalar atomic adds a segment
# (each skipped at 0)
SCALAR_ATOMICS = [(
    """      if (g.x != 0.0f || g.y != 0.0f || g.z != 0.0f || g.w != 0.0f)
        atomicAdd(&a.grec[idx], g);   // result unused: one RED.E.ADD.F32x4""",
    """      float* gp = reinterpret_cast<float*>(&a.grec[idx]);
      if (g.x != 0.0f) atomicAdd(gp, g.x);
      if (g.y != 0.0f) atomicAdd(gp + 1, g.y);
      if (g.z != 0.0f) atomicAdd(gp + 2, g.z);
      if (g.w != 0.0f) atomicAdd(gp + 3, g.w);""")]
THREADS = "constexpr int BWD_THREADS = 128;"
BOUNDS = "__launch_bounds__(BWD_THREADS) diff_bwd_kernel("

VARIANTS = {
    "committed": [],
    "parent": [lambda s: s.replace(LAUNCHER, PARENT_SOURCE + "\n" + LAUNCHER)],
    "no_ahead": NO_AHEAD,
    "split_loads": SPLIT_LOADS,
    "scalar_atomics": SCALAR_ATOMICS,
    "threads_64": [(THREADS, "constexpr int BWD_THREADS = 64;")],
    "threads_256": [(THREADS, "constexpr int BWD_THREADS = 256;")],
    "bounds_16": [(BOUNDS, "__launch_bounds__(BWD_THREADS, 16) diff_bwd_kernel(")],
}


def _sub(src, old, new):
    if old not in src:
        raise RuntimeError(f"the source does not hold {old!r}")
    return src.replace(old, new)


def variant_source(name):
    """The source of one variant: the committed `diff.cu` with the
    variant's changes; raises if a change no longer applies."""
    src = (_build.CSRC / "diff.cu").read_text()
    for patch in VARIANTS[name]:
        if callable(patch):
            if LAUNCHER not in src:
                raise RuntimeError(f"the source does not hold {LAUNCHER!r}")
            src = patch(src)
        else:
            src = _sub(src, *patch)
    return src


def build_variants(names):
    """Compile the named variants, one nvcc process each, all started
    together; returns {name: (CDLL, ptxas lines)}."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        cu = OUT_DIR / f"diff_{name}.cu"
        cu.write_text(variant_source(name))
        so = OUT_DIR / f"libdiff_{name}.so"
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


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


class _ParentArgs(ctypes.Structure):
    """`ParentDiffArgs` of PARENT_SOURCE, field for field."""

    _fields_ = [(name, _P) for name in (
        "sigma", "albedo", "orig", "dirs", "color", "trans", "depth", "g_color",
        "g_trans", "g_depth", "d_sigma", "d_albedo")] + [
        (name, _I) for name in ("n", "gx", "gy", "gz", "max_steps")] + [
        ("vpu", _F), ("rvpu", _F)]


def parent_bwd(lib, sigma, albedo, o, d, vpu, max_steps, color, trans, depth, gC, gT, gD):
    """The parent's backward launcher, on its kernel: the two gradient grids
    zeroed, one launch."""
    d_sigma, d_albedo = torch.zeros_like(sigma), torch.zeros_like(albedo)
    gz, gy, gx = sigma.shape
    vpu = float(vpu)
    args = _ParentArgs(*(t.data_ptr() for t in (sigma, albedo, o, d, color, trans, depth,
                                                 gC, gT, gD, d_sigma, d_albedo)),
                       o.shape[0], gx, gy, gz, int(max_steps), vpu,
                       float(np.float32(1.0 / vpu)))
    lib.vt_diff_bwd_parent.argtypes = [ctypes.POINTER(_ParentArgs), _P]
    lib.vt_diff_bwd_parent.restype = _I
    dev = o.device
    with torch.cuda.device(dev):
        err = lib.vt_diff_bwd_parent(ctypes.byref(args),
                                     torch.cuda.current_stream(dev).cuda_stream)
    _build.raise_on(lib, err, "diff_bwd parent")
    return d_sigma, d_albedo


def call(name, lib, args):
    """fn() of one backward (march_bwd's arguments) with one variant's
    library."""
    if name == "parent":
        return lambda: parent_bwd(lib, *args)

    def fn():
        _build._LIBS["diff"] = lib
        return diff_kernel.march_bwd(*args)
    return fn


def inputs():
    """{tag: march_bwd's arguments}: [march]'s inputs, D2's outputs and the
    cotangents of [march]'s loss on them."""
    out = {}
    for tag, sigma, albedo, o, d, vpu, steps in cs.march_inputs():
        s, a = sigma.contiguous(), albedo.contiguous()
        fwd = diff_kernel.march_fwd(s, a, o, d, vpu, steps)
        outs = [x.detach().requires_grad_() for x in fwd]
        target = torch.from_numpy(np.random.RandomState(7).rand(o.shape[0], 3)
                                  .astype(np.float32)).to(o.device)
        loss = cs._march_loss(dict(zip(("color", "trans", "depth"), outs)), target)
        cts = torch.autograd.grad(loss, outs)
        out[tag] = (s, a, o, d, vpu, steps, *(x.detach().contiguous() for x in outs),
                    *(c.contiguous() for c in cts))
    return out


def bwd_device_ms(fn, reps):
    """(D3's device ms, the whole backward's device ms) a call of fn(), from
    one profiler window of ``reps`` calls: the spans over the D3 launches
    the window shows (a window late in a long process may miss some calls'
    events)."""
    for _ in range(3):
        _wall, events = cs.device_window(lambda: [fn() for _ in range(reps)])
        kern = [b - a for n, a, b in events if "diff_bwd_kernel" in n]
        if kern:
            seen = len(kern) * 1e3
            return sum(kern) / seen, sum(b - a for _n, a, b in events) / seen
    return None, None


def check(tag, got, ref, sigma):
    """Raise unless ``got`` is within GRAD_RTOL x max|g| of the plain
    backward ``ref`` and d sigma is 0 where sigma <= 0; returns the
    relative error."""
    rel = max(float((g - r).abs().max()) / max(float(r.abs().max()), 1e-30)
              for g, r in zip(got, ref))
    cs.require(rel <= cs.MARCH_GRAD_RTOL, f"{tag}: D3 differs from the plain backward: {rel}")
    cs.require(not bool(got[0][sigma <= 0].any()), f"{tag}: d sigma where sigma <= 0")
    return rel


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", help="comma-separated subset of the variants (default: all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_diff_trials: no CUDA device available", file=sys.stderr)
        return 2
    smi = cs.nvidia_smi()
    cs.log(f"[device] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    names = args.variants.split(",") if args.variants else list(VARIANTS)
    libs = build_variants(names)
    for name, (lib, ptxas) in libs.items():
        for ln in ptxas:
            cs.log(f"[build] {name}: {ln}")
    committed = _build.load("diff")
    ins = inputs()
    plain = {tag: diff._render_bwd(*a) for tag, a in ins.items()}
    for name, (lib, _) in libs.items():
        errs = [check(f"{name} {tag}", call(name, lib, a)(), plain[tag], a[0])
                for tag, a in ins.items()]
        cs.log(f"[trials] {name}: every input within {max(errs):.3g} x max|g| of the plain "
               f"backward; d sigma 0 where sigma <= 0")

    order = list(libs)
    readings = {tag: {v: [] for v in order} for tag in ins}
    for turn, name in enumerate(order + order[::-1]):
        lib = libs[name][0]
        parts = []
        for tag, a in ins.items():
            fn = call(name, lib, a)
            fn()
            ms = cs.cuda_ms(lambda i: fn(), 10)
            dev, whole = bwd_device_ms(fn, 3)
            readings[tag][name].append((ms, dev, whole))
            parts.append(f"{tag} {ms:.4f} ms (D3 "
                         f"{'n/a' if dev is None else f'{dev:.4f}'}, whole "
                         f"{'n/a' if whole is None else f'{whole:.4f}'})")
        cs.log(f"[trials] turn {turn} {name}: " + ", ".join(parts))
    _build._LIBS["diff"] = committed
    for tag, per in readings.items():
        for name, r in per.items():
            devs, wholes = [x[1] for x in r], [x[2] for x in r]
            ok = all(x is not None for x in devs + wholes)
            cs.log(f"[trials] {tag} {name}: mean {sum(x[0] for x in r) / len(r):.4f} ms, "
                   + (f"D3 device mean {sum(devs) / len(devs):.4f} ms, whole backward "
                      f"{sum(wholes) / len(wholes):.4f} ms" if ok else "device not measured"))
    summary = {"device": smi, "ptxas": {n: v[1] for n, v in libs.items()},
               "readings": readings}
    with open(OUT_DIR / "diff_trials.json", "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
