#!/usr/bin/env python3
"""Design trials of the port's differentiable-march kernels D2 and D3
(`voxel_tracer_tpu_torch/csrc/diff.cu`: `diff_fwd_kernel`,
`diff_bwd_kernel`, and the record's pack `diff_pack_kernel`) on one
NVIDIA GPU.

The parent design is the first D2 and D3 (one thread a ray on the plain
grids: a scalar sigma load and three strided albedo loads a segment, D3
with up to four scalar atomic adds into the two gradient grids, a NaN
delta clamped to BIG), built beside the committed kernels with its own
argument struct and launchers (`vt_diff_fwd_parent`, `vt_diff_bwd_parent`)
and held to the plain march on the rays with a finite direction.  Beside
it, timed in turns in one process:

- D2: the committed kernel on a record packed beforehand (`d2`), with its
  pack kernel (`d2_pack`: what the forward under autograd launches), with
  torch's pack (`d2_torch_pack`), on the plain grids
  (`d2_grids`: `diff_fwd_kernel<false>`), with each voxel read where its
  segment uses it (`d2_no_ahead`, a variant), and on rays sorted by a
  coherence key computed on the card (`d2_sorted`, a variant: the
  direction octant above the Morton code of the entry cell, argsort, the
  kernel reading ray perm[i] and writing its outputs at perm[i]; the key
  and the sort counted);
- D3: the whole backward on the record the forward saved (`d3_shared`:
  zeroed gradient record, D3, torch's unpack), packing its own record
  (`d3_own_pack`), with torch's pack (`d3_torch_pack`), on the sorted
  order (`d3_sorted`, the permutation reused), and the replay's earlier
  levers moved back (variants: `no_ahead`, `split_loads`,
  `scalar_atomics`, `threads_64`, `threads_256`, `bounds_16`; each packs
  its own record, as they were first timed);
- the copies alone on each grid: the pack kernel (`pack`), torch.cat
  (`pack_torch`) and the pack four voxels a thread with 16-byte loads
  and stores (`pack_vector`, a variant); the unpack as torch's strided
  copies (`unpack`, committed) and as a kernel one voxel a thread or
  four (`unpack_kernel`, `unpack_vector`, a variant);
- on the trainer batch, D2 and D3 reading its rays in the order of their
  indices, that is view by view (`d2_index_order`, `d3_index_order`: the
  sorted variant with the argsort of the sampler's indices, made on the
  host), and D2 on the batch gathered in that order (`d2_index_gather`;
  through the permuting kernel with the identity and with a random
  permutation: `d2_gather_identity`, `d2_gather_shuffled`); on
  inverse_128's view-ordered step, D2 on its rays gathered in a random
  order (`d2_shuffled`);
- a sweep of rays per voxel for the template rule of a call that needs no
  gradient: `d2_grids` against `d2_pack` on the first k rays of the
  trainer batch on its 128^3 grid, and of workload 4's rays on its 64^3
  grid.

The inputs are `chip_smoke.py` [march]'s: workload 4's (262,144 plane
rays, 64^3 blob, 128 steps), inverse_128's view-ordered step (131,072
ring rays, 128^3, 192 steps), the edge rays (NaN directions among
them), the z-slab, sigma zeros with albedo negatives, and the wavefront
trainer's first batch (inverse_128's rays drawn at random,
`trainer.draw_batch`); the cotangents are those of [march]'s loss.

Every variant is held to the plain march before it is timed: D2's fields
equal (max |d| reported, limit MARCH_ATOL) with the same NaN rays, D3's
gradients with the same NaN entries and within GRAD_RTOL x max|g| over
the rest (atomics sum in run-dependent order), d sigma 0 where sigma <=
0, the copies bit for bit.  Each reading is CUDA events over 10 calls
and one profiler window of 3 calls: the named kernel's device span and
all spans of a call (the kernel and its glue).  Prints the ptxas lines of
each variant, one line per turn, a summary line per input and mode, and
a JSON summary as the last line (also written to
`build/voxel_tracer_tpu_torch/trials/diff_trials.json`, or --out).

Run from the repository root on a machine with a card:
    python3 tools/torch_diff_trials.py [--variants a,b,...] [--out PATH]
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
from voxel_tracer_tpu_torch.ops import dda, diff  # noqa: E402
from voxel_tracer_tpu_torch.ops.cuda import _build  # noqa: E402
from voxel_tracer_tpu_torch.ops.cuda import diff as diff_kernel  # noqa: E402

OUT_DIR = _build.BUILD_DIR / "trials"
LAUNCHER = 'extern "C" int vt_diff_fwd(const DiffArgs* args, cudaStream_t stream)'

# -- parent: the first D2 and D3, their own argument struct and
# launchers, beside the committed ones
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

__global__ void __launch_bounds__(THREADS) diff_fwd_kernel(const ParentDiffArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < a.n) march_ray<false>(a, i);
}

__global__ void __launch_bounds__(THREADS) diff_bwd_kernel(const ParentDiffArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < a.n) march_ray<true>(a, i);
}

}  // namespace parent

extern "C" int vt_diff_fwd_parent(const ParentDiffArgs* args, cudaStream_t stream) {
  const ParentDiffArgs a = *args;
  parent::diff_fwd_kernel<<<(a.n + parent::THREADS - 1) / parent::THREADS, parent::THREADS, 0,
                            stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int vt_diff_bwd_parent(const ParentDiffArgs* args, cudaStream_t stream) {
  const ParentDiffArgs a = *args;
  parent::diff_bwd_kernel<<<(a.n + parent::THREADS - 1) / parent::THREADS, parent::THREADS, 0,
                            stream>>>(a);
  return (int)cudaGetLastError();
}
"""

# -- D2's lever: no voxel requested ahead (each read where its segment uses it)
D2_NO_AHEAD = [("    const float4 vn = oob ? v : voxel<REC>(a, nidx);\n", ""),
               ("    v = vn;\n", "    v = voxel<REC>(a, nidx);\n")]
# -- sorted: each thread marches (D2) or replays (D3) ray perm[thread]
SORTED = [("  float rvpu;\n};",
           "  float rvpu;\n  const int* perm;           // the ray of each thread\n};"),
          ("  if (i < a.n) march_ray<REC>(a, i);", "  if (i < a.n) march_ray<REC>(a, a.perm[i]);"),
          ("  if (i < a.n) replay_ray(a, i);", "  if (i < a.n) replay_ray(a, a.perm[i]);")]
# -- D3's levers, each moved back
USE = "const float sg = r.x, ar = r.y, ag = r.z, ab = r.w;"
AHEAD = "const float4 rn = oob ? r : __ldg(&a.rec[nidx]);"
# no_ahead: each record loaded where its segment uses it
NO_AHEAD = [(AHEAD, "const float4 rn = r;"),
            (USE, "const float4 rv = __ldg(&a.rec[idx]);\n"
                  "      const float sg = rv.x, ar = rv.y, ag = rv.z, ab = rv.w;")]
# split_loads: sigma and albedo read from the plain grids, one scalar and
# three strided loads a segment (no record read)
SPLIT_LOADS = [(AHEAD, "const float4 rn = r;"),
               (USE, "const float sg = __ldg(&a.sigma[idx]), ar = __ldg(&a.albedo[3 * idx]),\n"
                     "                  ag = __ldg(&a.albedo[3 * idx + 1]),\n"
                     "                  ab = __ldg(&a.albedo[3 * idx + 2]);")]
# scalar_atomics: the gradient record, four scalar atomic adds a segment
# (each skipped at 0)
SCALAR_ATOMICS = [(
    """      if (g.x != 0.0f || g.y != 0.0f || g.z != 0.0f || g.w != 0.0f)
        atomicAdd(&a.grec[idx], g);   // result unused: one RED.E.ADD.F32x4""",
    """      float* gp = reinterpret_cast<float*>(&a.grec[idx]);
      if (g.x != 0.0f) atomicAdd(gp, g.x);
      if (g.y != 0.0f) atomicAdd(gp + 1, g.y);
      if (g.z != 0.0f) atomicAdd(gp + 2, g.z);
      if (g.w != 0.0f) atomicAdd(gp + 3, g.w);""")]
# -- pack_vector: the pack four voxels a thread, 16-byte loads and stores
# (one of sigma, three of albedo, four records) where every pointer is at
# 16-byte alignment
PACK_SCALAR_LAUNCH = """  const int64_t blocks = (m + COPY_THREADS - 1) / COPY_THREADS;
  diff_pack_kernel<<<(unsigned)blocks, COPY_THREADS, 0, stream>>>(sigma, albedo, rec, m);"""
PACK_VECTOR_LAUNCH = """  if ((((uintptr_t)sigma | (uintptr_t)albedo | (uintptr_t)rec) & 15) == 0) {
    const int64_t quads = ((m + 3) / 4 + COPY_THREADS - 1) / COPY_THREADS;
    diff_pack_vector_kernel<<<(unsigned)quads, COPY_THREADS, 0, stream>>>(sigma, albedo, rec, m);
    return (int)cudaGetLastError();
  }
""" + PACK_SCALAR_LAUNCH
PACK_VECTOR_KERNEL = r"""
__global__ void __launch_bounds__(COPY_THREADS) diff_pack_vector_kernel(
    const float* __restrict__ sigma, const float* __restrict__ albedo,
    float4* __restrict__ rec, int64_t m) {
  const int64_t q = (int64_t)blockIdx.x * COPY_THREADS + threadIdx.x;
  if (4 * q + 3 < m) {
    const float4 s = __ldg(reinterpret_cast<const float4*>(sigma) + q);
    const float4* ap = reinterpret_cast<const float4*>(albedo) + 3 * q;
    const float4 a0 = __ldg(ap), a1 = __ldg(ap + 1), a2 = __ldg(ap + 2);
    float4* r = rec + 4 * q;
    r[0] = make_float4(s.x, a0.x, a0.y, a0.z);
    r[1] = make_float4(s.y, a0.w, a1.x, a1.y);
    r[2] = make_float4(s.z, a1.z, a1.w, a2.x);
    r[3] = make_float4(s.w, a2.y, a2.z, a2.w);
    return;
  }
  for (int64_t v = 4 * q; v < m; ++v)
    rec[v] = make_float4(sigma[v], albedo[3 * v], albedo[3 * v + 1], albedo[3 * v + 2]);
}

}  // namespace"""
PACK_VECTOR = [(PACK_SCALAR_LAUNCH, PACK_VECTOR_LAUNCH), ("\n}  // namespace", PACK_VECTOR_KERNEL)]
# -- unpack_kernels: the gradient record's unpack as a kernel (torch's two
# strided copies are committed), one voxel a thread (`vt_diff_unpack`) or
# four voxels a thread with 16-byte loads and stores (`vt_diff_unpack_vector`)
UNPACK_SOURCE = r"""
namespace unpack {

constexpr int THREADS = 256;

template <bool VEC>
__global__ void __launch_bounds__(THREADS) diff_unpack_kernel(
    const float4* __restrict__ grec, float* __restrict__ d_sigma,
    float* __restrict__ d_albedo, int64_t m) {
  const int64_t q = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (VEC && 4 * q + 3 < m) {
    const float4 g0 = __ldg(&grec[4 * q]), g1 = __ldg(&grec[4 * q + 1]),
                 g2 = __ldg(&grec[4 * q + 2]), g3 = __ldg(&grec[4 * q + 3]);
    reinterpret_cast<float4*>(d_sigma)[q] = make_float4(g0.x, g1.x, g2.x, g3.x);
    float4* ap = reinterpret_cast<float4*>(d_albedo) + 3 * q;
    ap[0] = make_float4(g0.y, g0.z, g0.w, g1.y);
    ap[1] = make_float4(g1.z, g1.w, g2.y, g2.z);
    ap[2] = make_float4(g2.w, g3.y, g3.z, g3.w);
    return;
  }
  for (int64_t v = VEC ? 4 * q : q; v < (VEC ? m : min(m, q + 1)); ++v) {
    const float4 g = __ldg(&grec[v]);
    d_sigma[v] = g.x;
    d_albedo[3 * v] = g.y;
    d_albedo[3 * v + 1] = g.z;
    d_albedo[3 * v + 2] = g.w;
  }
}

}  // namespace unpack

extern "C" int vt_diff_unpack(const float4* grec, float* d_sigma, float* d_albedo, int64_t m,
                              cudaStream_t stream) {
  const int64_t blocks = (m + unpack::THREADS - 1) / unpack::THREADS;
  unpack::diff_unpack_kernel<false><<<(unsigned)blocks, unpack::THREADS, 0, stream>>>(
      grec, d_sigma, d_albedo, m);
  return (int)cudaGetLastError();
}

extern "C" int vt_diff_unpack_vector(const float4* grec, float* d_sigma, float* d_albedo,
                                     int64_t m, cudaStream_t stream) {
  const int64_t blocks = ((m + 3) / 4 + unpack::THREADS - 1) / unpack::THREADS;
  unpack::diff_unpack_kernel<true><<<(unsigned)blocks, unpack::THREADS, 0, stream>>>(
      grec, d_sigma, d_albedo, m);
  return (int)cudaGetLastError();
}
"""
THREADS = "constexpr int BWD_THREADS = 128;"
BOUNDS = "__launch_bounds__(BWD_THREADS) diff_bwd_kernel("

VARIANTS = {
    "committed": [],
    "parent": [lambda s: s.replace(LAUNCHER, PARENT_SOURCE + "\n" + LAUNCHER)],
    "d2_no_ahead": D2_NO_AHEAD,
    "sorted": SORTED,
    "pack_vector": PACK_VECTOR,
    "unpack_kernels": [lambda s: s.replace(LAUNCHER, UNPACK_SOURCE + "\n" + LAUNCHER)],
    "no_ahead": NO_AHEAD,
    "split_loads": SPLIT_LOADS,
    "scalar_atomics": SCALAR_ATOMICS,
    "threads_64": [(THREADS, "constexpr int BWD_THREADS = 64;")],
    "threads_256": [(THREADS, "constexpr int BWD_THREADS = 256;")],
    "bounds_16": [(BOUNDS, "__launch_bounds__(BWD_THREADS, 16) diff_bwd_kernel(")],
}
D3_LEVERS = ("no_ahead", "split_loads", "scalar_atomics", "threads_64", "threads_256",
             "bounds_16")


def _sub(src, old, new):
    if src.count(old) != 1:
        raise RuntimeError(f"the source holds {old!r} {src.count(old)} times, not once")
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


class _SortedArgs(ctypes.Structure):
    """`DiffArgs` of the sorted variant: the committed fields and perm."""

    _fields_ = diff_kernel._Args._fields_ + [("perm", _P)]


def _launch_parent(lib, fn, ptrs, sigma, o, vpu, max_steps):
    gz, gy, gx = sigma.shape
    vpu = float(vpu)
    args = _ParentArgs(*ptrs, o.shape[0], gx, gy, gz, int(max_steps), vpu,
                       float(np.float32(1.0 / vpu)))
    f = getattr(lib, fn)
    f.argtypes = [ctypes.POINTER(_ParentArgs), _P]
    f.restype = _I
    dev = o.device
    with torch.cuda.device(dev):
        err = f(ctypes.byref(args), torch.cuda.current_stream(dev).cuda_stream)
    _build.raise_on(lib, err, fn)


def parent_fwd(lib, sigma, albedo, o, d, vpu, max_steps):
    """The parent's forward: (color, trans, depth) from one launch."""
    n = o.shape[0]
    color = torch.empty((n, 3), dtype=torch.float32, device=o.device)
    trans, depth = (torch.empty((n,), dtype=torch.float32, device=o.device) for _ in "td")
    _launch_parent(lib, "vt_diff_fwd_parent",
                   [t.data_ptr() for t in (sigma, albedo, o, d, color, trans, depth)]
                   + [None] * 5, sigma, o, vpu, max_steps)
    return color, trans, depth


def parent_bwd(lib, sigma, albedo, o, d, vpu, max_steps, color, trans, depth, gC, gT, gD):
    """The parent's backward launcher, on its kernel: the two gradient grids
    zeroed, one launch."""
    d_sigma, d_albedo = torch.zeros_like(sigma), torch.zeros_like(albedo)
    _launch_parent(lib, "vt_diff_bwd_parent",
                   [t.data_ptr() for t in (sigma, albedo, o, d, color, trans, depth,
                                           gC, gT, gD, d_sigma, d_albedo)],
                   sigma, o, vpu, max_steps)
    return d_sigma, d_albedo


def _spread10(v):
    """The 10 low bits of each int64 spread to every third bit."""
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    return (v | (v << 2)) & 0x09249249


def ray_order(sigma, o, d, vpu):
    """A permutation of the rays (int32, on their device) that sorts them
    by direction octant, then by the Morton code of the cell where each
    enters the grid (its origin's where it starts inside; cell 0 for NaN)."""
    gz, gy, gx = sigma.shape
    hi = torch.tensor([gx - 1, gy - 1, gz - 1], device=o.device)
    size = (hi + 1).to(torch.float32) / vpu
    tmin = dda.slab_test(o, d, size)[0]
    e = torch.nan_to_num((o + d * tmin[:, None]) * vpu, nan=0.0, posinf=0.0, neginf=0.0)
    cell = torch.minimum(torch.clamp(torch.floor(e), min=0).to(torch.int64), hi)
    key = _spread10(cell[:, 0]) | (_spread10(cell[:, 1]) << 1) | (_spread10(cell[:, 2]) << 2)
    sign = torch.signbit(d).to(torch.int64)
    key = key | ((sign[:, 0] | (sign[:, 1] << 1) | (sign[:, 2] << 2)) << 30)
    return torch.argsort(key).to(torch.int32)


def _launch_sorted(lib, fn, perm, sigma, albedo, o, d, vpu, max_steps, color, trans, depth,
                   cts=(None, None, None), recs=(None, None)):
    gz, gy, gx = sigma.shape
    vpu = float(vpu)
    ptrs = [None if t is None else t.data_ptr()
            for t in (sigma, albedo, o, d, color, trans, depth, *cts, *recs)]
    args = _SortedArgs(*ptrs, o.shape[0], gx, gy, gz, int(max_steps), vpu,
                       float(np.float32(1.0 / vpu)), perm.data_ptr())
    f = getattr(lib, fn)
    f.argtypes = [ctypes.POINTER(_SortedArgs), _P]
    f.restype = _I
    with torch.cuda.device(o.device):
        err = f(ctypes.byref(args), torch.cuda.current_stream(o.device).cuda_stream)
    _build.raise_on(lib, err, fn)


def sorted_fwd(lib, sigma, albedo, o, d, vpu, max_steps, rec, perm=None):
    """D2 of the sorted variant: the permutation ``perm``, else computed on
    the card (`ray_order`), then one launch on the record; returns (color,
    trans, depth, perm)."""
    if perm is None:
        perm = ray_order(sigma, o, d, vpu)
    n = o.shape[0]
    color = torch.empty((n, 3), dtype=torch.float32, device=o.device)
    trans, depth = (torch.empty((n,), dtype=torch.float32, device=o.device) for _ in "td")
    _launch_sorted(lib, "vt_diff_fwd", perm, sigma, albedo, o, d, vpu, max_steps, color,
                   trans, depth, recs=(rec, None))
    return color, trans, depth, perm


def sorted_bwd(lib, perm, rec, sigma, albedo, o, d, vpu, max_steps, color, trans, depth,
               gC, gT, gD):
    """D3 of the sorted variant on the forward's permutation and record."""
    grec = torch.zeros_like(rec)
    _launch_sorted(lib, "vt_diff_bwd", perm, sigma, albedo, o, d, vpu, max_steps, color,
                   trans, depth, cts=(gC, gT, gD), recs=(rec, grec))
    return diff_kernel.unpack_grads(grec, sigma.shape)


def with_lib(lib, fn):
    """fn() run with ``lib`` in place of the port's diff library."""
    def run():
        saved = _build._LIBS.get("diff")
        _build._LIBS["diff"] = lib
        try:
            return fn()
        finally:
            _build._LIBS["diff"] = saved
    return run


def with_torch_pack(fn):
    """fn() run with torch's pack in place of the kernel."""
    def run():
        saved = diff_kernel.pack_record
        diff_kernel.pack_record = diff_kernel.pack_record_plain
        try:
            return fn()
        finally:
            diff_kernel.pack_record = saved
    return run


def unpack_kernel(lib, fn, grec, shape):
    """The unpack_kernels variant's launcher ``fn``: (d sigma, d albedo)."""
    d_sigma = torch.empty(tuple(shape), dtype=torch.float32, device=grec.device)
    d_albedo = torch.empty((*shape, 3), dtype=torch.float32, device=grec.device)
    f = getattr(lib, fn)
    f.argtypes = [_P, _P, _P, ctypes.c_int64, _P]
    f.restype = _I
    with torch.cuda.device(grec.device):
        err = f(grec.data_ptr(), d_sigma.data_ptr(), d_albedo.data_ptr(), d_sigma.numel(),
                torch.cuda.current_stream(grec.device).cuda_stream)
    _build.raise_on(lib, err, fn)
    return d_sigma, d_albedo


def finite_rays(args):
    """march_fwd's first six arguments with the NaN-direction rays left out
    (the parent clamps their delta), and whether any were."""
    s, a, o, d, vpu, steps = args
    keep = ~torch.isnan(d).any(dim=1)
    if bool(keep.all()):
        return args, False
    return (s, a, o[keep].contiguous(), d[keep].contiguous(), vpu, steps), True


def cotangents(outs):
    """The cotangents of [march]'s loss on (color, trans, depth)."""
    outs = [x.detach().requires_grad_() for x in outs]
    target = torch.from_numpy(np.random.RandomState(7).rand(outs[0].shape[0], 3)
                              .astype(np.float32)).to(outs[0].device)
    loss = cs._march_loss(dict(zip(("color", "trans", "depth"), outs)), target)
    return tuple(c.contiguous() for c in torch.autograd.grad(loss, outs))


def fwd_diff(got, ref):
    """(NaN masks equal, max |d| over the reference's finite entries)."""
    eq = all(torch.equal(torch.isnan(g), torch.isnan(r)) for g, r in zip(got, ref))
    err = max(cs._maxabs(torch.where(torch.isnan(r), 0.0, g - r)) for g, r in zip(got, ref))
    return eq, err


def check_fwd(tag, got, ref):
    eq, err = fwd_diff(got[:3], ref)
    cs.require(eq and err <= cs.MARCH_ATOL, f"{tag}: D2 differs from the plain march: "
               f"NaN masks equal {eq}, max |d| {err}")
    return err


def check_bwd(tag, got, ref, sigma):
    """Raise unless ``got`` has the plain backward's NaN entries and is
    within GRAD_RTOL x max|g| of it elsewhere, with d sigma 0 where sigma
    <= 0; returns the relative error."""
    eq, rel, _ = cs.grad_diff(got, ref)
    cs.require(eq and rel <= cs.MARCH_GRAD_RTOL,
               f"{tag}: D3 differs from the plain backward: NaN masks equal {eq}, {rel}")
    cs.require(not bool(got[0][sigma <= 0].any()), f"{tag}: d sigma where sigma <= 0")
    return rel


def device_ms(fn, reps, name):
    """(device ms a call of the kernels whose name holds ``name``, device
    ms a call of all kernels) from one profiler window of ``reps`` calls;
    the spans over the launches the window shows (a window late in a long
    process may miss some calls' events)."""
    for _ in range(3):
        _wall, events = cs.device_window(lambda: [fn() for _ in range(reps)])
        kern = [b - a for n, a, b in events if name in n]
        if kern:
            seen = len(kern) * 1e3
            return sum(kern) / seen, sum(b - a for _n, a, b in events) / seen
    return None, None


def call(name, lib, args):
    """fn() of one backward (march_bwd's arguments) with one variant's
    library: the parent's launcher for "parent", else the port's."""
    if name == "parent":
        return lambda: parent_bwd(lib, *args)
    return with_lib(lib, lambda: diff_kernel.march_bwd(*args))


def runs_of(tag, args, libs):
    """{mode: (fn, kernel name, check)} of one input; check(out) raises
    unless the mode's output equals the plain version's.  ``args``:
    march_fwd's six arguments."""
    s, a, o, d, vpu, steps = args
    ref_f = diff._render_fwd_only(*args)
    c, t, dp = ref_f
    cts = cotangents(ref_f)
    bwd_args = (*args, c, t, dp, *cts)
    ref_b = diff._render_bwd(*bwd_args)
    rec = diff_kernel.pack_record(s, a)
    grec = torch.randn(rec.shape, generator=torch.Generator(o.device).manual_seed(3),
                       device=o.device)
    fwd = lambda what: (lambda out: check_fwd(f"{what} {tag}", out, ref_f))  # noqa: E731
    bwd = lambda what: (lambda out: check_bwd(f"{what} {tag}", out, ref_b, s))  # noqa: E731
    com = libs["committed"][0]
    runs = {
        "d2": (with_lib(com, lambda: diff_kernel.march_fwd(*args, rec)), "diff_fwd", fwd("d2")),
        "d2_pack": (with_lib(com, lambda: diff_kernel.march_fwd(
            *args, diff_kernel.pack_record(s, a))), "diff_fwd", fwd("d2_pack")),
        "d2_torch_pack": (with_lib(com, lambda: diff_kernel.march_fwd(
            *args, diff_kernel.pack_record_plain(s, a))), "diff_fwd", fwd("d2_torch_pack")),
        "d2_grids": (with_lib(com, lambda: diff_kernel.march_fwd(*args)), "diff_fwd",
                     fwd("d2_grids")),
        "d3_shared": (with_lib(com, lambda: diff_kernel.march_bwd(*bwd_args, rec=rec)),
                      "diff_bwd", bwd("d3_shared")),
        "d3_own_pack": (with_lib(com, lambda: diff_kernel.march_bwd(*bwd_args)), "diff_bwd",
                        bwd("d3_own_pack")),
        "d3_torch_pack": (with_lib(com, with_torch_pack(
            lambda: diff_kernel.march_bwd(*bwd_args))), "diff_bwd", bwd("d3_torch_pack")),
    }

    def same(what, ref):
        def chk(out):
            cs.require(all(torch.equal(x, y) for x, y in zip(out, ref)),
                       f"{what} {tag}: the kernel differs from torch's copy")
        return chk
    ref_pack = (diff_kernel.pack_record_plain(s, a),)
    ref_unpack = diff_kernel.unpack_grads(grec, s.shape)
    runs.update({
        "pack": (with_lib(com, lambda: (diff_kernel.pack_record(s, a),)), "diff_pack",
                 same("pack", ref_pack)),
        "pack_torch": (lambda: (diff_kernel.pack_record_plain(s, a),), "Cat", lambda out: None),
        "unpack": (lambda: diff_kernel.unpack_grads(grec, s.shape), "copy", lambda out: None),
    })
    if tag in ("inverse_128 step", "inverse_128 trainer batch"):
        # the same rays in another order, gathered (no permutation in the
        # kernel): the view-ordered step shuffled, the trainer batch in the
        # order of its indices
        if tag == "inverse_128 step":
            order = np.random.RandomState(5).permutation(o.shape[0])
            mode = "d2_shuffled"
        else:
            from voxel_tracer_tpu_torch.trainer import draw_batch
            order = np.argsort(draw_batch(np.random.RandomState(0), o.shape[0], o.shape[0],
                                          "wavefront"), kind="stable")
            mode = "d2_index_gather"
        oi = torch.from_numpy(order).to(o.device)
        go, gd = o[oi].contiguous(), d[oi].contiguous()
        gref = tuple(x[oi] for x in ref_f)
        runs[mode] = (with_lib(com, lambda: diff_kernel.march_fwd(s, a, go, gd, vpu, steps, rec)),
                      "diff_fwd", lambda out: check_fwd(f"{mode} {tag}", out, gref))
        if "sorted" in libs and mode == "d2_index_gather":
            # the gathered batch through the permuting kernel: the identity,
            # and a random permutation
            lib_o = libs["sorted"][0]
            for pmode, pp in (("d2_gather_identity", np.arange(o.shape[0])),
                              ("d2_gather_shuffled", np.random.RandomState(6).permutation(
                                  o.shape[0]))):
                pt = torch.from_numpy(pp.astype(np.int32)).to(o.device)
                runs[pmode] = ((lambda pt=pt: sorted_fwd(lib_o, s, a, go, gd, vpu, steps, rec,
                                                         pt)), "diff_fwd",
                               (lambda out, pmode=pmode: check_fwd(f"{pmode} {tag}", out,
                                                                   gref)))
    if "pack_vector" in libs:
        runs["pack_vector"] = (with_lib(libs["pack_vector"][0],
                                        lambda: (diff_kernel.pack_record(s, a),)),
                               "diff_pack", same("pack_vector", ref_pack))
    if "unpack_kernels" in libs:
        lib_u = libs["unpack_kernels"][0]
        for mode, fn in (("unpack_kernel", "vt_diff_unpack"),
                         ("unpack_vector", "vt_diff_unpack_vector")):
            runs[mode] = ((lambda fn=fn: unpack_kernel(lib_u, fn, grec, s.shape)),
                          "diff_unpack", same(mode, ref_unpack))
    if "d2_no_ahead" in libs:
        runs["d2_no_ahead"] = (with_lib(libs["d2_no_ahead"][0], lambda: diff_kernel.march_fwd(
            *args, rec)), "diff_fwd", fwd("d2_no_ahead"))
    if "sorted" in libs:
        lib_o = libs["sorted"][0]
        perm = sorted_fwd(lib_o, s, a, o, d, vpu, steps, rec)[3]
        runs["d2_sorted"] = (lambda: sorted_fwd(lib_o, s, a, o, d, vpu, steps, rec), "diff_fwd",
                             fwd("d2_sorted"))
        runs["d3_sorted"] = (lambda: sorted_bwd(lib_o, perm, rec, *bwd_args), "diff_bwd",
                             bwd("d3_sorted"))
    if "sorted" in libs and tag == "inverse_128 trainer batch":
        # the batch in the order of its rays' indices (the views' order):
        # what a sampler that sorts the indices it draws would hand D2 / D3
        from voxel_tracer_tpu_torch.trainer import draw_batch
        idx = draw_batch(np.random.RandomState(0), o.shape[0], o.shape[0], "wavefront")
        iperm = torch.from_numpy(np.argsort(idx, kind="stable").astype(np.int32)).to(o.device)
        runs["d2_index_order"] = (lambda: sorted_fwd(lib_o, s, a, o, d, vpu, steps, rec, iperm),
                                  "diff_fwd", fwd("d2_index_order"))
        runs["d3_index_order"] = (lambda: sorted_bwd(lib_o, iperm, rec, *bwd_args), "diff_bwd",
                                  bwd("d3_index_order"))
    for name in D3_LEVERS:
        if name in libs:
            runs[name] = (call(name, libs[name][0], bwd_args), "diff_bwd", bwd(name))
    if "parent" in libs:
        lib_p = libs["parent"][0]
        fargs, dropped = finite_rays(args)
        pref_f = diff._render_fwd_only(*fargs) if dropped else ref_f
        pcts = cotangents(pref_f) if dropped else cts
        pargs = (*fargs, *pref_f, *pcts)
        pref_b = diff._render_bwd(*pargs) if dropped else ref_b
        runs["parent_d2"] = (lambda: parent_fwd(lib_p, *fargs), "diff_fwd",
                             lambda out: check_fwd(f"parent {tag}", out, pref_f))
        runs["parent_d3"] = (lambda: parent_bwd(lib_p, *pargs), "diff_bwd",
                             lambda out: check_bwd(f"parent {tag}", out, pref_b, s))
        if dropped:             # the committed kernels on the same rays, for the turns
            frec = rec
            runs["d2_finite"] = (with_lib(com, lambda: diff_kernel.march_fwd(*fargs, frec)),
                                 "diff_fwd", lambda out: check_fwd(f"d2 {tag}", out, pref_f))
            runs["d3_finite"] = (with_lib(com, lambda: diff_kernel.march_bwd(*pargs, rec=frec)),
                                 "diff_bwd",
                                 lambda out: check_bwd(f"d3 {tag}", out, pref_b, s))
    return runs


def sweep_inputs():
    """{tag: march_fwd's six arguments}: the first k rays of the trainer
    batch on its 128^3 grid and of workload 4's rays on its 64^3 grid."""
    ins = {tag: args for tag, *args in cs.march_inputs()}
    out = {}
    for tag, ks in (("inverse_128 trainer batch", (1024, 4096, 16384, 32768, 65536, 131072)),
                    ("workload 4", (1024, 4096, 16384, 65536, 262144))):
        s, a, o, d, vpu, steps = ins[tag]
        for k in ks:
            out[f"{tag} {k}"] = (s, a, o[:k].contiguous(), d[:k].contiguous(), vpu, steps)
    return out


def time_turns(runs, modes, log_tag):
    """Each mode's (events ms, kernel device ms, whole device ms), in turns
    (modes, then reversed); returns {mode: [readings]}."""
    readings = {m: [] for m in modes}
    for turn, mode in enumerate(modes + modes[::-1]):
        fn, name, _ = runs[mode]
        fn()
        ms = cs.cuda_ms(lambda i: fn(), 10)
        kern, whole = device_ms(fn, 3, name)
        readings[mode].append((ms, kern, whole))
        cs.log(f"[trials] {log_tag} turn {turn} {mode}: {ms:.4f} ms (kernel "
               f"{cs._opt_ms(kern)}, all {cs._opt_ms(whole)})")
    return readings


def mean_of(reads):
    out = []
    for j in range(3):
        xs = [r[j] for r in reads]
        out.append(None if any(x is None for x in xs) else sum(xs) / len(xs))
    return dict(ms=out[0], kernel_device_ms=out[1], device_ms=out[2])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", help="comma-separated subset of the variants (default: all)")
    ap.add_argument("--out", help="also write the JSON summary here")
    ap.add_argument("--no-sweep", action="store_true", help="skip the rays-per-voxel sweep")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_diff_trials: no CUDA device available", file=sys.stderr)
        return 2
    smi = cs.nvidia_smi()
    cs.log(f"[device] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    names = args.variants.split(",") if args.variants else list(VARIANTS)
    if "committed" not in names:
        names.insert(0, "committed")
    libs = build_variants(names)
    for name, (lib, ptxas) in libs.items():
        for ln in ptxas:
            cs.log(f"[build] {name}: {ln}")
    summary = {"device": smi, "ptxas": {n: v[1] for n, v in libs.items()}, "inputs": {},
               "sweep": {}}
    for tag, *a in cs.march_inputs():
        runs = runs_of(tag, tuple(a), libs)
        for mode, (fn, _name, chk) in runs.items():
            chk(fn())
        cs.log(f"[trials] {tag}: every mode equals the plain march (D2 max |d| <= "
               f"{cs.MARCH_ATOL}, same NaN rays; D3 within {cs.MARCH_GRAD_RTOL} x max|g|, "
               f"same NaN entries; copies bit for bit)")
        modes = [m for m in runs if not m.startswith(("parent", "d2_finite", "d3_finite"))]
        pmodes = [m for m in ("d2_finite", "parent_d2", "d3_finite", "parent_d3") if m in runs]
        reads = time_turns(runs, modes + pmodes, tag)
        summary["inputs"][tag] = {m: mean_of(r) for m, r in reads.items()}
        for m, r in summary["inputs"][tag].items():
            cs.log(f"[trials] {tag} {m}: mean {cs._opt_ms(r['ms'])}, kernel device "
                   f"{cs._opt_ms(r['kernel_device_ms'])}, all {cs._opt_ms(r['device_ms'])}")
    if not args.no_sweep:
        for tag, a in sweep_inputs().items():
            runs = runs_of(tag, a, {"committed": libs["committed"]})
            for m in ("d2_grids", "d2_pack"):
                runs[m][2](runs[m][0]())
            reads = time_turns(runs, ["d2_grids", "d2_pack"], tag)
            summary["sweep"][tag] = {m: mean_of(r) for m, r in reads.items()}
            g, p = (summary["sweep"][tag][m]["device_ms"] for m in ("d2_grids", "d2_pack"))
            cs.log(f"[trials] sweep {tag} ({a[2].shape[0] / a[0].numel():.4g} rays a voxel): "
                   f"grids {cs._opt_ms(g)}, pack + record {cs._opt_ms(p)}")
    blob = json.dumps(summary)
    (OUT_DIR / "diff_trials.json").write_text(blob)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(blob)
    print(blob, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
