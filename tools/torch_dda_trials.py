#!/usr/bin/env python3
"""Design trials of the port's DDA kernel D1 (`voxel_tracer_tpu_torch/csrc/dda.cu`)
on one NVIDIA GPU: the parent design (the first D1: the int32 grid and
brick counts read through __ldg on every brick test and fine step, one
loop over both levels, 128-thread blocks) beside the committed one (the
brick bitmap in shared memory, occupancy words, material bytes read only
at solid voxels, nested loops over bricks and over the voxels of an
occupied brick), and the
committed one with one lever moved: one loop over both levels (the
parent's shape) in place of nested loops over bricks and the voxels of an
occupied brick, the next occupancy word requested ahead, the bitmap from
global memory, where it is read from as a run-time flag in place of a
template argument, the ids read from the int32 grid at solid voxels in place of the
material bytes, other block shapes, launch bounds that cap the
registers.

Each variant is the committed source with textual changes, compiled with
the port's nvcc flags into `build/voxel_tracer_tpu_torch/trials/` and
called through the port's launcher (`ops/cuda/dda.intersect_volume_local`)
with its library in place of the port's; the parent variant adds the
parent's kernels and launcher (`vt_dda_parent`, its own argument struct)
beside the committed ones and is called the way the parent's wrapper
called it.  The inputs are `chip_smoke.py` [dda]'s lists (1 M random rays
through the bench volume, the budget volume, the medium budget batch,
the glass box interior and scan, shadow rays, stacked grids with and
without a medium) and the D1 calls of [dda frames]'s two frames at
1280x768 (the exact Whitted frame's 8 and the wavefront Renderer's 46),
captured once and replayed as a frame.

Every variant is held against the plain DDA on every input (integer
fields, flags and step signs equal, t within T_ATOL) before it is timed;
the parent only on rays with a finite direction (`parent_rays`).
Variants are timed in turns (A B C ... C B A), each turn with CUDA events
(10 calls; a frame's calls replayed 3 times) and profiler device time (the
spans of dda_kernel and dda_exhaust_kernel a call, or a frame).  Prints
the ptxas lines of each variant, one line per turn, and a JSON summary as
the last line (also written to
`build/voxel_tracer_tpu_torch/trials/dda_trials.json`).

Run from the repository root on a machine with a card:
    python3 tools/torch_dda_trials.py [--variants a,b,...] [--no-frames]
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from voxel_tracer_tpu_torch.ops import dda  # noqa: E402
from voxel_tracer_tpu_torch.ops.cuda import _build  # noqa: E402
from voxel_tracer_tpu_torch.ops.cuda import dda as d1  # noqa: E402

OUT_DIR = _build.BUILD_DIR / "trials"
LAUNCHER = 'extern "C" int vt_dda(const DdaArgs* args, cudaStream_t stream)'

# -- parent: the first D1 (PR 14), its own argument struct and launcher,
# beside the committed ones
PARENT_SOURCE = r"""
struct ParentArgs {
  const float* orig;          // (N, 3) local origins
  const float* dirs;          // (N, 3) local directions
  const int32_t* grid;        // (O, Z, Y, X) material ids, O = 1 without oid
  const int32_t* bocc;        // (O, BZ, BY, BX) solid counts per brick
  const float* vpu_ray;       // per-ray vpu (stride 1), a device scalar
                              // (stride 0), or null: the vpu field
  const int64_t* oid;         // (N,) object per ray, or null
  const int32_t* medium;      // (N,) medium id (0 = none), or null
  const int32_t* ignore;      // (N,) id passed until air, or null
  const int64_t* seed;        // (N,) uint32 shadow seeds, or null
  float* t;                   // outputs, (N,) unless noted
  float* slab_tmin;
  float* slab_tmax;
  float* step_sign;           // (N, 3)
  int32_t* mat;
  int32_t* axis;
  int32_t* steps;
  int32_t* entry_axis;
  uint8_t* valid;
  uint8_t* resolved;
  int32_t* pend;              // medium: c * 4 + ladder axis of a ray that
                              // stopped on the budget, else -1
  int32_t* maxc;              // medium: max transitions over the call
  int n;
  int gx, gy, gz;
  int bx, by, bz;
  int vpu_stride;
  int max_steps;
  int shadow;
  float vpu;
};

namespace parent {

constexpr float BIG_F32 = 1e30f;   // miss depth and clamp (math3d.py BIG_F32)
constexpr int BRICK = 8;
constexpr int THREADS = 128;

enum Mode { MODE_MISS = 0, MODE_BRICK = 1, MODE_FINE = 2, MODE_HIT = 3 };

// Axis of the next Amanatides-Woo step in the reference comparison order
// (vv.cpp:176-202); also the medium's grid-exit ladder (vv.cpp:208-219).
__device__ __forceinline__ int aw_axis(float tx, float ty, float tz) {
  const bool use_x = (tx < ty) && (tx < tz);
  const bool use_y = !(tx < ty) && (ty < tz);
  return use_x ? 0 : (use_y ? 1 : 2);
}

// First cell and crossing t of one axis of a DDA level (dda._cell_setup).
__device__ __forceinline__ void cell_setup(float e, bool pos, float rdir, int hi,
                                           int& cell, float& tm) {
  int c = (int)floorf(e);
  c = min(max(c, 0), hi);
  float v = (((float)c - e) + (pos ? 1.0f : 0.0f)) * rdir;
  if (isnan(v)) v = BIG_F32;
  cell = c;
  tm = fminf(v, BIG_F32);
}

// One axis of the slab test against [0, size] (dda.slab_test): the NaN
// guard maps 0 * inf on a slab plane to -BIG / +BIG; the first maximum of
// [0, tn_x, tn_y, tn_z] names the entry axis.
__device__ __forceinline__ void slab_axis(float o, float d, float size, int a,
                                          float& tmin, float& tmax, int& entry_arg) {
  const float rcp = 1.0f / d;
  const float t1 = (0.0f - o) * rcp;
  const float t2 = (size - o) * rcp;
  const bool nan = isnan(t1) || isnan(t2);
  const float tn = nan ? -BIG_F32 : fminf(t1, t2);
  const float tf = nan ? BIG_F32 : fmaxf(t1, t2);
  if (tn > tmin) {
    tmin = tn;
    entry_arg = a + 1;
  }
  tmax = (a == 0) ? tf : fminf(tmax, tf);
}

// dda.hash_shadow before its float conversion: lowbias32-style avalanche
// of (seed, cell) in uint32 arithmetic.
__device__ __forceinline__ uint32_t hash_shadow(uint32_t seed, int x, int y, int z) {
  uint32_t h = seed ^ ((uint32_t)x * 0x9E3779B1u) ^ ((uint32_t)y * 0x85EBCA77u) ^
               ((uint32_t)z * 0xC2B2AE3Du);
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  h ^= h >> 16;
  return h;
}

// Walks ray i to its end; writes every output but the batch rule's and
// returns the transitions made.
__device__ int walk_ray(const ParentArgs& a, int i) {
  const float ox = __ldg(&a.orig[3 * i]), oy = __ldg(&a.orig[3 * i + 1]),
              oz = __ldg(&a.orig[3 * i + 2]);
  const float dx = __ldg(&a.dirs[3 * i]), dy = __ldg(&a.dirs[3 * i + 1]),
              dz = __ldg(&a.dirs[3 * i + 2]);
  const float vpu =
      a.vpu_ray != nullptr ? __ldg(&a.vpu_ray[(size_t)i * a.vpu_stride]) : a.vpu;

  // ---- slab test --------------------------------------------------------
  float tmin = 0.0f, tmax = 0.0f;
  int entry_arg = 0;
  slab_axis(ox, dx, (float)a.gx / vpu, 0, tmin, tmax, entry_arg);
  slab_axis(oy, dy, (float)a.gy / vpu, 1, tmin, tmax, entry_arg);
  slab_axis(oz, dz, (float)a.gz / vpu, 2, tmin, tmax, entry_arg);
  const bool valid = tmax - 1e-4f >= tmin;
  const int entry_axis = max(entry_arg - 1, 0);

  // ---- constants of both levels and the brick level's start -------------
  const float bpu = vpu / 8.0f;
  const float rbpu = 1.0f / bpu;
  const bool px = !signbit(dx), py = !signbit(dy), pz = !signbit(dz);
  const int sx = px ? 1 : -1, sy = py ? 1 : -1, sz = pz ? 1 : -1;
  const float rx = 1.0f / dx, ry = 1.0f / dy, rz = 1.0f / dz;
  // clamp inf (axis-parallel rays) so tmax += delta never meets 0 * inf
  const float dlx = fminf(fabsf(rx), BIG_F32), dly = fminf(fabsf(ry), BIG_F32),
              dlz = fminf(fabsf(rz), BIG_F32);
  int bcx, bcy, bcz;
  float btx, bty, btz;
  cell_setup(fmaf(dx, tmin, ox) * bpu, px, rx, a.bx - 1, bcx, btx);
  cell_setup(fmaf(dy, tmin, oy) * bpu, py, ry, a.by - 1, bcy, bty);
  cell_setup(fmaf(dz, tmin, oz) * bpu, pz, rz, a.bz - 1, bcz, btz);

  a.slab_tmin[i] = tmin;
  a.slab_tmax[i] = tmax;
  a.entry_axis[i] = entry_axis;
  a.valid[i] = valid;
  a.step_sign[3 * i] = px ? 1.0f : -1.0f;
  a.step_sign[3 * i + 1] = py ? 1.0f : -1.0f;
  a.step_sign[3 * i + 2] = pz ? 1.0f : -1.0f;

  // ---- per-ray modes ----------------------------------------------------
  const int64_t obj = a.oid != nullptr ? (int64_t)__ldg((const long long*)&a.oid[i]) : 0;
  const int32_t* grid = a.grid + obj * ((int64_t)a.gz * a.gy * a.gx);
  const int32_t* bocc = a.bocc + obj * ((int64_t)a.bz * a.by * a.bx);
  const int med = a.medium != nullptr ? __ldg(&a.medium[i]) : 0;
  const bool med_on = med > 0;
  const bool has_ignore = a.ignore != nullptr;
  const int ign = has_ignore ? __ldg(&a.ignore[i]) : 0;
  const uint32_t seed =
      a.shadow ? (uint32_t)__ldg((const long long*)&a.seed[i]) : 0u;

  int mode = valid ? MODE_BRICK : MODE_MISS;
  float hit_t = BIG_F32;
  if (!valid && med_on) {     // a slab miss inside a medium exits at t = 0
    mode = MODE_HIT;
    hit_t = 0.0f;
  }
  float bt = 0.0f;            // t of the last brick step, brick units
  int fx = 0, fy = 0, fz = 0;
  float fmx = 0.0f, fmy = 0.0f, fmz = 0.0f;
  float ft = 0.0f;            // t of the last fine step, voxel units
  float b_entry = 0.0f;       // world t of the current brick's entry
  int axis = entry_axis, steps = 0, hit_mat = 0;
  bool hit_entry = false, exited = false, pending = false;
  const int max_steps = a.max_steps;
  const int cap = 2 * max_steps;
  int c = 0;                  // transitions: iterations the ray was active in

  while (mode == MODE_BRICK || mode == MODE_FINE) {
    if (steps >= max_steps) {   // out of budget: the batch rule decides
      pending = true;
      break;
    }
    if (c >= cap) break;
    ++c;
    if (mode == MODE_BRICK) {
      if (__ldg(&bocc[((int64_t)bcz * a.by + bcy) * a.bx + bcx]) > 0) {
        // enter the occupied brick (vv.cpp:237-251): no step
        const float bet = fmaf(bt, rbpu, tmin);
        cell_setup(fmaf(-(float)bcx, rbpu, fmaf(dx, bet, ox)) * vpu, px, rx,
                   BRICK - 1, fx, fmx);
        cell_setup(fmaf(-(float)bcy, rbpu, fmaf(dy, bet, oy)) * vpu, py, ry,
                   BRICK - 1, fy, fmy);
        cell_setup(fmaf(-(float)bcz, rbpu, fmaf(dz, bet, oz)) * vpu, pz, rz,
                   BRICK - 1, fz, fmz);
        ft = 0.0f;
        b_entry = bet;
        mode = MODE_FINE;
        continue;
      }
      if (med_on) {           // an empty brick exits at its entry plane
        mode = MODE_HIT;
        hit_t = fmaf(bt, rbpu, tmin);
        hit_mat = 0;
        hit_entry = steps == 0;
        continue;
      }
      if (ign > 0) exited = true;   // an empty brick is air
    } else {
      const int vx = bcx * BRICK + fx, vy = bcy * BRICK + fy, vz = bcz * BRICK + fz;
      const bool inb = vx < a.gx && vy < a.gy && vz < a.gz;
      const int voxel = inb ? __ldg(&grid[((int64_t)vz * a.gy + vy) * a.gx + vx]) : 0;
      const bool solid = voxel != 0;
      bool hv;
      if (a.shadow) {
        hv = solid && (voxel > 16 ||
                       (float)hash_shadow(seed, vx, vy, vz) * 2.3283064365386963e-10f > 0.85f);
      } else if (has_ignore) {
        hv = solid && (exited || voxel != ign);
      } else {
        hv = solid;
      }
      if (med_on) hv = voxel != med;   // the first voxel unlike the medium
      if (hv) {
        mode = MODE_HIT;
        hit_t = b_entry + ft / vpu;
        hit_mat = voxel;
        hit_entry = steps == 0;
        continue;
      }
      if (ign > 0 && !solid) exited = true;
      // one fine step; leaving the brick discards it for the brick step
      const int k = aw_axis(fmx, fmy, fmz);
      bool leaves;
      if (k == 0) {
        const int nx = fx + sx;
        leaves = (unsigned)nx >= (unsigned)BRICK;
        if (!leaves) { fx = nx; ft = fmx; fmx = fmx + dlx; }
      } else if (k == 1) {
        const int ny = fy + sy;
        leaves = (unsigned)ny >= (unsigned)BRICK;
        if (!leaves) { fy = ny; ft = fmy; fmy = fmy + dly; }
      } else {
        const int nz = fz + sz;
        leaves = (unsigned)nz >= (unsigned)BRICK;
        if (!leaves) { fz = nz; ft = fmz; fmz = fmz + dlz; }
      }
      if (!leaves) {
        axis = k;
        ++steps;
        continue;
      }
    }
    // one brick step: an empty brick, or a fine exit in the same iteration
    const int k = aw_axis(btx, bty, btz);
    bool oob;
    if (k == 0) {
      bcx += sx; bt = btx; btx = btx + dlx;
      oob = (unsigned)bcx >= (unsigned)a.bx;
    } else if (k == 1) {
      bcy += sy; bt = bty; bty = bty + dly;
      oob = (unsigned)bcy >= (unsigned)a.by;
    } else {
      bcz += sz; bt = btz; btz = btz + dlz;
      oob = (unsigned)bcz >= (unsigned)a.bz;
    }
    axis = k;
    ++steps;
    if (oob) {
      if (med_on) {           // the interior grid exit at the slab tmax
        mode = MODE_HIT;
        hit_t = tmax;
        hit_mat = 0;
      } else {
        mode = MODE_MISS;
      }
    } else {
      mode = MODE_BRICK;
    }
  }

  const bool hit = mode == MODE_HIT;
  a.t[i] = hit ? hit_t : BIG_F32;
  a.mat[i] = hit ? hit_mat : 0;
  // entry-voxel hits keep the slab entry axis (vv.cpp:159)
  a.axis[i] = hit_entry ? entry_axis : axis;
  a.steps[i] = steps;
  // a ray still walking, or stopped on the budget, is unresolved whether
  // or not the batch rule marks it
  a.resolved[i] = !(mode == MODE_BRICK || mode == MODE_FINE);
  if (a.pend != nullptr)
    a.pend[i] = (pending && med_on) ? c * 4 + aw_axis(btx, bty, btz) : -1;
  return c;
}

__global__ void __launch_bounds__(THREADS) dda_kernel(const ParentArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int c = i < a.n ? walk_ray(a, i) : 0;
  if (a.maxc != nullptr) {
    const int m = __reduce_max_sync(0xffffffffu, c);
    if ((threadIdx.x & 31) == 0 && m > 0) atomicMax(a.maxc, m);
  }
}

// The batch rule's marking: a medium ray that stopped on the budget after
// c transitions exits at the slab tmax with the ladder axis iff the loop
// ran past it (c < L).
__global__ void __launch_bounds__(THREADS) dda_exhaust_kernel(const ParentArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const int p = a.pend[i];
  if (p < 0) return;
  const int loop = min(*a.maxc, 2 * a.max_steps);
  if ((p >> 2) < loop) {
    a.t[i] = a.slab_tmax[i];
    a.mat[i] = 0;
    a.axis[i] = p & 3;
  }
}

}  // namespace parent

// One call: pass 1, and with a medium (pend and maxc set) the zeroed
// maximum and pass 2, all on ``stream``.
extern "C" int vt_dda_parent(const ParentArgs* args, cudaStream_t stream) {
  const ParentArgs a = *args;
  const int blocks = (a.n + parent::THREADS - 1) / parent::THREADS;
  if (a.maxc != nullptr) {
    const cudaError_t e = cudaMemsetAsync(a.maxc, 0, sizeof(int32_t), stream);
    if (e != cudaSuccess) return (int)e;
  }
  parent::dda_kernel<<<blocks, parent::THREADS, 0, stream>>>(a);
  if (a.maxc != nullptr) {
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    parent::dda_exhaust_kernel<<<blocks, parent::THREADS, 0, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

"""

# -- global_bitmap: the bitmap read from global memory through __ldg
SMEM_CHOICE = "const bool smem = !a.global_bits && a.nwords <= SMEM_BITMAP_MAX_WORDS;"
GLOBAL_BITMAP = [(SMEM_CHOICE, "const bool smem = false;")]
# -- nested_ahead: the fine loop chooses the next cell and requests its
# occupancy word before it tests the current one (B1/B2's fine walk)
NESTED_AHEAD = [
    ("      int bit = (fz * BRICK + fy) * BRICK + fx;\n",
     "      int bit = (fz * BRICK + fy) * BRICK + fx;\n"
     "      uint32_t word = __ldg(&w[bit >> 5]);\n"),
    ("        const bool solid = (__ldg(&w[bit >> 5]) >> (bit & 31)) & 1u;\n",
     "        const int nbit = (nz * BRICK + ny) * BRICK + nx;\n"
     "        const uint32_t nword = leaves ? 0u : __ldg(&w[nbit >> 5]);\n"
     "        const bool solid = (word >> (bit & 31)) & 1u;\n"),
    ("        bit = (nz * BRICK + ny) * BRICK + nx;\n",
     "        bit = nbit;\n        word = nword;\n")]
# -- one_loop: one loop over both levels, one transition of every active ray
# an iteration (the parent's and the JAX loop's shape)
LOOP_START = "  // A loop over bricks and, inside an occupied brick"
LOOP_END = "  const bool hit = mode == MODE_HIT;"
ONE_LOOP = r"""  int fx = 0, fy = 0, fz = 0;
  float fmx = 0.0f, fmy = 0.0f, fmz = 0.0f;
  float ft = 0.0f;            // t of the last fine step, voxel units
  // One loop over both levels, one transition an iteration, as the JAX
  // loop: the rays of a warp that walk a brick's voxels and those that
  // step over empty bricks each make one transition an iteration.
  while (mode == MODE_BRICK || mode == MODE_FINE) {
    if (steps >= max_steps) {   // out of budget: the batch rule decides
      pending = true;
      break;
    }
    if (c >= cap) break;
    ++c;
    if (mode == MODE_BRICK) {
      const int b = (bcz * a.by + bcy) * a.bx + bcx;
      if (brick_bit<SMEM>(a, bbase + b)) {
        // enter the occupied brick (vv.cpp:237-251): no step
        const float bet = fmaf(bt, rbpu, tmin);
        cell_setup(fmaf(-(float)bcx, rbpu, fmaf(dx, bet, ox)) * vpu, px, rx,
                   BRICK - 1, fx, fmx);
        cell_setup(fmaf(-(float)bcy, rbpu, fmaf(dy, bet, oy)) * vpu, py, ry,
                   BRICK - 1, fy, fmy);
        cell_setup(fmaf(-(float)bcz, rbpu, fmaf(dz, bet, oz)) * vpu, pz, rz,
                   BRICK - 1, fz, fmz);
        ft = 0.0f;
        mode = MODE_FINE;
        continue;
      }
      if (med_on) {           // an empty brick exits at its entry plane
        mode = MODE_HIT;
        hit_t = fmaf(bt, rbpu, tmin);
        hit_mat = 0;
        hit_entry = steps == 0;
        continue;
      }
      if (ign > 0) exited = true;   // an empty brick is air
    } else {
      // an air voxel is decided by its occupancy bit; a solid one reads its
      // id (the brick's index is recomputed: fewer registers live)
      const size_t b = (size_t)((bcz * a.by + bcy) * a.bx + bcx);
      const int bit = (fz * BRICK + fy) * BRICK + fx;
      const bool solid = (__ldg(&occw[b * 16 + (bit >> 5)]) >> (bit & 31)) & 1u;
      int voxel = 0;
      if (solid) {
        voxel = wide ? __ldg(&grid[((int64_t)(bcz * BRICK + fz) * a.gy +
                                    (bcy * BRICK + fy)) * a.gx + (bcx * BRICK + fx)])
                     : (int)__ldg(&matb[b * 512 + bit]);
      }
      bool hv;
      if (a.shadow) {
        hv = solid && (voxel > 16 ||
                       (float)hash_shadow(seed, bcx * BRICK + fx, bcy * BRICK + fy,
                                          bcz * BRICK + fz) *
                               2.3283064365386963e-10f > 0.85f);
      } else if (has_ignore) {
        hv = solid && (exited || voxel != ign);
      } else {
        hv = solid;
      }
      if (med_on) hv = voxel != med;   // the first voxel unlike the medium
      if (hv) {
        mode = MODE_HIT;
        hit_t = fmaf(bt, rbpu, tmin) + ft / vpu;   // the brick's entry t
        hit_mat = voxel;
        hit_entry = steps == 0;
        continue;
      }
      if (ign > 0 && !solid) exited = true;
      // one fine step; leaving the brick discards it for the brick step
      const int k = aw_axis(fmx, fmy, fmz);
      bool leaves;
      if (k == 0) {
        const int nx = fx + sx;
        leaves = (unsigned)nx >= (unsigned)BRICK;
        if (!leaves) { fx = nx; ft = fmx; fmx = fmx + dlx; }
      } else if (k == 1) {
        const int ny = fy + sy;
        leaves = (unsigned)ny >= (unsigned)BRICK;
        if (!leaves) { fy = ny; ft = fmy; fmy = fmy + dly; }
      } else {
        const int nz = fz + sz;
        leaves = (unsigned)nz >= (unsigned)BRICK;
        if (!leaves) { fz = nz; ft = fmz; fmz = fmz + dlz; }
      }
      if (!leaves) {
        axis = k;
        ++steps;
        continue;
      }
    }
    // one brick step: an empty brick, or a fine exit in the same iteration
    const int k = aw_axis(btx, bty, btz);
    bool oob;
    if (k == 0) {
      bcx += sx; bt = btx; btx = btx + dlx;
      oob = (unsigned)bcx >= (unsigned)a.bx;
    } else if (k == 1) {
      bcy += sy; bt = bty; bty = bty + dly;
      oob = (unsigned)bcy >= (unsigned)a.by;
    } else {
      bcz += sz; bt = btz; btz = btz + dlz;
      oob = (unsigned)bcz >= (unsigned)a.bz;
    }
    axis = k;
    ++steps;
    if (oob) {
      if (med_on) {           // the interior grid exit at the slab tmax
        mode = MODE_HIT;
        hit_t = tmax;
        hit_mat = 0;
      } else {
        mode = MODE_MISS;
      }
    } else {
      mode = MODE_BRICK;
    }
  }

"""


def _one_loop(src):
    i, j = src.index(LOOP_START), src.index(LOOP_END)
    return src[:i] + ONE_LOOP + src[j:]


# -- smem_flag: where the bitmap is read from as a run-time flag of one
# pass-1 kernel, tested at every brick, in place of a template argument
SMEM_FLAG = [
    ("template <bool SMEM>\n"
     "__device__ __forceinline__ bool brick_bit(const DdaArgs& a, int64_t g) {\n"
     "  const uint32_t w = SMEM ? sbits[g >> 5] : __ldg(&a.bits[g >> 5]);",
     "__device__ __forceinline__ bool brick_bit(const DdaArgs& a, bool smem, int64_t g) {\n"
     "  const uint32_t w = smem ? sbits[g >> 5] : __ldg(&a.bits[g >> 5]);"),
    ("template <bool SMEM, class Out>\n"
     "__device__ __forceinline__ int walk_ray(const DdaArgs& a, int i, const Ray& ray, "
     "Out& out) {",
     "template <class Out>\n"
     "__device__ __forceinline__ int walk_ray(const DdaArgs& a, bool smem, int i, "
     "const Ray& ray, Out& out) {"),
    ("brick_bit<SMEM>(a, bbase + b)", "brick_bit(a, smem, bbase + b)"),
    ("template <bool SMEM>\n"
     "__global__ void __launch_bounds__(THREADS) dda_kernel(const DdaArgs a) {\n"
     "  if (SMEM) {",
     "__global__ void __launch_bounds__(THREADS) dda_kernel(const DdaArgs a, bool smem) {\n"
     "  if (smem) {"),
    ("template <bool SMEM>\n"
     "__global__ void __launch_bounds__(THREADS) dda_kernel(const RaceArgs r) {\n"
     "  if (SMEM) {",
     "__global__ void __launch_bounds__(THREADS) dda_kernel(const RaceArgs r, bool smem) {\n"
     "  if (smem) {"),
    ("walk_ray<SMEM>(a, i, ", "walk_ray(a, smem, i, "),
    ("walk_ray<SMEM>(r.d, i, ", "walk_ray(r.d, smem, i, "),
    ("  if (smem)\n    dda_kernel<true><<<blocks, THREADS, (size_t)a.nwords * 4, stream>>>(a);\n"
     "  else\n    dda_kernel<false><<<blocks, THREADS, 0, stream>>>(a);",
     "  dda_kernel<<<blocks, THREADS, smem ? (size_t)a.nwords * 4 : 0, stream>>>(a, smem);"),
    ("  if (smem)\n    dda_kernel<true><<<blocks, THREADS, (size_t)a.nwords * 4, stream>>>(r);\n"
     "  else\n    dda_kernel<false><<<blocks, THREADS, 0, stream>>>(r);",
     "  dda_kernel<<<blocks, THREADS, smem ? (size_t)a.nwords * 4 : 0, stream>>>(r, smem);")]
# -- int32_materials: a solid voxel's id read from the int32 grid (the
# branch the kernel takes for ids outside [0, 255]); every trial input
# passes an int32 grid
INT32_MATERIALS = [("const bool wide = __ldg(a.wide) != 0;", "const bool wide = true;")]
THREADS = "constexpr int THREADS = 128;"
PASS1 = "__launch_bounds__(THREADS) dda_kernel("

VARIANTS = {
    "committed": [],
    "parent": [lambda s: s.replace(LAUNCHER, PARENT_SOURCE + "\n" + LAUNCHER)],
    "one_loop": [_one_loop],
    "nested_ahead": NESTED_AHEAD,
    "global_bitmap": GLOBAL_BITMAP,
    "smem_flag": SMEM_FLAG,
    "int32_materials": INT32_MATERIALS,
    "threads_64": [(THREADS, "constexpr int THREADS = 64;")],
    "threads_256": [(THREADS, "constexpr int THREADS = 256;")],
    "bounds_8": [(PASS1, "__launch_bounds__(THREADS, 8) dda_kernel(")],
}


def _sub(src, old, new):
    if old not in src:
        raise RuntimeError(f"the source does not hold {old!r}")
    return src.replace(old, new)


def variant_source(name):
    """The source of one variant: the committed `dda.cu` with the
    variant's changes; raises if a change no longer applies."""
    src = (_build.CSRC / "dda.cu").read_text()
    for patch in VARIANTS[name]:
        if callable(patch):
            for marker in (LAUNCHER, LOOP_START, LOOP_END):
                if marker not in src:
                    raise RuntimeError(f"the source does not hold {marker!r}")
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
        cu = OUT_DIR / f"dda_{name}.cu"
        cu.write_text(variant_source(name))
        so = OUT_DIR / f"libdda_{name}.so"
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
    """`ParentArgs` of PARENT_SOURCE, field for field."""

    _fields_ = [(name, _P) for name in (
        "orig", "dirs", "grid", "bocc", "vpu_ray", "oid", "medium", "ignore", "seed",
        "t", "slab_tmin", "slab_tmax", "step_sign", "mat", "axis", "steps",
        "entry_axis", "valid", "resolved", "pend", "maxc")] + [
        (name, _I) for name in ("n", "gx", "gy", "gz", "bx", "by", "bz", "vpu_stride",
                                "max_steps", "shadow")] + [("vpu", _F)]


def parent_call(lib, grid, brick_occ, origin_l, dir_l, vpu, oid=None,
                max_steps=dda.MAX_STEPS, medium=None, ignore=None, shadow_seed=None,
                shadow=False):
    """The parent's wrapper, on its kernels: the int32 grid and brick counts
    passed as they are."""
    dev = origin_l.device
    n = origin_l.shape[0]
    grid = grid.to(torch.int32).contiguous()
    brick_occ = brick_occ.to(torch.int32).contiguous()
    gz, gy, gx = grid.shape[-3:]
    bz, by, bx = brick_occ.shape[-3:]
    oid = d1._per_ray(oid, torch.int64, n, dev)
    medium = d1._per_ray(medium, torch.int32, n, dev)
    ignore = d1._per_ray(ignore, torch.int32, n, dev)
    seed = d1._per_ray(shadow_seed, torch.int64, n, dev) if shadow else None
    if isinstance(vpu, torch.Tensor):
        vpu_ray = vpu.to(dev, torch.float32).contiguous()
        vpu_stride, vpu_val = int(vpu_ray.ndim == 1), 0.0
    else:
        vpu_ray, vpu_stride, vpu_val = None, 0, float(vpu)

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    out = dict(t=empty(n), mat=empty(n, dtype=torch.int32), axis=empty(n, dtype=torch.int32),
               step_sign=empty(n, 3), steps=empty(n, dtype=torch.int32),
               valid=empty(n, dtype=torch.bool), entry_axis=empty(n, dtype=torch.int32),
               slab_tmin=empty(n), slab_tmax=empty(n), resolved=empty(n, dtype=torch.bool))
    pend = empty(n, dtype=torch.int32) if medium is not None else None
    maxc = empty(1, dtype=torch.int32) if medium is not None else None
    ptr = d1._ptr
    args = _ParentArgs(
        origin_l.data_ptr(), dir_l.data_ptr(), grid.data_ptr(), brick_occ.data_ptr(),
        ptr(vpu_ray), ptr(oid), ptr(medium), ptr(ignore), ptr(seed),
        *(out[k].data_ptr() for k in ("t", "slab_tmin", "slab_tmax", "step_sign", "mat",
                                      "axis", "steps", "entry_axis", "valid", "resolved")),
        ptr(pend), ptr(maxc), n, gx, gy, gz, bx, by, bz, vpu_stride, int(max_steps),
        int(bool(shadow)), vpu_val)
    lib.vt_dda_parent.argtypes = [ctypes.POINTER(_ParentArgs), _P]
    lib.vt_dda_parent.restype = _I
    with torch.cuda.device(dev):
        err = lib.vt_dda_parent(ctypes.byref(args), torch.cuda.current_stream(dev).cuda_stream)
    _build.raise_on(lib, err, "dda parent")
    return out


def parent_rays(args):
    """The rays on which the parent design is held to the plain DDA: those
    with a finite direction.  It clamps a NaN direction's delta to BIG
    where the plain DDA keeps NaN, so its walks of NaN rays (a missed
    pixel's shadow ray in the wavefront frame, masked out downstream)
    differ."""
    return torch.isfinite(args[3]).all(dim=1)


def call(name, lib, args, kw):
    """fn() tracing one list (the wrapper's arguments) with one variant's
    library."""
    if name == "parent":
        return lambda: parent_call(lib, *args, **kw)

    def fn():
        _build._LIBS["dda"] = lib
        return d1.intersect_volume_local(*args, **kw)
    return fn


def frame_calls(size=cs.DF_SIZE):
    """The D1 calls of [dda frames]'s two frames: {"exact whitted": [(args,
    kw), ...], "wavefront": [...]}, each call's rays and per-ray inputs
    copied as D1 received them."""
    from voxel_tracer_tpu_torch.ops.cuda import mega
    from voxel_tracer_tpu_torch.ops.cuda.whitted import MegaIntersector, render_whitted_mega
    from voxel_tracer_tpu_torch.renderer import RenderConfig, Renderer
    from voxel_tracer_tpu_torch.utils.profiling import glass_box_camera, glass_box_scene
    merged, scene = glass_box_scene(128)
    sd = scene.data("cuda")
    w, h = size
    real, calls = d1.intersect_volume_local, []

    def copy(x):
        return x.clone() if isinstance(x, torch.Tensor) else x

    def record(grid, bocc, o, d, vpu, **kw):
        calls.append(((grid, bocc, o.clone(), d.clone(), copy(vpu)),
                      {k: copy(v) for k, v in kw.items()}))
        return real(grid, bocc, o, d, vpu, **kw)

    out = {}
    ix = MegaIntersector(mega.MegaVolume(merged, "cuda"), shadow_rounds=cs.WH_SHADOW_ROUNDS,
                         compact=True, exact_fallback=True, dda_fn=record)
    render_whitted_mega(ix, sd, glass_box_camera(merged, cs.WH_THETA, w, h), w, h, 0,
                        config=cs.whitted_config(w, h))
    out["exact whitted"], calls = calls, []
    d1.intersect_volume_local = record
    try:
        Renderer(RenderConfig(width=w, height=h), device="cuda").render(
            sd, glass_box_camera(merged, cs.WH_THETA, w, h), frame=0)
    finally:
        d1.intersect_volume_local = real
    out["wavefront"] = calls
    torch.cuda.synchronize()
    return out


def dda_device_ms(fn, reps, launches=1):
    """Device ms of fn() from the profiler: the spans of D1's kernels (pass
    1 and 2, the parent's too) in one window of ``reps`` calls of fn(),
    which launches pass 1 ``launches`` times, a call.  The sum is divided
    by the pass-1 launches the window shows over ``launches``: a window
    late in a long process may miss some calls' events."""
    for _ in range(3):
        _wall, events = cs.device_window(lambda: [fn() for _ in range(reps)])
        spans = [b - a for n, a, b in events if "dda_kernel" in n or "dda_exhaust_kernel" in n]
        seen = sum(1 for n, _a, _b in events if "dda_kernel" in n) / launches
        if seen:
            return sum(spans) / seen / 1e3
    return None


def inputs(frames=True):
    """{name: [(args, kw), ...]}: each [dda] list as one call, each frame
    as its calls."""
    from voxel_tracer_tpu_torch.models.volume import VoxelVolume
    vol = VoxelVolume.noise_filled((64, 64, 64), pos=(0, 0, 0), vpu=20.0)
    o, d = cs.random_rays()
    out = {tag: [((grid, bocc, oo, dd, vpu), kw)]
           for tag, grid, bocc, oo, dd, vpu, kw in cs.dda_lists(vol, o, d)}
    if frames:
        out.update(frame_calls())
    return out


def runner(name, lib, calls):
    fns = [call(name, lib, args, kw) for args, kw in calls]
    return lambda: [fn() for fn in fns]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", help="comma-separated subset of the variants (default: all)")
    ap.add_argument("--no-frames", action="store_true", help="the [dda] lists only")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_dda_trials: no CUDA device available", file=sys.stderr)
        return 2
    smi = cs.nvidia_smi()
    cs.log(f"[device] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    names = args.variants.split(",") if args.variants else list(VARIANTS)
    libs = build_variants(names)
    for name, (lib, ptxas) in libs.items():
        for ln in ptxas:
            cs.log(f"[build] {name}: {ln}")
    committed = _build.load("dda")
    lists = inputs(frames=not args.no_frames)
    plain = {key: [dda.intersect_volume_local(*a, **kw) for a, kw in calls]
             for key, calls in lists.items()}
    for key, calls in lists.items():
        rays = sum(a[2].shape[0] for a, _ in calls)
        steps = sum(int(p["steps"].sum()) for p in plain[key])
        cs.log(f"[trials] {key}: {len(calls)} calls, {rays} rays, {steps} steps")
    for name, (lib, _) in libs.items():
        for key, calls in lists.items():
            outs = runner(name, lib, calls)()
            torch.cuda.synchronize()
            for (a, _kw), k, p in zip(calls, outs, plain[key]):
                cs.compare_dda(f"{name} {key}", k, p, quiet=True,
                               rays=parent_rays(a) if name == "parent" else None)
        cs.log(f"[trials] {name}: {', '.join(lists)} equal the plain DDA")

    order = list(libs)
    readings = {key: {v: [] for v in order} for key in lists}
    for turn, name in enumerate(order + order[::-1]):
        lib = libs[name][0]
        parts = []
        for key, calls in lists.items():
            fn = runner(name, lib, calls)
            fn()
            reps = 10 if len(calls) == 1 else 3
            ms = cs.cuda_ms(lambda i: fn(), reps)
            dev = dda_device_ms(fn, 3 if len(calls) == 1 else 2, len(calls))
            readings[key][name].append((ms, dev))
            parts.append(f"{key} {ms:.4f} ms (device "
                         f"{'n/a' if dev is None else f'{dev:.4f}'})")
        cs.log(f"[trials] turn {turn} {name}: " + ", ".join(parts))
    _build._LIBS["dda"] = committed
    for key, per in readings.items():
        for name, r in per.items():
            devs = [x[1] for x in r]
            cs.log(f"[trials] {key} {name}: mean {sum(x[0] for x in r) / len(r):.4f} ms, "
                   "device mean " + (f"{sum(devs) / len(devs):.4f} ms"
                                     if all(x is not None for x in devs) else "not measured"))
    summary = {"device": smi, "ptxas": {n: v[1] for n, v in libs.items()},
               "readings": readings}
    with open(OUT_DIR / "dda_trials.json", "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
