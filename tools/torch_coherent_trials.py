#!/usr/bin/env python3
"""Design trials of the port's coherent kernel B5
(`voxel_tracer_tpu_torch/csrc/coherent.cu`) on one NVIDIA GPU: the
kernel's first port and its launcher (the parent of the redesign: a
40-byte stack frame, int32 brick flags, 128-thread blocks; five allocations, the
geometry as ctypes arrays, a device context and a conversion kernel a
call), the brick test on the int32 flags in place of the bitmap, the
bitmap staged in each block's shared memory, each level of the walk
requesting its next word ahead of the test (brick, fine, both), every
step committed with selects on all three axes with both requests ahead
(the design that the redesign started from), other block shapes, and
launch bounds in place of the limit of 64 registers.

Each variant is the committed source with textual changes, compiled with
the port's nvcc flags into `build/voxel_tracer_tpu_torch/trials/` and
called through the port's launcher (`trace_coherent`) with its library in
place of the port's; the first_port variant adds the first port's kernel
and launcher (`vt_coherent_first_port`) beside the committed ones, and is
called the way the first port's wrapper called it.  The inputs are `chip_smoke.py`'s B5 lists: the
512-crate frame's primary and shadow lists, 1 M random rays through the
crate field, the bench frame's primary and shadow lists (all at
1920x1088, in 32x32-pixel tiles) and the turned 64^3 volume's camera
rays of [api].

Every variant is held against the plain version on every input (every
field equal) before it is timed.  Variants are timed in turns (A B C ...
C B A), each turn with CUDA events at two call counts (their
differential) and profiler device time per launch.  Prints the ptxas
lines of each variant, one line per turn, the bound of each input
(`chip_smoke.coherent_bound`), and a JSON summary as the last line (also
written to `build/voxel_tracer_tpu_torch/trials/coherent_trials.json`).

Run from the repository root on a machine with a card:
    python3 tools/torch_coherent_trials.py [--variants a,b,...]
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
from voxel_tracer_tpu_torch.ops.cuda import _build, coherent  # noqa: E402
from voxel_tracer_tpu_torch.ops.cuda.diffint import _geometry  # noqa: E402

OUT_DIR = _build.BUILD_DIR / "trials"
NAMESPACE_END = "}  // namespace\n"

# -- first_port: the kernel's first port (one thread per ray, per-axis
# arrays indexed by the step's axis, int32 brick flags, each word loaded
# where it is tested) and its launcher, beside the committed ones
FIRST_PORT_SOURCE = r"""
namespace first_port {

constexpr int BRICK = 8;
constexpr int THREADS = 128;

template <typename T>
__device__ __forceinline__ T pick3(const T v[3], int a) {
  return a == 0 ? v[0] : (a == 1 ? v[1] : v[2]);
}

__device__ __forceinline__ int aw_axis(const float t[3]) {
  const bool use_x = (t[0] < t[1]) && (t[0] < t[2]);
  const bool use_y = !(t[0] < t[1]) && (t[1] < t[2]);
  return use_x ? 0 : (use_y ? 1 : 2);
}

enum Fine { FINE_EXIT = 0, FINE_HIT = 1, FINE_CAP = 2 };

__device__ __forceinline__ Fine fine_brick(const uint32_t* __restrict__ w,
                                           const float o[3], const float d[3],
                                           const float rd[3], const int sgn[3],
                                           const float dl[3], const float b0[3],
                                           float enter, int ax, float vpu,
                                           int& steps, int cell[3], float& ft,
                                           int& hit_ax) {
  float tm[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float fe = (fmaf(d[a], enter, o[a]) - b0[a]) * vpu;
    cell[a] = min(max((int)floorf(fe), 0), 7);
    float v = (((float)cell[a] - fe) + (sgn[a] > 0 ? 1.0f : 0.0f)) * rd[a];
    if (isnan(v)) v = walk::BIG;
    tm[a] = fminf(v, walk::BIG);
  }
  ft = 0.0f;
  for (int fi = 0; fi < walk::FINE_ITERS; ++fi) {
    const int bit = cell[2] * 64 + cell[1] * 8 + cell[0];
    ++steps;
    if ((__ldg(&w[bit >> 5]) >> (bit & 31)) & 1u) {
      hit_ax = ax;
      return FINE_HIT;
    }
    const int a = aw_axis(tm);
    int moved;
    if (a == 0) {
      cell[0] += sgn[0]; ft = tm[0]; tm[0] = tm[0] + dl[0]; moved = cell[0];
    } else if (a == 1) {
      cell[1] += sgn[1]; ft = tm[1]; tm[1] = tm[1] + dl[1]; moved = cell[1];
    } else {
      cell[2] += sgn[2]; ft = tm[2]; tm[2] = tm[2] + dl[2]; moved = cell[2];
    }
    ax = a;
    if (moved < 0 || moved > 7) return FINE_EXIT;
  }
  return FINE_CAP;
}

__global__ void __launch_bounds__(THREADS)
coherent_kernel(const int32_t* __restrict__ occ, const uint32_t* __restrict__ words,
                const walk::Geo g, const float* __restrict__ orig,
                const float* __restrict__ dirs, int n, float* __restrict__ t_out,
                int32_t* __restrict__ vox_out, int32_t* __restrict__ ax_out,
                int32_t* __restrict__ steps_out, int32_t* __restrict__ res_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t r3 = 3 * (size_t)i;
  const float o[3] = {__ldg(&orig[r3]), __ldg(&orig[r3 + 1]), __ldg(&orig[r3 + 2])};
  const float d[3] = {__ldg(&dirs[r3]), __ldg(&dirs[r3 + 1]), __ldg(&dirs[r3 + 2])};

  float rd[3], tmin, tmax;
  int entry_axis;
  const bool valid = walk::volume_slab(o, d, g, rd, tmin, tmax, entry_axis);
  float hit_t = walk::BIG;
  int hit_vox = -1, hit_ax = entry_axis * 4, steps = 0;
  bool finished = true;

  if (valid) {
    int sgn[3], c[3];
    float dl[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      sgn[a] = signbit(d[a]) ? -1 : 1;
      dl[a] = fminf(fabsf(rd[a]), walk::BIG);
      const float fb = floorf(fmaf(d[a], tmin, o[a]) * g.bpu);
      c[a] = (int)fminf(fmaxf(fb, 0.0f), (float)(g.nb[a] - 1));
    }
    const int max_bricks = g.nb[0] + g.nb[1] + g.nb[2] + 2;
    finished = false;
    for (int it = 0; it < max_bricks && !finished; ++it) {
      float b0[3], hi[3];
      float tn = 0.0f, tf = walk::BIG;
      int b_ax = 0;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        b0[a] = (float)c[a] * g.rbpu;
        float lo;
        walk::slab((b0[a] - o[a]) * rd[a], ((b0[a] + g.rbpu) - o[a]) * rd[a], lo, hi[a]);
        if (lo > tn) b_ax = a;
        tn = fmaxf(tn, lo);
        tf = fminf(tf, hi[a]);
      }
      const float enter = fmaxf(tn, tmin);
      const int b = (c[2] * g.nb[1] + c[1]) * g.nb[0] + c[0];
      if (__ldg(&occ[b]) > 0 && tf - 1e-5f >= enter) {
        int cell[3], ax;
        float ft;
        const int ax0 = (enter <= tmin + 1e-12f) ? entry_axis : b_ax;
        const Fine f = fine_brick(words + (size_t)b * 16, o, d, rd, sgn, dl, b0, enter,
                                  ax0, g.vpu, steps, cell, ft, ax);
        if (f == FINE_HIT) {
          hit_t = fmaf(ft, g.rvpu, enter);
          hit_vox = ((c[2] * BRICK + cell[2]) * (g.nb[1] * BRICK) +
                     (c[1] * BRICK + cell[1])) * (g.nb[0] * BRICK) +
                    (c[0] * BRICK + cell[0]);
          hit_ax = ax * 2 + (pick3(sgn, ax) > 0 ? 1 : 0);
          finished = true;
          break;
        }
        if (f == FINE_CAP) break;
      }
      const int a = aw_axis(hi);
      int moved = 0;
      if (a == 0) { c[0] += sgn[0]; moved = c[0]; }
      else if (a == 1) { c[1] += sgn[1]; moved = c[1]; }
      else { c[2] += sgn[2]; moved = c[2]; }
      finished = !(pick3(hi, a) < tmax) || moved < 0 || moved >= g.nb[a];
    }
  }
  t_out[i] = hit_t;
  vox_out[i] = hit_vox;
  ax_out[i] = hit_ax;
  steps_out[i] = steps;
  res_out[i] = finished ? 1 : 0;
}

}  // namespace first_port

extern "C" int vt_coherent_first_port(const int32_t* occ, const uint32_t* words,
                               const int* nb, const float* geo, const float* orig,
                               const float* dirs, int n, float* t, int32_t* vox,
                               int32_t* ax, int32_t* steps, int32_t* resolved,
                               cudaStream_t stream) {
  const walk::Geo g = walk::make_geo(nb, geo);
  first_port::coherent_kernel<<<(n + first_port::THREADS - 1) / first_port::THREADS, first_port::THREADS, 0, stream>>>(
      occ, words, g, orig, dirs, n, t, vox, ax, steps, resolved);
  return (int)cudaGetLastError();
}
"""

# -- ldg_flags: the brick test reads the int32 brick flags (128 KB on the
# 256^3 crate grid) in place of the bitmap (4 KB)
OCCUPIED = "  return (__ldg(&v.bits[b >> 5]) >> (b & 31)) & 1u;\n"
LDG_FLAGS = [(OCCUPIED, "  return __ldg(&v.occ[b]) > 0;\n")]

# -- smem_bitmap: each block stages the bitmap in shared memory with 16-byte
# loads (unless none of its rays enters the volume), and the walk reads it
# from there
SMEM_KERNEL = r"""// One thread per ray; the bitmap staged in shared memory.
__global__ void __launch_bounds__(THREADS)
coherent_kernel(Volume v, const float* __restrict__ orig, const float* __restrict__ dirs,
                int n, float* __restrict__ t_out, int32_t* __restrict__ vox_out,
                int32_t* __restrict__ ax_out, int32_t* __restrict__ steps_out,
                uint8_t* __restrict__ res_out) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  const bool live = i < n;
  float o[3] = {0.0f, 0.0f, 0.0f}, d[3] = {0.0f, 0.0f, 1.0f};
  if (live) {
    const size_t r3 = 3 * (size_t)i;
    o[0] = __ldg(&orig[r3]); o[1] = __ldg(&orig[r3 + 1]); o[2] = __ldg(&orig[r3 + 2]);
    d[0] = __ldg(&dirs[r3]); d[1] = __ldg(&dirs[r3 + 1]); d[2] = __ldg(&dirs[r3 + 2]);
  }
  float rd[3], tmin, tmax;
  int entry_axis;
  const bool valid = walk::volume_slab(o, d, v.g, rd, tmin, tmax, entry_axis) && live;
  if (__syncthreads_or(valid)) {
    const uint4* src = reinterpret_cast<const uint4*>(v.bits);
    for (int k = threadIdx.x; k < v.nwords / 4; k += THREADS)
      reinterpret_cast<uint4*>(sbits)[k] = __ldg(&src[k]);
    __syncthreads();
  }
  if (!live) return;
  Hit h = {BIG, -1, entry_axis * 4, 0, true};
  if (valid) h = coherent_ray(o, d, rd, tmin, tmax, entry_axis, v);
  t_out[i] = h.t;
  vox_out[i] = h.vox;
  ax_out[i] = h.ax;
  steps_out[i] = h.steps;
  res_out[i] = h.resolved ? 1 : 0;
}

"""
KERNEL_START = "// One thread per ray, (N, 3) float32"


def _smem_kernel(src):
    i = src.index(KERNEL_START)
    return src[:i] + SMEM_KERNEL + src[src.index(NAMESPACE_END, i):]


SMEM_BITMAP = [(OCCUPIED, "  return (sbits[b >> 5] >> (b & 31)) & 1u;\n"),
               ("// Whether brick b holds a solid voxel.\n",
                "extern __shared__ __align__(16) uint32_t sbits[];\n\n"
                "// Whether brick b holds a solid voxel.\n"),
               _smem_kernel,
               ("THREADS, 0, stream>>>", "THREADS, (size_t)p->nwords * 4, stream>>>")]

# -- brick_ahead: the brick walk requests the next brick's bitmap word
# before the current brick's test; fine_ahead: the fine walk requests the
# next cell's occupancy word before the current cell's test
BRICK_AHEAD = [
    ("""  int steps = 0;
  const int max_bricks = g.nb[0] + g.nb[1] + g.nb[2] + 2;
  for (int it = 0; it < max_bricks; ++it) {""", """  int steps = 0;
  const int max_bricks = g.nb[0] + g.nb[1] + g.nb[2] + 2;
  int b = (c[2] * g.nb[1] + c[1]) * g.nb[0] + c[0];
  uint32_t bword = __ldg(&v.bits[b >> 5]);
  for (int it = 0; it < max_bricks; ++it) {"""),
    ("""    const int b = (c[2] * g.nb[1] + c[1]) * g.nb[0] + c[0];
    if (brick_occupied(v, b) && tf - 1e-5f >= enter) {""",
     """    const int an = aw_axis(hi);
    const int nbi = an == 0 ? b + sgn[0] : (an == 1 ? b + sgn[1] * g.nb[0]
                                                  : b + sgn[2] * g.nb[0] * g.nb[1]);
    const uint32_t nbword =
        __ldg(&v.bits[min((unsigned)nbi >> 5, (unsigned)(v.nwords - 1))]);
    if (((bword >> (b & 31)) & 1u) && tf - 1e-5f >= enter) {"""),
    ("""    const int a = aw_axis(hi);
    int moved, size;""", """    const int a = an;
    int moved, size;"""),
    ("""      h.steps = steps;
      return h;
    }
  }""", """      h.steps = steps;
      return h;
    }
    b = nbi;
    bword = nbword;
  }""")]
FINE_AHEAD = [
    ("""      float ft = 0.0f;
      for (int fi = 1;; ++fi) {
        const int bit = cell[2] * 64 + cell[1] * 8 + cell[0];
        ++steps;
        if ((__ldg(&w[bit >> 5]) >> (bit & 31)) & 1u) {""", """      float ft = 0.0f;
      int bit = cell[2] * 64 + cell[1] * 8 + cell[0];
      uint32_t word = __ldg(&w[bit >> 5]);
      for (int fi = 1;; ++fi) {
        const int a = aw_axis(tm);
        const int nbit = bit + (a == 0 ? sgn[0] : (a == 1 ? 8 * sgn[1] : 64 * sgn[2]));
        const uint32_t nword = __ldg(&w[((unsigned)nbit >> 5) & 15u]);
        ++steps;
        if ((word >> (bit & 31)) & 1u) {"""),
    ("""        const int a = aw_axis(tm);
        int moved;""", """        int moved;"""),
    ("""          h.resolved = false;
          return h;
        }
      }""", """          h.resolved = false;
          return h;
        }
        bit = nbit;
        word = nword;
      }""")]

# -- select_ahead: each step of both walks committed with selects on all
# three axes, the fine walk keeping its cell and crossing t's in scalars,
# and both levels requesting their next word ahead of the test (the
# next brick chosen before the fine walk)
WALK_START = "// First hit of one ray that enters the volume"
SELECT_WALK = r"""// The bitmap word that holds brick b's bit.  Past the grid's edge the
// index is meaningless, but the load stays inside the bitmap and the walk
// ends before it tests that bit.
__device__ __forceinline__ uint32_t brick_word(const Volume& v, int b) {
  return __ldg(&v.bits[min((unsigned)b >> 5, (unsigned)(v.nwords - 1))]);
}

__device__ __forceinline__ bool brick_bit(uint32_t word, int b) {
  return (word >> (b & 31)) & 1u;
}

// First hit of one ray that enters the volume (valid slab: tmin, tmax,
// entry_axis, rd), coherent.py:168-356 for one lane.
__device__ __forceinline__ Hit coherent_ray(const float o[3], const float d[3],
                                            const float rd[3], float tmin, float tmax,
                                            int entry_axis, const Volume& v) {
  const Geo& g = v.g;
  Hit h = {BIG, -1, entry_axis * 4, 0, true};        // coherent.py:168
  const bool px = !signbit(d[0]), py = !signbit(d[1]), pz = !signbit(d[2]);
  const int sx = px ? 1 : -1, sy = py ? 1 : -1, sz = pz ? 1 : -1;
  const float dlx = fminf(fabsf(rd[0]), BIG), dly = fminf(fabsf(rd[1]), BIG),
              dlz = fminf(fabsf(rd[2]), BIG);
  const int nbx = g.nb[0], nby = g.nb[1], nbz = g.nb[2];
  // first brick: the one holding the slab entry point
  int cx = (int)fminf(fmaxf(floorf(fmaf(d[0], tmin, o[0]) * g.bpu), 0.0f), (float)(nbx - 1));
  int cy = (int)fminf(fmaxf(floorf(fmaf(d[1], tmin, o[1]) * g.bpu), 0.0f), (float)(nby - 1));
  int cz = (int)fminf(fmaxf(floorf(fmaf(d[2], tmin, o[2]) * g.bpu), 0.0f), (float)(nbz - 1));
  int b = (cz * nby + cy) * nbx + cx;
  uint32_t bword = brick_word(v, b);
  int steps = 0;
  const int max_bricks = nbx + nby + nbz + 2;
  for (int it = 0; it < max_bricks; ++it) {
    // ---- brick-AABB slab test (coherent.py:241-261) -----------------------
    const float b0x = (float)cx * g.rbpu, b0y = (float)cy * g.rbpu, b0z = (float)cz * g.rbpu;
    float lox, hix, loy, hiy, loz, hiz;
    walk::slab((b0x - o[0]) * rd[0], ((b0x + g.rbpu) - o[0]) * rd[0], lox, hix);
    walk::slab((b0y - o[1]) * rd[1], ((b0y + g.rbpu) - o[1]) * rd[1], loy, hiy);
    walk::slab((b0z - o[2]) * rd[2], ((b0z + g.rbpu) - o[2]) * rd[2], loz, hiz);
    float tn = fmaxf(0.0f, lox);
    int b_ax = 0;
    b_ax = loy > tn ? 1 : b_ax;
    tn = fmaxf(tn, loy);
    b_ax = loz > tn ? 2 : b_ax;
    tn = fmaxf(tn, loz);
    const float tf = fminf(fminf(fminf(BIG, hix), hiy), hiz);
    const float enter = fmaxf(tn, tmin);
    // ---- the brick after this one: the nearest exit plane's axis ----------
    // (reference comparison order); its bitmap word is requested before
    // this brick's test
    const bool ux = (hix < hiy) && (hix < hiz);
    const bool uy = !(hix < hiy) && (hiy < hiz);
    const bool uz = !ux && !uy;
    const int nx = ux ? cx + sx : cx, ny = uy ? cy + sy : cy, nz = uz ? cz + sz : cz;
    const float t_exit = ux ? hix : (uy ? hiy : hiz);
    const int nbi = (nz * nby + ny) * nbx + nx;
    const uint32_t nbword = brick_word(v, nbi);

    if (brick_bit(bword, b) && tf - 1e-5f >= enter) {
      // ---- fine walk of the occupied brick (coherent.py:265-356) ----------
      int fx, fy, fz;
      float fmx, fmy, fmz;
      // the fine entry point fuses o + d * enter, as XLA does (vv.cpp:237-251)
      fine_setup((fmaf(d[0], enter, o[0]) - b0x) * g.vpu, px, rd[0], fx, fmx);
      fine_setup((fmaf(d[1], enter, o[1]) - b0y) * g.vpu, py, rd[1], fy, fmy);
      fine_setup((fmaf(d[2], enter, o[2]) - b0z) * g.vpu, pz, rd[2], fz, fmz);
      int fax = (enter <= tmin + 1e-12f) ? entry_axis : b_ax;   // the entry cell's axis
      const uint32_t* __restrict__ w = v.words + (size_t)b * 16;
      float ft = 0.0f;
      int bit = (fz * 8 + fy) * 8 + fx;
      uint32_t word = __ldg(&w[bit >> 5]);
      for (int fi = 1;; ++fi) {
        // the next cell depends only on the crossing t's: choose it and
        // request its occupancy word before this cell's test (a word of
        // this brick even where the ray leaves it: no branch)
        const bool fux = (fmx < fmy) && (fmx < fmz);
        const bool fuy = !(fmx < fmy) && (fmy < fmz);
        const bool fuz = !fux && !fuy;
        const int mx = fux ? fx + sx : fx, my = fuy ? fy + sy : fy, mz = fuz ? fz + sz : fz;
        const bool out = ((unsigned)mx | (unsigned)my | (unsigned)mz) >= 8u;
        const int mbit = (mz * 8 + my) * 8 + mx;
        const uint32_t mword = __ldg(&w[((unsigned)mbit >> 5) & 15u]);
        ++steps;                                      // this cell's test
        if ((word >> (bit & 31)) & 1u) {
          const bool hpos = fax == 0 ? px : (fax == 1 ? py : pz);
          h.t = fmaf(ft, g.rvpu, enter);
          h.vox = ((cz * 8 + fz) * (nby * 8) + (cy * 8 + fy)) * (nbx * 8) + (cx * 8 + fx);
          h.ax = fax * 2 + (hpos ? 1 : 0);
          h.steps = steps;
          return h;
        }
        if (out) break;                               // on to the brick step
        ft = fux ? fmx : (fuy ? fmy : fmz);
        fmx = fux ? fmx + dlx : fmx;
        fmy = fuy ? fmy + dly : fmy;
        fmz = fuz ? fmz + dlz : fmz;
        fax = fux ? 0 : (fuy ? 1 : 2);
        fx = mx; fy = my; fz = mz; bit = mbit; word = mword;
        if (fi >= FINE_ITERS) {                       // fine cap: unresolved
          h.steps = steps;
          h.resolved = false;
          return h;
        }
      }
    }
    // ---- brick step across the nearest exit plane -------------------------
    const bool leaves = ((unsigned)nx >= (unsigned)nbx) | ((unsigned)ny >= (unsigned)nby) |
                        ((unsigned)nz >= (unsigned)nbz);
    if (!(t_exit < tmax) || leaves) {                 // left the volume: a miss
      h.steps = steps;
      return h;
    }
    cx = nx; cy = ny; cz = nz; b = nbi; bword = nbword;
  }
  h.steps = steps;   // the walk ran out of bricks: unresolved
  h.resolved = false;
  return h;
}


"""


def _select_walk(src):
    i = src.index(WALK_START)
    return src[:i] + SELECT_WALK + src[src.index(KERNEL_START, i):]


THREADS = "constexpr int THREADS = 128;"
# -- bounds_threads_only, bounds_8: launch bounds in place of the limit of
# 64 registers (the thread count alone; eight blocks an SM)
MAXNREG = "__maxnreg__(MAX_REGS)"

VARIANTS = {
    "committed": [],
    "first_port": [lambda s: s + FIRST_PORT_SOURCE],
    "ldg_flags": LDG_FLAGS,
    "smem_bitmap": SMEM_BITMAP,
    "brick_ahead": BRICK_AHEAD,
    "fine_ahead": FINE_AHEAD,
    "both_ahead": BRICK_AHEAD + FINE_AHEAD,
    "select_ahead": [_select_walk],
    "threads_64": [(THREADS, "constexpr int THREADS = 64;")],
    "threads_256": [(THREADS, "constexpr int THREADS = 256;")],
    "bounds_threads_only": [(MAXNREG, "__launch_bounds__(THREADS)")],
    "bounds_8": [(MAXNREG, "__launch_bounds__(THREADS, 8)")],
}


def _sub(src, old, new):
    if old not in src:
        raise RuntimeError(f"the source does not hold {old!r}")
    return src.replace(old, new)


def variant_source(name):
    """The source of one variant: the committed `coherent.cu` with the
    variant's changes; raises if a change no longer applies."""
    src = (_build.CSRC / "coherent.cu").read_text()
    for patch in VARIANTS[name]:
        src = patch(src) if callable(patch) else _sub(src, *patch)
    return src


def build_variants(names):
    """Compile the named variants, one nvcc process each, all started
    together; returns {name: (CDLL, ptxas lines)}."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        cu = OUT_DIR / f"coherent_{name}.cu"
        cu.write_text(variant_source(name))
        so = OUT_DIR / f"libcoherent_{name}.so"
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


def first_port_trace(lib, pk, o_l, d_l):
    """The first port's wrapper of ops/cuda/coherent.py, on its kernel: four
    checks, the geometry as ctypes arrays, the device context, five
    allocations and a conversion of `resolved` to bool."""
    dev = _build.device_of(o_l)
    n = o_l.shape[0]
    nb = pk.bsize[0] * pk.bsize[1] * pk.bsize[2]
    _build.check("o_l", o_l, torch.float32, (n, 3), dev)
    _build.check("d_l", d_l, torch.float32, (n, 3), dev)
    _build.check("occ", pk.occ, torch.int32, (nb,), dev)
    _build.check("words", pk.words, torch.int32, (nb, 16), dev)
    g = _geometry(pk.bsize, pk.vpu)
    geo = (ctypes.c_float * 7)(g["vpu"], g["rvpu"], g["bpu"], g["rbpu"], *g["size"])
    t = torch.empty((n,), dtype=torch.float32, device=dev)
    vox, ax, steps, res = (torch.empty((n,), dtype=torch.int32, device=dev)
                           for _ in range(4))
    with torch.cuda.device(dev):
        err = lib.vt_coherent_first_port(
            pk.occ.data_ptr(), pk.words.data_ptr(), (ctypes.c_int * 3)(*pk.bsize), geo,
            o_l.data_ptr(), d_l.data_ptr(), n, t.data_ptr(), vox.data_ptr(),
            ax.data_ptr(), steps.data_ptr(), res.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.raise_on(lib, err, "coherent first port")
    return dict(t=t, vox=vox, ax=ax, steps=steps, resolved=res.bool())


def call(name, lib, pk, o, d):
    """fn() tracing one list with one variant's library."""
    if name == "first_port":
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.vt_coherent_first_port.argtypes = [p, p, ctypes.POINTER(ctypes.c_int),
                                        ctypes.POINTER(ctypes.c_float), p, p, i,
                                        p, p, p, p, p, p]
        lib.vt_coherent_first_port.restype = i
        return lambda: first_port_trace(lib, pk, o, d)

    def fn():
        _build._LIBS["coherent"] = lib
        return coherent.trace_coherent(pk.occ, pk.words, o, d, pk.bsize, pk.vpu)
    return fn


def inputs():
    """chip_smoke.py's B5 lists: {name: (PackedVolume, o, d)}."""
    from voxel_tracer_tpu_torch.ops.cuda import renderer_fast
    lists = {}
    for tag, (scene, cam) in (("crate", cs.crate_scene()), ("bench", cs.bench_fast_scene())):
        lit = renderer_fast.render_lambert_fast(scene, cam, cs.W, cs.H)
        pk = scene.volumes[0].packed
        for k, (o, d) in cs.frame_rays(scene, cam, lit).items():
            lists[f"{tag} {k}"] = (pk, o, d)
        if tag == "crate":
            lists["random"] = (pk, *cs.crate_random_rays())
    fv, _, _, (o, d) = cs.turned_volume()
    lists["turned volume"] = (fv.packed, o.contiguous(), d.contiguous())
    return lists


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", help="comma-separated subset of the variants (default: all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_coherent_trials: no CUDA device available", file=sys.stderr)
        return 2
    smi = cs.nvidia_smi()
    cs.log(f"[device] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    libs = build_variants(args.variants.split(",") if args.variants else list(VARIANTS))
    for name, (lib, ptxas) in libs.items():
        for ln in ptxas:
            cs.log(f"[build] {name}: {ln}")
    committed = _build.load("coherent")
    lists = inputs()
    bounds, plain = {}, {}
    for key, (pk, o, d) in lists.items():
        stats = {}
        plain[key] = coherent.trace_coherent_plain(pk.occ, pk.words, o, d, pk.bsize, pk.vpu,
                                                   stats=stats)
        n = o.shape[0]
        bounds[key] = cs.coherent_bound(n, pk, stats)
        cs.log(f"[trials] {key}: {n} rays, work {stats}, bound {bounds[key][0]:.4f} ms "
               f"({bounds[key][1]})")
    for name, (lib, _) in libs.items():
        for key, (pk, o, d) in lists.items():
            k, p = call(name, lib, pk, o, d)(), plain[key]
            torch.cuda.synchronize()
            cs.require(all(torch.equal(k[f], p[f]) for f in p),
                       f"variant {name} differs from the plain version on {key}")
        cs.log(f"[trials] {name}: {', '.join(lists)} equal the plain version")

    order = list(libs)
    readings = {key: {v: [] for v in order} for key in lists}
    for turn, name in enumerate(order + order[::-1]):
        lib = libs[name][0]
        parts = []
        for key, (pk, o, d) in lists.items():
            fn = call(name, lib, pk, o, d)
            fn()
            counts = (10, 40)
            ms = [cs.cuda_ms(lambda i: fn(), c) for c in counts]
            diff = (ms[1] * counts[1] - ms[0] * counts[0]) / (counts[1] - counts[0])
            dev = cs.kernel_device_ms(fn, counts[0], "coherent")
            readings[key][name].append((ms[1], diff, dev))
            parts.append(f"{key} {ms[1]:.4f} ms (differential {diff:.4f}, device "
                         f"{'n/a' if dev is None else f'{dev:.4f}'})")
        cs.log(f"[trials] turn {turn} {name}: " + ", ".join(parts))
    _build._LIBS["coherent"] = committed
    for key, per in readings.items():
        for name, r in per.items():
            devs = [x[2] for x in r]
            cs.log(f"[trials] {key} {name}: mean {sum(x[0] for x in r) / len(r):.4f} ms, "
                   f"differential {sum(x[1] for x in r) / len(r):.4f} ms, device mean "
                   + (f"{sum(devs) / len(devs):.4f} ms" if all(x is not None for x in devs)
                      else "not measured") + f", bound {bounds[key][0]:.4f} ms")
    summary = {"device": smi, "ptxas": {n: v[1] for n, v in libs.items()},
               "bounds": bounds, "readings": readings}
    with open(OUT_DIR / "coherent_trials.json", "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
