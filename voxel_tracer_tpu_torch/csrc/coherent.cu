// Coherent-kernel first-hit tracer for Hopper (sm_90a) -- B5.
//
// Replaces the Pallas TPU kernel built by
// voxel_tracer_tpu/ops/pallas/coherent.py:_make_kernel, launched by
// trace_coherent (coherent.py:444).  It computes what that kernel computes
// -- slab entry, the first solid voxel of an 8^3-brick grid, its flat index,
// axis and sign, and the fine steps taken -- but not with its block
// structure: the TPU kernel marches a 1024-ray tile through brick slices
// along the tile's major axis and walks each slice's rect of bricks as
// scalars, because its vector unit has no cheap per-lane gather, and so
// leaves rays that fight the major axis or overflow the rect unresolved.
// Here one thread walks one ray's bricks in t order (the brick-level
// Amanatides-Woo walk of diffint.cu: each brick's [tn, tf] from its own
// planes, the step across the nearest exit plane) and applies the TPU
// kernel's per-brick arithmetic (coherent.py:241-356) to every occupied
// brick it crosses: brick-AABB slab test, tf - 1e-5 >= enter, fine entry
// clipped to [0, 7], first-cell axis, at most 24 fine steps.  The first
// hit ends the ray.  There are no fighting rays and no rect budget, so a
// ray is unresolved only if its walk ran out of steps without a hit or an
// exit, which a well-formed ray cannot do.  A ray that misses the volume's
// slab (the shadow ray of a missed pixel starts near 1e30) returns at once.
//
// Bound: per-ray dependent loads -- one occupancy flag per brick step, one
// 32-bit occupancy word per fine step, read through the read-only path and
// L2-resident (the 256^3 profiling grid's tables are 2.2 MB) -- and the
// divergence of loop trip counts inside a warp.  Neighbouring rays (128 to
// a block, in the caller's order: 32x32-pixel tiles for camera rays) cross
// the same bricks, so their loads share cache lines.  Speed is left to
// later work.
//
// Rounding: compiled with --fmad=false; fmaf at exactly the three places
// where XLA's CPU backend contracts the JAX kernel under jit (the entry
// point of the brick walk, the fine entry point, and t = enter + ft / vpu,
// which XLA turns into a multiply by 1/vpu and fuses); the plain PyTorch
// version (ops/cuda/coherent.py) does the same float32 operations in the
// same order, so t, vox, ax and steps are equal.
//
// Launchers are extern "C", run on the caller's stream, allocate nothing,
// and return cudaGetLastError().

#include "brick_walk.cuh"

namespace {

using walk::BIG;
using walk::Geo;

constexpr int BRICK = 8;
constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
coherent_kernel(const int32_t* __restrict__ occ, const uint32_t* __restrict__ words,
                const Geo g, const float* __restrict__ orig,
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
  float hit_t = BIG;
  int hit_vox = -1, hit_ax = entry_axis * 4, steps = 0;  // coherent.py:168
  bool finished = true;

  if (valid) {
    int sgn[3], c[3];
    float dl[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      sgn[a] = signbit(d[a]) ? -1 : 1;
      dl[a] = fminf(fabsf(rd[a]), BIG);
      // first brick: the one holding the slab entry point
      const float fb = floorf(fmaf(d[a], tmin, o[a]) * g.bpu);
      c[a] = (int)fminf(fmaxf(fb, 0.0f), (float)(g.nb[a] - 1));
    }
    const int max_bricks = g.nb[0] + g.nb[1] + g.nb[2] + 2;
    finished = false;
    for (int it = 0; it < max_bricks && !finished; ++it) {
      // ---- brick-AABB slab test (coherent.py:241-261) ---------------------
      float b0[3], hi[3];
      float tn = 0.0f, tf = BIG;
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
        const walk::Fine f = walk::fine_brick(words + (size_t)b * 16, o, d, rd, sgn,
                                              dl, b0, enter, ax0, g.vpu, steps,
                                              cell, ft, ax);
        if (f == walk::FINE_HIT) {
          hit_t = fmaf(ft, g.rvpu, enter);
          hit_vox = ((c[2] * BRICK + cell[2]) * (g.nb[1] * BRICK) +
                     (c[1] * BRICK + cell[1])) * (g.nb[0] * BRICK) +
                    (c[0] * BRICK + cell[0]);
          hit_ax = ax * 2 + (walk::pick3(sgn, ax) > 0 ? 1 : 0);
          finished = true;
          break;
        }
        if (f == walk::FINE_CAP) break;
      }
      // ---- brick step across the nearest exit plane -----------------------
      const int a = walk::aw_axis(hi);
      int moved = 0;
      if (a == 0) { c[0] += sgn[0]; moved = c[0]; }
      else if (a == 1) { c[1] += sgn[1]; moved = c[1]; }
      else { c[2] += sgn[2]; moved = c[2]; }
      finished = !(walk::pick3(hi, a) < tmax) || moved < 0 || moved >= g.nb[a];
    }
  }
  t_out[i] = hit_t;
  vox_out[i] = hit_vox;
  ax_out[i] = hit_ax;
  steps_out[i] = steps;
  res_out[i] = finished ? 1 : 0;
}

}  // namespace

// nb: bricks (BX, BY, BZ); geo: see walk::make_geo.
extern "C" int vt_coherent(const int32_t* occ, const uint32_t* words,
                           const int* nb, const float* geo, const float* orig,
                           const float* dirs, int n, float* t, int32_t* vox,
                           int32_t* ax, int32_t* steps, int32_t* resolved,
                           cudaStream_t stream) {
  const Geo g = walk::make_geo(nb, geo);
  coherent_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
      occ, words, g, orig, dirs, n, t, vox, ax, steps, resolved);
  return (int)cudaGetLastError();
}

extern "C" const char* vt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
