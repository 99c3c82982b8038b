// Device helpers shared by coherent.cu (B5) and indep.cu (B3, B4): the
// volume slab entry and the fine Amanatides-Woo pass through one 8^3
// brick, in the float32 program of the Pallas kernels they replace
// (coherent.py:116-133 and :265-356; indep.py:106-122 and :171-273, which
// do the same arithmetic).  Each thread calls them for its own ray.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace walk {

constexpr float BIG = 3e37f;     // miss depth and clamp of the TPU kernels
constexpr int FINE_ITERS = 24;   // fine steps per brick; any 8^3 crossing takes <= 22

// Float32 constants of a volume, each rounded once on the host.
struct Geo {
  float vpu, rvpu, bpu, rbpu;  // vpu, 1/vpu, vpu/8, 8/vpu
  float size[3];               // extent of the grid padded to whole bricks
  int nb[3];                   // bricks (BX, BY, BZ)
};

// geo: vpu, 1/vpu, vpu/8, 8/vpu, then the padded extent (x, y, z).
inline Geo make_geo(const int* nb, const float* geo) {
  Geo g;
  g.vpu = geo[0];
  g.rvpu = geo[1];
  g.bpu = geo[2];
  g.rbpu = geo[3];
  for (int a = 0; a < 3; ++a) {
    g.size[a] = geo[4 + a];
    g.nb[a] = nb[a];
  }
  return g;
}

template <typename T>
__device__ __forceinline__ T pick3(const T v[3], int a) {
  return a == 0 ? v[0] : (a == 1 ? v[1] : v[2]);
}

// Amanatides-Woo axis choice in the reference comparison order
// (vv.cpp:176-202).
__device__ __forceinline__ int aw_axis(const float t[3]) {
  const bool use_x = (t[0] < t[1]) && (t[0] < t[2]);
  const bool use_y = !(t[0] < t[1]) && (t[1] < t[2]);
  return use_x ? 0 : (use_y ? 1 : 2);
}

// [lo, hi] of one slab; jnp.minimum propagates a NaN, which the kernels
// then map to -BIG / +BIG (fminf would drop it).
__device__ __forceinline__ void slab(float t1, float t2, float& lo, float& hi) {
  const bool nan = isnan(t1) || isnan(t2);
  lo = nan ? -BIG : fminf(t1, t2);
  hi = nan ? BIG : fmaxf(t1, t2);
}

// Volume slab entry against [0, size]: rd = clip(1/d), tmin >= 0, the
// entry axis; returns whether the ray enters (tmax - 1e-4 >= tmin).
__device__ __forceinline__ bool volume_slab(const float o[3], const float d[3],
                                            const Geo& g, float rd[3],
                                            float& tmin, float& tmax,
                                            int& entry_axis) {
  tmin = 0.0f;
  tmax = BIG;
  entry_axis = 0;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    rd[a] = fminf(fmaxf(1.0f / d[a], -BIG), BIG);
    float tn, tf;
    slab((0.0f - o[a]) * rd[a], (g.size[a] - o[a]) * rd[a], tn, tf);
    if (tn > tmin) entry_axis = a;
    tmin = fmaxf(tmin, tn);
    tmax = fminf(tmax, tf);
  }
  return (tmax - 1e-4f) >= tmin;
}

enum Fine { FINE_EXIT = 0, FINE_HIT = 1, FINE_CAP = 2 };

// Fine DDA of one ray through the brick whose occupancy words are w,
// entered at t = enter (b0: the brick's low corner, ax: the first cell's
// axis).  Adds the cells tested to steps.  Returns FINE_HIT with the hit
// cell, its crossing ft (voxel units past enter) and its axis; FINE_EXIT
// when the ray leaves the brick; FINE_CAP if FINE_ITERS steps did not
// reach either (not reachable for a well-formed ray).
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
    // the fine entry point fuses o + d * enter, as XLA does (vv.cpp:237-251)
    const float fe = (fmaf(d[a], enter, o[a]) - b0[a]) * vpu;
    cell[a] = min(max((int)floorf(fe), 0), 7);
    float v = (((float)cell[a] - fe) + (sgn[a] > 0 ? 1.0f : 0.0f)) * rd[a];
    if (isnan(v)) v = BIG;
    tm[a] = fminf(v, BIG);
  }
  ft = 0.0f;
  for (int fi = 0; fi < FINE_ITERS; ++fi) {
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

}  // namespace walk
