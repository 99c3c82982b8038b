// Device helpers shared by coherent.cu (B5) and indep.cu (B3, B4): the
// volume slab entry, the Amanatides-Woo axis choice and the set-up of the
// fine walk through one 8^3 brick, in the float32 program of the Pallas
// kernels they replace (coherent.py:116-133 and :265-300; indep.py:106-122
// and :171-200, which do the same arithmetic).  Each thread calls them for
// its own ray.
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

// First cell of one axis of the fine walk and its crossing t, from the
// entry point e in voxel units of the brick (pos: the step sign is +1).
// The cell is clamped to [0, 7] in int, as the Pallas kernels clamp it.
__device__ __forceinline__ void fine_setup(float e, bool pos, float rdir, int& cell,
                                           float& tm) {
  cell = min(max((int)floorf(e), 0), 7);
  float v = (((float)cell - e) + (pos ? 1.0f : 0.0f)) * rdir;
  if (isnan(v)) v = BIG;
  tm = fminf(v, BIG);
}

}  // namespace walk
