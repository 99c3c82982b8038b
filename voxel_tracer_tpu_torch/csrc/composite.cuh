// The per-ray float programs of the wavefront composite that two sources
// share: composite.cu (C1 and the prepass C2) and dda.cu (D1's candidate
// race).  Each source compiles them with --fmad=false and IEEE division
// and sqrt, so both give the same bits.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TOPK_MAX = 8;        // ops/cuda/composite.TOPK_MAX

// R^T v with each component's products summed left to right
// (math3d._mat3_t_apply); r is row-major 3x3.
__device__ __forceinline__ void mat3_t_apply(const float* r, float v0, float v1, float v2,
                                             float* out) {
#pragma unroll
  for (int k = 0; k < 3; ++k)
    out[k] = r[k] * v0 + r[3 + k] * v1 + r[6 + k] * v2;
}

// The ray at po / pd in the local space of object o of the group's tables:
// o_l = R^T (p - pos) + pivot, d_l = R^T d (composite._to_local).
__device__ __forceinline__ void to_local(const float* rot, const float* pos,
                                         const float* pivot, const float* po, const float* pd,
                                         int o, float* lo, float* ld) {
  const float* r = rot + 9 * o;
  const float* p = pos + 3 * o;
  const float* pv = pivot + 3 * o;
  float q[3];
  mat3_t_apply(r, po[0] - p[0], po[1] - p[1], po[2] - p[2], q);
  mat3_t_apply(r, pd[0], pd[1], pd[2], ld);
#pragma unroll
  for (int k = 0; k < 3; ++k) lo[k] = q[k] + pv[k];
}

// A hit's normal and albedo on object o: dda.normal_from_axis (s * the
// column ax of rot, s = -step_sign[ax], divided by the clamped length,
// whose squares are summed (a0 + a2) + a1, the order of torch.sum over a
// 3-vector on the card) and the clamped palette entry of material m.
__device__ __forceinline__ void normal_albedo(const float* rot, const float* palette, int o,
                                              int ax, float s, int m, float* nv, float* av) {
  const float* r = rot + 9 * o;
  const float n0 = s * r[ax], n1 = s * r[3 + ax], n2 = s * r[6 + ax];
  const float len = sqrtf((n0 * n0 + n2 * n2) + n1 * n1);
  const float den = isnan(len) ? len : fmaxf(len, 1e-20f);
  nv[0] = n0 / den;
  nv[1] = n1 / den;
  nv[2] = n2 / den;
  const float* alb = palette + 3 * (256 * o + min(max(m, 0), 255));
#pragma unroll
  for (int k = 0; k < 3; ++k) av[k] = alb[k];
}

}  // namespace
