// Device helpers shared by the camera kernels of mega.cu (B1) and indep.cu
// (B3): the raygen of the 29 camera floats, the aux word, and the shading
// tail (palette albedo, lambert N.L, analytic or constant sky, ACES, RGBA8)
// of voxel_tracer_tpu/ops/pallas/mega.py:568-596 and :2400-2440.
//
// cam: the 29 floats of mega.camera_params ([0:3] pos, [3:6] tl, [6:9] ddx,
// [9:12] ddy, [12:21] rot row-major, [21:24] sun dir, [25] sun scale,
// [26:29] constant sky), all in the volume's local frame.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace frame {

// aux word layout (mega.py:45-50): mat 8b | ax 3b | resolved 1b | steps 19b,
// ax = axis*2 + (step sign > 0)
constexpr int AUX_AX_SHIFT = 8;
constexpr int AUX_RESOLVED_SHIFT = 11;
constexpr int AUX_STEPS_SHIFT = 12;

enum Shading { SHADE_FLAT = 0, SHADE_LAMBERT = 1, SHADE_RAW = 2, SHADE_TRACE = 3 };
enum Sky { SKY_ANALYTIC = 0, SKY_CONSTANT = 1, SKY_NONE = 2 };

__device__ __forceinline__ int32_t pack_aux(int mat, int ax, int resolved, int steps) {
  return mat | (ax << AUX_AX_SHIFT) | (resolved << AUX_RESOLVED_SHIFT) |
         (min(steps, 0x7ffff) << AUX_STEPS_SHIFT);
}

// raygen (camera.h:32-37, mega.py:743-748): tl + px*ddx + py*ddy - pos,
// no half-pixel offset, normalised by 1/sqrt
__device__ __forceinline__ void camera_ray(const float* __restrict__ cam, int x,
                                           int y, float o[3], float d[3]) {
  const float px = (float)x, py = (float)y;
  float e[3];
  for (int a = 0; a < 3; ++a) {
    o[a] = __ldg(&cam[a]);
    e[a] = __ldg(&cam[3 + a]) + px * __ldg(&cam[6 + a]) + py * __ldg(&cam[9 + a]) - o[a];
  }
  const float rn = 1.0f / sqrtf(e[0] * e[0] + e[1] * e[1] + e[2] * e[2]);
  for (int a = 0; a < 3; ++a) d[a] = e[a] * rn;
}

// SkyDome.procedural at the exact direction (mega.py:568-588).
__device__ __forceinline__ void analytic_sky(const float dw[3],
                                             const float sun[3], float out[3]) {
  const float zen[3] = {0.35f, 0.45f, 0.65f};
  const float hor[3] = {0.85f, 0.65f, 0.45f};
  const float base[3] = {0.08f, 0.08f, 0.10f};
  const float suncol[3] = {1.0f, 0.9f, 0.75f};
  const float y = dw[1];
  const float cos_sun = dw[0] * sun[0] + dw[1] * sun[1] + dw[2] * sun[2];
  const float horizon = expf(-fabsf(y) * 3.0f);
  const float zenith = fminf(fmaxf(y, 0.0f), 1.0f);
  const float c2 = fminf(fmaxf(cos_sun, 0.0f), 1.0f);
  const float g2 = c2 * c2;
  const float g4 = g2 * g2;
  const float g8 = g4 * g4;
  const float g16 = g8 * g8;
  const float glow = g16 * g16;
  float disk = fminf(fmaxf((cos_sun - 0.9995f) * 2000.0f, 0.0f), 1.0f);
  disk = disk * disk;
  const float lum = 25.0f * disk + 0.6f * glow;
  for (int c = 0; c < 3; ++c) {
    const float val = zen[c] * zenith + hor[c] * horizon + base[c] + lum * suncol[c];
    out[c] = sqrtf(fmaxf(val, 0.0f)) * 0.65f;
  }
}

// tonemap.aces_approx (tonemap.h:22-30).
__device__ __forceinline__ float aces(float x) {
  const float v = x * 0.6f;
  const float r = (v * (2.51f * v + 0.03f)) / (v * (2.43f * v + 0.59f) + 0.14f);
  return fminf(fmaxf(r, 0.0f), 1.0f);
}

__device__ __forceinline__ int to8(float v) {
  return (int)fminf(fmaxf(v * 255.0f + 0.5f, 0.0f), 255.0f);
}

// RGBA8 of a traced camera ray (d: its local direction; mat, ax: the hit's
// material byte and aux axis); spal: the (256, 3) palette.
__device__ __forceinline__ int32_t shade_rgba(const float* __restrict__ cam,
                                              const float* spal, const float d[3],
                                              bool hit, int mat, int ax,
                                              int shading, int sky_mode,
                                              float ambient) {
  if (shading == SHADE_TRACE) return 0;
  float alb[3] = {spal[mat * 3 + 0], spal[mat * 3 + 1], spal[mat * 3 + 2]};
  if (shading == SHADE_LAMBERT) {
    // N = -step sign on the hit axis, rotated to world (mega.py:2408-2419)
    const int k = ax >> 1;
    const float sgn = (ax & 1) ? -1.0f : 1.0f;
    const float ndl = (__ldg(&cam[12 + k]) * __ldg(&cam[21]) +
                       __ldg(&cam[15 + k]) * __ldg(&cam[22]) +
                       __ldg(&cam[18 + k]) * __ldg(&cam[23])) * sgn;
    const float irr = fmaxf(ndl, 0.0f) * __ldg(&cam[25]) + ambient;
    for (int c = 0; c < 3; ++c) alb[c] = alb[c] * irr;
  }
  float sky[3] = {0.0f, 0.0f, 0.0f};
  if (sky_mode == SKY_ANALYTIC && !hit) {
    float dw[3];
    for (int r = 0; r < 3; ++r)   // world dir = R d (mega.py:2426-2431)
      dw[r] = __ldg(&cam[12 + 3 * r]) * d[0] + __ldg(&cam[13 + 3 * r]) * d[1] +
              __ldg(&cam[14 + 3 * r]) * d[2];
    const float sun[3] = {__ldg(&cam[21]), __ldg(&cam[22]), __ldg(&cam[23])};
    analytic_sky(dw, sun, sky);
  } else if (sky_mode == SKY_CONSTANT) {
    for (int c = 0; c < 3; ++c) sky[c] = __ldg(&cam[26 + c]);
  }
  int c8[3];
  for (int c = 0; c < 3; ++c) {
    const float val = hit ? alb[c] : sky[c];
    c8[c] = to8(shading == SHADE_RAW ? val : aces(val));
  }
  return c8[0] | (c8[1] << 8) | (c8[2] << 16) | (int32_t)0xFF000000;
}

}  // namespace frame
