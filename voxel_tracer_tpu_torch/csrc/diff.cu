// Differentiable voxel-level emission/absorption march for Hopper
// (sm_90a): forward (D2) and its replay backward (D3).
//
// Replaces the XLA program of voxel_tracer_tpu/ops/diff.py:render_density
// (a jax.custom_vjp over two lax.scans: the forward _render_fwd_only,
// diff.py:104 / scan :127, and the backward _render_bwd, :140 / scan
// :199), which the JAX package runs as one compiled device program each
// under its default trainer (parallel/sharding.make_train_step), the
// grid-sharded step and Trainer.render.  It is not a Pallas kernel; the
// port ran it as a host loop of lock-step eager tensor operations
// (ops/diff.py, the plain version).  Here one thread marches one ray
// through the same Amanatides-Woo visit sequence:
//
// - the set-up of diff._march_setup: the slab test of dda.slab_test
//   against [0, size / vpu] (NaN guard on 0 * inf, tmax - 1e-4 >= tmin),
//   the entry cell clamped into the grid and the first crossing t of each
//   axis (NaN -> BIG, clamped at BIG; axis-parallel rays' delta clamped
//   at BIG before the scale by 1 / vpu);
// - diff._step: the segment [t, min(min tmax3, t_exit)], valid while the
//   ray is alive and its length is > 0; the step on the first axis of
//   least tmax3 (torch.argmin: x before y before z on a tie); the ray dies
//   leaving the grid or reaching t_exit;
// - at most max_steps steps, no early stop on transmittance: a ray still
//   alive after them is truncated, as the scan truncates it.
//
// A thread stops when its ray dies.  The scan steps every ray max_steps
// times and the plain loop steps dead rays on until no ray of the batch
// is alive, but a dead ray's steps are not valid and add w = 0 times
// finite values, which leaves T, C, the prefix sums and the gradients
// unchanged (tests/test_torch_diff_route.py renders every ray alone and
// in batches to show it).  The exception is the depth of a ray whose
// set-up puts t_exit or a first crossing at -inf (an axis-parallel ray
// outside the slab on its parallel axis): its dead steps make
// the depth NaN, in JAX and in the plain loop whenever the loop runs on;
// the kernel writes NaN for it when max_steps >= 2.  A ray that misses
// the slab never steps: T = 1, C = 0, D = 0 (or that NaN), and reads no
// voxel.  A step that is not valid reads no voxel and adds nothing.
//
// D2 accumulates (T, C, D) as ops/diff.py:_render_fwd_only does, in its
// order.  D3 replays the march from the saved (C, T, D) and the
// cotangents (gC, gT, gD) as ops/diff.py:_render_bwd does: the prefix
// sums Cpre / Dpre, the suffixes C - Cpre and D - Dpre, relu = sigma > 0,
// d sigma and d albedo of the step, added into zeroed gradient grids with
// global atomic adds whose results are unused (RED), skipped where the
// value is 0.
//
// Rounding: compiled with --fmad=false and no fast math; fmaf exactly
// where the plain version calls dda._fma (the entry point and the first
// crossing t), IEEE division where it divides (size / vpu, 1 / dir),
// multiplication by the float32 reciprocal rvpu where it multiplies, and
// expf.  The forward equals the plain version up to expf's last bit; the
// backward's atomics sum in an order that changes from run to run, as
// the plain version's index_add_ does on the card.
//
// Bound: a dependent chain per step (the crossing compares, one sigma and
// three albedo loads of the current voxel, expf, ~25 FP32 operations
// forward and ~50 backward) and the divergence of trip counts inside a
// warp; no step of one ray can start before the last one's t.  The grids
// (16 bytes a voxel: 4 MB at 64^3, 33.5 MB at 128^3) are read through the
// read-only path and are mostly L2-resident; the backward's four scalar
// reductions a step go to L2 (dsigma and d albedo: another 16 bytes a
// voxel).  This first version keeps the plain (Z, Y, X) and (Z, Y, X, 3)
// layouts and scalar atomics; an interleaved (sigma, r, g, b) record and
// one red.global.add.v4.f32 a step, as B7 has, are the next step.
//
// Launchers are extern "C", run on the caller's stream, allocate nothing,
// and return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

// The launch arguments; ops/cuda/diff.py mirrors the layout (_Args).
// Outside the anonymous namespace, as the launchers take it.
struct DiffArgs {
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

namespace {

constexpr float BIG_F32 = 1e30f;   // miss depth and clamp (math3d.py BIG_F32)
constexpr int THREADS = 128;

__device__ __forceinline__ bool neg_inf(float v) { return isinf(v) && v < 0.0f; }
#define NAN_F32 __int_as_float(0x7fc00000)

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
__device__ __forceinline__ void march_ray(const DiffArgs& a, int i) {
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

__global__ void __launch_bounds__(THREADS) diff_fwd_kernel(const DiffArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < a.n) march_ray<false>(a, i);
}

__global__ void __launch_bounds__(THREADS) diff_bwd_kernel(const DiffArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < a.n) march_ray<true>(a, i);
}

}  // namespace

extern "C" int vt_diff_fwd(const DiffArgs* args, cudaStream_t stream) {
  const DiffArgs a = *args;
  diff_fwd_kernel<<<(a.n + THREADS - 1) / THREADS, THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int vt_diff_bwd(const DiffArgs* args, cudaStream_t stream) {
  const DiffArgs a = *args;
  diff_bwd_kernel<<<(a.n + THREADS - 1) / THREADS, THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* vt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
