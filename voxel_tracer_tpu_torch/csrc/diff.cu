// Differentiable voxel-level emission/absorption march for Hopper
// (sm_90a): forward (D2) and its replay backward (D3), and the copy that
// packs the grids into their float4 records.
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
//   the entry cell clamped into the grid (a NaN entry to cell 0) and the
//   first crossing t of each axis (NaN -> BIG, clamped at BIG); delta is
//   |1 / dir| clamped at BIG (axis-parallel rays) before the scale by
//   1 / vpu, and stays NaN for a NaN direction component, as the plain
//   march's torch.clamp and JAX's jnp.minimum keep it;
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
// in batches to show it).  The exceptions are decided from the set-up,
// as the plain march decides them (ops/diff._nan_depth), whatever the
// batch:
//
// - a ray whose set-up puts t_exit or a first crossing at -inf (an
//   axis-parallel ray outside the slab on its parallel axis): its dead
//   steps make the depth NaN;
// - a ray with a NaN direction component: the scan's first step adds
//   onehot * delta to every axis, 0 * NaN on the axes not stepped, so the
//   second step's t is NaN; that step is not valid, the ray dies there,
//   and its depth is NaN.  Such a ray walks one step (its first segment,
//   if it enters) and no more.
//
// Both write NaN depth when max_steps >= 2.  A ray that misses the slab
// never steps: T = 1, C = 0, D = 0 (or that NaN), and reads no voxel.  A
// step that is not valid adds nothing (its voxel's record may have been
// requested ahead).
//
// D2 accumulates (T, C, D) as ops/diff.py:_render_fwd_only does, in its
// order.  D3 replays the march from the saved (C, T, D) and the
// cotangents (gC, gT, gD) as ops/diff.py:_render_bwd does: the prefix
// sums Cpre / Dpre, the suffixes C - Cpre and D - Dpre, d sigma of the
// step where sigma > 0 and 0 elsewhere (a select, as XLA simplifies JAX's
// multiply by relu: a NaN saved depth gives NaN only where sigma > 0),
// d albedo of the step.
//
// Rounding: compiled with --fmad=false and no fast math; fmaf exactly
// where the plain version calls dda._fma (the entry point and the first
// crossing t), IEEE division where it divides (size / vpu, 1 / dir),
// multiplication by the float32 reciprocal rvpu where it multiplies, and
// expf.  The forward equals the plain version up to expf's last bit; the
// backward's atomics sum in an order that changes from run to run, as
// the plain version's index_add_ does on the card.
//
// Bound: a dependent chain per step (the crossing compares, the current
// voxel's loads, expf, ~25 FP32 operations forward and ~50 backward) and
// the divergence of trip counts inside a warp; no step of one ray can
// start before the last one's t.  The design against both, in D2 and D3
// alike: one interleaved (sigma, r, g, b) float4 record a voxel (16 bytes
// at 16-byte alignment: one sector, where the plain grids take a load of
// sigma and three strided loads of albedo, two or three sectors for a
// ray whose neighbours walk elsewhere), read with one 16-byte load, and
// the next voxel's record requested before the current segment's
// arithmetic.  The record is packed once a training step
// (diff_pack_kernel, launched by ops/cuda/diff.py's forward, which saves
// it for the backward; torch.cat reaches a third of the memory rate, this
// copy most of it); D2 keeps a template on the plain (Z, Y, X) and
// (Z, Y, X, 3) grids (diff_fwd_kernel<false>, the next voxel's four
// values requested ahead alike) for forward-only calls with few rays on
// a large grid, where the pack costs more than it saves.  D3 also pays
// the reductions of every valid segment into the gradients, in L2: it
// adds a segment's four gradients with one float4 atomicAdd (sm_90: one
// RED.E.ADD.F32x4) into a zeroed (Z * Y * X, 4) gradient record, skipped
// where all four are 0, which the wrapper splits into the (Z, Y, X) and
// (Z, Y, X, 3) gradients (torch's two strided copies, at the memory rate
// as they are).
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
  const float4* rec;          // D2 (null: read the grids) and D3: (Z * Y * X,)
                              // (sigma, albedo r, g, b) records
  float4* grec;               // D3: zeroed (Z * Y * X,) (d sigma, d albedo r, g, b)
  int n;
  int gx, gy, gz;
  int max_steps;
  float vpu;                  // float32 vpu and its float32 reciprocal
  float rvpu;
};

namespace {

constexpr float BIG_F32 = 1e30f;   // miss depth and clamp (math3d.py BIG_F32)
constexpr int THREADS = 128;       // D2's blocks
constexpr int BWD_THREADS = 128;   // D3's blocks
constexpr int COPY_THREADS = 256;  // the pack's blocks

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

// The set-up of diff._march_setup for one ray: the slab test, the entry
// cell and the first crossing t of each axis, the steps and deltas; ok:
// whether the ray enters; nan_depth: whether its depth is NaN and steps:
// the steps it may take (below).
struct Setup {
  float tmin, tmax;
  bool ok, nan_depth;
  int steps;
  int sx, sy, sz;
  float dlx, dly, dlz;
  int cx, cy, cz;
  float tx, ty, tz;
};

__device__ __forceinline__ Setup march_setup(const DiffArgs& a, int i) {
  const float ox = __ldg(&a.orig[3 * i]), oy = __ldg(&a.orig[3 * i + 1]),
              oz = __ldg(&a.orig[3 * i + 2]);
  const float dx = __ldg(&a.dirs[3 * i]), dy = __ldg(&a.dirs[3 * i + 1]),
              dz = __ldg(&a.dirs[3 * i + 2]);
  const float vpu = a.vpu, rvpu = a.rvpu;
  Setup u;
  u.tmin = 0.0f;
  u.tmax = 0.0f;
  slab_axis(ox, dx, (float)a.gx / vpu, 0, u.tmin, u.tmax);
  slab_axis(oy, dy, (float)a.gy / vpu, 1, u.tmin, u.tmax);
  slab_axis(oz, dz, (float)a.gz / vpu, 2, u.tmin, u.tmax);
  u.ok = u.tmax - 1e-4f >= u.tmin;

  const bool px = !signbit(dx), py = !signbit(dy), pz = !signbit(dz);
  u.sx = px ? 1 : -1;
  u.sy = py ? 1 : -1;
  u.sz = pz ? 1 : -1;
  const float rx = 1.0f / dx, ry = 1.0f / dy, rz = 1.0f / dz;
  // clamp inf (axis-parallel rays) to BIG so 0 * delta stays 0, not NaN;
  // a NaN stays NaN (fminf would drop it)
  u.dlx = isnan(rx) ? rx : fminf(fabsf(rx), BIG_F32) * rvpu;
  u.dly = isnan(ry) ? ry : fminf(fabsf(ry), BIG_F32) * rvpu;
  u.dlz = isnan(rz) ? rz : fminf(fabsf(rz), BIG_F32) * rvpu;
  axis_setup(ox, dx, u.tmin, vpu, rvpu, a.gx - 1, px, rx, u.cx, u.tx);
  axis_setup(oy, dy, u.tmin, vpu, rvpu, a.gy - 1, py, ry, u.cy, u.ty);
  axis_setup(oz, dz, u.tmin, vpu, rvpu, a.gz - 1, pz, rz, u.cz, u.tz);
  // The scan steps a dead ray on.  Where the set-up leaves t_exit or a
  // first crossing at -inf, its first step ends at t = -inf, its next
  // step's segment depth t + dl / 2 is -inf or NaN, and w = 0 times it
  // leaves the depth NaN; such a ray has no valid segment.  Where a delta
  // is NaN, the first step leaves that axis's crossing NaN (onehot *
  // delta), the second step's t is NaN: not valid, the ray dies, and w = 0
  // times its depth is NaN.  Those are the outputs of dead steps that are
  // not "x + 0" (JAX's scan; ops/diff.py decides them from the same
  // predicate, `_nan_depth`); they are reproduced here.
  const bool nan_dir = isnan(u.dlx) || isnan(u.dly) || isnan(u.dlz);
  u.nan_depth = a.max_steps >= 2 && (nan_dir || neg_inf(u.tmax) || neg_inf(u.tx) ||
                                     neg_inf(u.ty) || neg_inf(u.tz));
  u.steps = nan_dir ? min(a.max_steps, 1) : a.max_steps;
  return u;
}

// One voxel's (sigma, albedo r, g, b): D2<true> and D3 read its record,
// D2<false> the plain grids.
template <bool REC>
__device__ __forceinline__ float4 voxel(const DiffArgs& a, int64_t idx) {
  if (REC) return __ldg(&a.rec[idx]);
  return make_float4(__ldg(&a.sigma[idx]), __ldg(&a.albedo[3 * idx]),
                     __ldg(&a.albedo[3 * idx + 1]), __ldg(&a.albedo[3 * idx + 2]));
}

// D2: marches ray i and writes (C, T, D).
template <bool REC>
__device__ __forceinline__ void march_ray(const DiffArgs& a, int i) {
  Setup u = march_setup(a, i);
  if (!u.ok) {                // a miss: T = 1, C = 0, D = 0 (or NaN)
    a.color[3 * i] = 0.0f;
    a.color[3 * i + 1] = 0.0f;
    a.color[3 * i + 2] = 0.0f;
    a.trans[i] = 1.0f;
    a.depth[i] = u.nan_depth ? NAN_F32 : 0.0f;
    return;
  }
  float T = 1.0f, Cr = 0.0f, Cg = 0.0f, Cb = 0.0f, D = 0.0f;
  float t = u.tmin;
  int cx = u.cx, cy = u.cy, cz = u.cz;
  float tx = u.tx, ty = u.ty, tz = u.tz;
  int64_t idx = ((int64_t)cz * a.gy + cy) * a.gx + cx;
  float4 v = voxel<REC>(a, idx);
  for (int s = 0; s < u.steps; ++s) {
    // diff._step: the first axis of least tmax3 (torch.argmin)
    int ax = 0;
    float m = tx;
    if (ty < m) { m = ty; ax = 1; }
    if (tz < m) { m = tz; ax = 2; }
    const float t_next = fminf(m, u.tmax);
    const float dl = fmaxf(t_next - t, 0.0f);
    // the next cell is known: request its voxel before this segment's
    // arithmetic (none past the grid's edge, where the march ends); only
    // the stepped axis can leave the grid
    int nx = cx, ny = cy, nz = cz;
    bool oob;
    if (ax == 0) {
      nx += u.sx;
      oob = (unsigned)nx >= (unsigned)a.gx;
    } else if (ax == 1) {
      ny += u.sy;
      oob = (unsigned)ny >= (unsigned)a.gy;
    } else {
      nz += u.sz;
      oob = (unsigned)nz >= (unsigned)a.gz;
    }
    const int64_t nidx = oob ? idx : ((int64_t)nz * a.gy + ny) * a.gx + nx;
    const float4 vn = oob ? v : voxel<REC>(a, nidx);
    if (dl > 0.0f) {          // a valid segment of the current cell
      const float sg = v.x, ar = v.y, ag = v.z, ab = v.w;
      const float e = expf(-fmaxf(sg, 0.0f) * dl);
      const float alpha = 1.0f - e;
      const float w = T * alpha;
      const float seg_d = t + 0.5f * dl;
      Cr = Cr + w * ar;
      Cg = Cg + w * ag;
      Cb = Cb + w * ab;
      D = D + w * seg_d;
      T = T * (1.0f - alpha);
    }
    if (ax == 0) tx = tx + u.dlx;
    else if (ax == 1) ty = ty + u.dly;
    else tz = tz + u.dlz;
    t = t_next;
    if (oob || !(t_next < u.tmax)) break;
    cx = nx; cy = ny; cz = nz;
    idx = nidx;
    v = vn;
  }
  a.color[3 * i] = Cr;
  a.color[3 * i + 1] = Cg;
  a.color[3 * i + 2] = Cb;
  a.trans[i] = T;
  a.depth[i] = u.nan_depth ? NAN_F32 : D;
}

// D3: replays the march of ray i from its saved outputs and adds its
// gradients, one float4 reduction a valid segment.  A ray that misses
// the slab has no valid segment and adds nothing.
__device__ __forceinline__ void replay_ray(const DiffArgs& a, int i) {
  Setup u = march_setup(a, i);
  if (!u.ok) return;
  const float Ctr = a.color[3 * i], Ctg = a.color[3 * i + 1], Ctb = a.color[3 * i + 2];
  const float Tf = a.trans[i], Dt = a.depth[i];
  const float gCr = __ldg(&a.g_color[3 * i]), gCg = __ldg(&a.g_color[3 * i + 1]),
              gCb = __ldg(&a.g_color[3 * i + 2]);
  const float gT = __ldg(&a.g_trans[i]), gD = __ldg(&a.g_depth[i]);
  float T = 1.0f, Cr = 0.0f, Cg = 0.0f, Cb = 0.0f, D = 0.0f;   // prefix sums
  float t = u.tmin;
  int cx = u.cx, cy = u.cy, cz = u.cz;
  float tx = u.tx, ty = u.ty, tz = u.tz;
  int64_t idx = ((int64_t)cz * a.gy + cy) * a.gx + cx;
  float4 r = __ldg(&a.rec[idx]);
  for (int s = 0; s < u.steps; ++s) {
    int ax = 0;
    float m = tx;
    if (ty < m) { m = ty; ax = 1; }
    if (tz < m) { m = tz; ax = 2; }
    const float t_next = fminf(m, u.tmax);
    const float dl = fmaxf(t_next - t, 0.0f);
    // the next cell is known: request its record before this segment's
    // arithmetic (none past the grid's edge, where the march ends)
    int nx = cx, ny = cy, nz = cz;
    bool oob;
    if (ax == 0) {
      nx += u.sx;
      oob = (unsigned)nx >= (unsigned)a.gx;
    } else if (ax == 1) {
      ny += u.sy;
      oob = (unsigned)ny >= (unsigned)a.gy;
    } else {
      nz += u.sz;
      oob = (unsigned)nz >= (unsigned)a.gz;
    }
    const int64_t nidx = oob ? idx : ((int64_t)nz * a.gy + ny) * a.gx + nx;
    const float4 rn = oob ? r : __ldg(&a.rec[nidx]);
    if (dl > 0.0f) {          // a valid segment of the current cell
      const float sg = r.x, ar = r.y, ag = r.z, ab = r.w;
      const float e = expf(-fmaxf(sg, 0.0f) * dl);
      const float alpha = 1.0f - e;
      const float w = T * alpha;
      const float seg_d = t + 0.5f * dl;
      Cr = Cr + w * ar;
      Cg = Cg + w * ag;
      Cb = Cb + w * ab;
      D = D + w * seg_d;
      const float te = T * e;
      const float s0 = gCr * te * ar - gCr * (Ctr - Cr);
      const float s1 = gCg * te * ag - gCg * (Ctg - Cg);
      const float s2 = gCb * te * ab - gCb * (Ctb - Cb);
      // sigma clamped at 0: 0 where sigma <= 0, even where the rest is NaN
      const float gsig = sg > 0.0f ?
          ((((s0 + s1) + s2) + gD * (te * seg_d - (Dt - D))) - gT * Tf) * dl : 0.0f;
      const float4 g = make_float4(gsig, gCr * w, gCg * w, gCb * w);
      if (g.x != 0.0f || g.y != 0.0f || g.z != 0.0f || g.w != 0.0f)
        atomicAdd(&a.grec[idx], g);   // result unused: one RED.E.ADD.F32x4
      T = T * (1.0f - alpha);
    }
    if (ax == 0) tx = tx + u.dlx;
    else if (ax == 1) ty = ty + u.dly;
    else tz = tz + u.dlz;
    t = t_next;
    if (oob || !(t_next < u.tmax)) break;
    cx = nx; cy = ny; cz = nz;
    idx = nidx;
    r = rn;
  }
}

template <bool REC>
__global__ void __launch_bounds__(THREADS) diff_fwd_kernel(const DiffArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < a.n) march_ray<REC>(a, i);
}

__global__ void __launch_bounds__(BWD_THREADS) diff_bwd_kernel(const DiffArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < a.n) replay_ray(a, i);
}

// The record of voxel v: (sigma[v], albedo[3v..3v+2]); one 16-byte store
// a thread, the loads of a warp covering 128 contiguous bytes of sigma
// and 384 of albedo.
__global__ void __launch_bounds__(COPY_THREADS) diff_pack_kernel(
    const float* __restrict__ sigma, const float* __restrict__ albedo,
    float4* __restrict__ rec, int64_t m) {
  const int64_t v = (int64_t)blockIdx.x * COPY_THREADS + threadIdx.x;
  if (v < m)
    rec[v] = make_float4(__ldg(&sigma[v]), __ldg(&albedo[3 * v]), __ldg(&albedo[3 * v + 1]),
                         __ldg(&albedo[3 * v + 2]));
}

}  // namespace

// D2: on the records when args->rec is set, else on the plain grids.
extern "C" int vt_diff_fwd(const DiffArgs* args, cudaStream_t stream) {
  const DiffArgs a = *args;
  const int blocks = (a.n + THREADS - 1) / THREADS;
  if (a.rec != nullptr)
    diff_fwd_kernel<true><<<blocks, THREADS, 0, stream>>>(a);
  else
    diff_fwd_kernel<false><<<blocks, THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int vt_diff_bwd(const DiffArgs* args, cudaStream_t stream) {
  const DiffArgs a = *args;
  diff_bwd_kernel<<<(a.n + BWD_THREADS - 1) / BWD_THREADS, BWD_THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// m voxels: (Z, Y, X) sigma and (Z, Y, X, 3) albedo into (m,) records.
extern "C" int vt_diff_pack(const float* sigma, const float* albedo, float4* rec, int64_t m,
                            cudaStream_t stream) {
  const int64_t blocks = (m + COPY_THREADS - 1) / COPY_THREADS;
  diff_pack_kernel<<<(unsigned)blocks, COPY_THREADS, 0, stream>>>(sigma, albedo, rec, m);
  return (int)cudaGetLastError();
}

extern "C" const char* vt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
