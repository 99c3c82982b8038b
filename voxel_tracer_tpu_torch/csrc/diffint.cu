// Differentiable emission/absorption integration for Hopper (sm_90a):
// forward march (B6) and its tape-free replay backward (B7).
//
// Replaces the Pallas TPU kernel built by
// voxel_tracer_tpu/ops/pallas/diffint.py:_make_kernel at its two launch
// sites: integrate_fwd_tiles (mode="fwd", diffint.py:511) and
// integrate_bwd_tiles (mode="bwd", diffint.py:544).  It computes what that
// kernel computes -- the emission/absorption march over sigma and three
// albedo channels with exact per-voxel segment lengths, the carried march
// state (T, Cr, Cg, Cb, D), the dz-class filter, the empty-brick skip and
// the t_eps stop; and, replaying the same march from the entering carry
// and the saved totals, d sigma and d albedo -- but not with its block
// structure.  The TPU kernel scans rects of bricks per k-window for a whole
// (8, 128) ray tile, in four quadrant passes, because its vector unit has
// no per-lane loop.  Here one thread marches one ray: a brick-level
// Amanatides-Woo DDA visits the ray's bricks in t order, skips bricks whose
// occupancy bit is 0, and in an occupied brick runs the per-visit fine
// march of diffint.py:309-422 (at most fine_iters steps).  Every ray that
// enters the volume is integrated, so there are no k-fighters: flags bit 0
// is always 0, bit 1 marks a ray marched in this call.
//
// Bound: neither bytes nor FP32 rate.  A fine step reads its voxel and
// runs a dependent chain of ~29 FP32 operations (60 in the backward);
// at training shapes (131,072 rays on a 128^3 grid, ~27 M fine steps a
// call) both kernels run far above their byte and operation bounds.  The
// reads mostly hit L1 (neighbouring rays, 32x32-pixel tiles in order, sit
// in one warp and cross the same bricks); what remains is the instruction
// stream of the fine march and the lanes of a warp that wait for the one
// with the most fine steps in a brick.  The backward's gradient updates go
// to L2 as reductions: 33.5 MB of records and 33.5 MB of gradients at
// 128^3, more than the 50 MB L2 holds.  The design cuts the memory work
// of a fine step to one access each way:
// - one interleaved record table (sigma, albedo r, g, b) per voxel, read
//   with one 16-byte load, in place of four tables and four loads;
// - the next voxel's record requested before the current voxel's
//   arithmetic, so the load overlaps it;
// - one vector reduction (red.global.add.v4.f32) of the four gradient
//   components into one record table of gradients, in place of up to four
//   scalar atomics into four tables; skipped when all four are 0, so empty
//   voxels and the d sigma of sigma = 0 voxels stay exactly 0;
// - the brick occupancy bitmap in shared memory (512 B at 128^3).
// Warp-level aggregation of the reductions (__match_any_sync, shuffles,
// one reduction per voxel and warp) made the backward slower on every
// scene tried, even where most warp-steps share a voxel.  The forward runs
// faster in blocks of 128 threads, the backward in blocks of 256 (PERF.md
// holds the kernels' times).
//
// Rounding: compiled with --fmad=false and no fast math (expf, IEEE
// division); every float operation is the one the plain PyTorch version
// (ops/cuda/diffint.py: _march) performs, in the same order, so the forward
// equals it up to expf's last bit.  The backward's reductions sum in an
// order that changes from run to run.
//
// Launchers are extern "C", run on the caller's stream, allocate nothing,
// and return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float BIG = 3e37f;   // diffint.py:52
constexpr int BRICK = 8;
constexpr int BRICK_VOX = 512;
// threads a block: the faster of 128 and 256 at training shapes, each kernel
constexpr int FWD_THREADS = 128;
constexpr int BWD_THREADS = 256;
constexpr int SMEM_WORDS = 1024;   // bitmaps of up to 32768 bricks in shared memory

struct Params {
  const float* orig;       // (N, 3) local-space origins
  const float* dirs;       // (N, 3) directions
  int n;
  const float* carry[5];   // (N,) T, Cr, Cg, Cb, D entering this (sub)volume
  const float4* rec;       // (NB*512,) (sigma, albedo r, g, b): brick-major,
                           // in-brick index z*64 + y*8 + x
  const uint32_t* occw;    // brick b occupied iff bit b & 31 of word b >> 5
  int nwords;
  int nb[3];               // bricks (BX, BY, BZ)
  float vpu, rvpu, bpu, rbpu;
  float size[3];           // volume extent (world units)
  int quad;                // 0, or +-1: march only rays whose dz sign matches
  int fine_iters;
  float t_eps;
  // forward outputs
  float* out[5];           // (N,) Cr, Cg, Cb, T, D
  int32_t* flags;          // (N,) bit 1: marched
  // backward inputs and outputs
  const float* cts[5];     // (N,) cotangents of Cr, Cg, Cb, T, D
  const float* tot[5];     // (N,) full path's Cr, Cg, Cb, T_final, D_total
  float4* grad;            // (NB*512,) d sigma, d albedo r, g, b (zeroed)
};

__device__ __forceinline__ float clip_big(float v) {
  return fminf(fmaxf(v, -BIG), BIG);
}

template <bool BWD>
__global__ void __launch_bounds__(BWD ? BWD_THREADS : FWD_THREADS)
    integrate_kernel(const Params p) {
  __shared__ uint32_t sbits[SMEM_WORDS];
  const bool shared_bits = p.nwords <= SMEM_WORDS;
  if (shared_bits)
    for (int k = threadIdx.x; k < p.nwords; k += blockDim.x) sbits[k] = __ldg(&p.occw[k]);
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.n) return;
  const size_t r3 = 3 * (size_t)i;
  const float ox = __ldg(&p.orig[r3]), oy = __ldg(&p.orig[r3 + 1]),
              oz = __ldg(&p.orig[r3 + 2]);
  const float dx = __ldg(&p.dirs[r3]), dy = __ldg(&p.dirs[r3 + 1]),
              dz = __ldg(&p.dirs[r3 + 2]);
  float T = __ldg(&p.carry[0][i]), Cr = __ldg(&p.carry[1][i]),
        Cg = __ldg(&p.carry[2][i]), Cb = __ldg(&p.carry[3][i]),
        D = __ldg(&p.carry[4][i]);

  // ---- volume slab test (diffint.py:147-155) -----------------------------
  const float rdx = clip_big(1.0f / dx), rdy = clip_big(1.0f / dy),
              rdz = clip_big(1.0f / dz);
  float tmin = 0.0f, tmax = BIG;
  {
    float t1 = (0.0f - ox) * rdx, t2 = (p.size[0] - ox) * rdx;
    tmin = fmaxf(tmin, fminf(t1, t2));
    tmax = fminf(tmax, fmaxf(t1, t2));
    t1 = (0.0f - oy) * rdy; t2 = (p.size[1] - oy) * rdy;
    tmin = fmaxf(tmin, fminf(t1, t2));
    tmax = fminf(tmax, fmaxf(t1, t2));
    t1 = (0.0f - oz) * rdz; t2 = (p.size[2] - oz) * rdz;
    tmin = fmaxf(tmin, fminf(t1, t2));
    tmax = fminf(tmax, fmaxf(t1, t2));
  }
  bool marched = (tmax - 1e-6f) >= tmin;
  if (p.quad != 0) marched = marched && ((dz >= 0.0f) == (p.quad > 0));
  if (!BWD) p.flags[i] = marched ? 2 : 0;

  float gcr = 0.f, gcg = 0.f, gcb = 0.f, gt = 0.f, gd = 0.f;
  float ctr = 0.f, ctg = 0.f, ctb = 0.f, tfin = 0.f, dtot = 0.f;
  if (BWD) {
    gcr = __ldg(&p.cts[0][i]); gcg = __ldg(&p.cts[1][i]); gcb = __ldg(&p.cts[2][i]);
    gt = __ldg(&p.cts[3][i]); gd = __ldg(&p.cts[4][i]);
    ctr = __ldg(&p.tot[0][i]); ctg = __ldg(&p.tot[1][i]); ctb = __ldg(&p.tot[2][i]);
    tfin = __ldg(&p.tot[3][i]); dtot = __ldg(&p.tot[4][i]);
  }

  if (marched) {
    const int sx = signbit(dx) ? -1 : 1, sy = signbit(dy) ? -1 : 1,
              sz = signbit(dz) ? -1 : 1;
    const float stpx = sx > 0 ? 1.0f : 0.0f, stpy = sy > 0 ? 1.0f : 0.0f,
                stpz = sz > 0 ? 1.0f : 0.0f;
    const float dlx = fminf(fabsf(rdx), BIG) * p.rvpu,
                dly = fminf(fabsf(rdy), BIG) * p.rvpu,
                dlz = fminf(fabsf(rdz), BIG) * p.rvpu;
    // first brick: the one holding the slab entry point
    int cx = (int)fminf(fmaxf(floorf((ox + dx * tmin) * p.bpu), 0.0f), (float)(p.nb[0] - 1));
    int cy = (int)fminf(fmaxf(floorf((oy + dy * tmin) * p.bpu), 0.0f), (float)(p.nb[1] - 1));
    int cz = (int)fminf(fmaxf(floorf((oz + dz * tmin) * p.bpu), 0.0f), (float)(p.nb[2] - 1));
    const int max_bricks = p.nb[0] + p.nb[1] + p.nb[2] + 2;

    for (int it = 0; it < max_bricks; ++it) {
      if (!(T > p.t_eps)) break;
      // [tn, tf] = the ray within this brick's box and [tmin, tmax]
      const float bxf = (float)cx, byf = (float)cy, bzf = (float)cz;
      float ta = (bxf * p.rbpu - ox) * rdx, tb = ((bxf + 1.0f) * p.rbpu - ox) * rdx;
      const float nx = fminf(ta, tb), fx = fmaxf(ta, tb);
      ta = (byf * p.rbpu - oy) * rdy; tb = ((byf + 1.0f) * p.rbpu - oy) * rdy;
      const float ny = fminf(ta, tb), fy = fmaxf(ta, tb);
      ta = (bzf * p.rbpu - oz) * rdz; tb = ((bzf + 1.0f) * p.rbpu - oz) * rdz;
      const float nz = fminf(ta, tb), fz = fmaxf(ta, tb);
      const float tn = fmaxf(fmaxf(fmaxf(tmin, nx), ny), nz);
      const float tf = fminf(fminf(fminf(tmax, fx), fy), fz);
      const int b = (cz * p.nb[1] + cy) * p.nb[0] + cx;
      const uint32_t word = shared_bits ? sbits[b >> 5] : __ldg(&p.occw[b >> 5]);

      if (tf > tn && ((word >> (b & 31)) & 1u)) {
        // ---- fine march of one brick visit (diffint.py:309-422) ----------
        const float enter = fmaxf(tn, 0.0f);
        const float fex = ((ox + dx * enter) - bxf * p.rbpu) * p.vpu;
        const float fey = ((oy + dy * enter) - byf * p.rbpu) * p.vpu;
        const float fez = ((oz + dz * enter) - bzf * p.rbpu) * p.vpu;
        const float flx = fminf(fmaxf(floorf(fex), 0.0f), 7.0f);
        const float fly = fminf(fmaxf(floorf(fey), 0.0f), 7.0f);
        const float flz = fminf(fmaxf(floorf(fez), 0.0f), 7.0f);
        int vx = (int)flx, vy = (int)fly, vz = (int)flz;
        float tmx = fminf((((flx - fex) + stpx) * rdx) * p.rvpu + enter, BIG);
        float tmy = fminf((((fly - fey) + stpy) * rdy) * p.rvpu + enter, BIG);
        float tmz = fminf((((flz - fez) + stpz) * rdz) * p.rvpu + enter, BIG);
        float t = enter;
        const size_t base = (size_t)b * BRICK_VOX;
        bool live = true;
        // software pipelined: the step to the next voxel comes first, its
        // record is requested, then this voxel's arithmetic runs while the
        // load is in flight (the same float operations as before, in the
        // same order)
        size_t idx = base + (size_t)((vz * BRICK + vy) * BRICK + vx);
        float4 r = __ldg(&p.rec[idx]);
        for (int s = 0; s < p.fine_iters && live; ++s) {
          const float sg = r.x, ar = r.y, ag = r.z, ab = r.w;
          const float t_next = fminf(fminf(tmx, tmy), fminf(tmz, tf));
          // fine step, tie rule of diffint.py:404-408
          const bool use_x = (tmx < tmy) && (tmx < tmz);
          const bool use_y = !(tmx < tmy) && (tmy < tmz);
          if (use_x) { vx += sx; tmx = tmx + dlx; }
          else if (use_y) { vy += sy; tmy = tmy + dly; }
          else { vz += sz; tmz = tmz + dlz; }
          const bool inside = !(((vx | vy | vz) & ~7) != 0 || t_next >= tf);
          const size_t idx_next = base + (size_t)((vz * BRICK + vy) * BRICK + vx);
          float4 r_next = r;
          if (inside) r_next = __ldg(&p.rec[idx_next]);
          const float dl = fmaxf(t_next - t, 0.0f);
          const float e = expf(-fmaxf(sg, 0.0f) * dl);
          const float w = T * (1.0f - e);
          const float seg_d = t + 0.5f * dl;
          const float Cr2 = Cr + w * ar, Cg2 = Cg + w * ag, Cb2 = Cb + w * ab;
          const float D2 = D + w * seg_d;
          if (BWD) {
            // replayed prefix -> suffix sums from the totals (diffint.py:353-370)
            const float sufr = ctr - Cr2, sufg = ctg - Cg2, sufb = ctb - Cb2;
            const float sufd = dtot - D2;
            const float Te = T * e;
            float gsig = gcr * (Te * ar - sufr);
            gsig = gsig + gcg * (Te * ag - sufg);
            gsig = gsig + gcb * (Te * ab - sufb);
            gsig = gsig + gd * (Te * seg_d - sufd);
            gsig = (gsig - gt * tfin) * dl;
            const float4 g = make_float4(sg > 0.0f ? gsig : 0.0f, gcr * w, gcg * w, gcb * w);
            if (g.x != 0.0f || g.y != 0.0f || g.z != 0.0f || g.w != 0.0f)
              atomicAdd(&p.grad[idx], g);   // sm_90 float4 atomicAdd: one REDG.E.ADD.F32x4
          }
          Cr = Cr2; Cg = Cg2; Cb = Cb2; D = D2;
          T = T * e;
          live = inside && (T > p.t_eps);
          t = t_next;
          idx = idx_next;
          r = r_next;
        }
      }
      // ---- brick step on the axis of the nearest exit plane --------------
      const bool bx_ = (fx < fy) && (fx < fz);
      const bool by_ = !(fx < fy) && (fy < fz);
      const float f_ax = bx_ ? fx : (by_ ? fy : fz);
      if (!(f_ax < tmax)) break;
      if (bx_) { cx += sx; if (cx < 0 || cx >= p.nb[0]) break; }
      else if (by_) { cy += sy; if (cy < 0 || cy >= p.nb[1]) break; }
      else { cz += sz; if (cz < 0 || cz >= p.nb[2]) break; }
    }
  }
  if (!BWD) {
    p.out[0][i] = Cr; p.out[1][i] = Cg; p.out[2][i] = Cb;
    p.out[3][i] = T; p.out[4][i] = D;
  }
}

Params make_params(const float* orig, const float* dirs, int n,
                   const float* const* carry, const float* rec,
                   const uint32_t* occw, const int* nb, const float* geo,
                   int quad, int fine_iters, float t_eps) {
  Params p = {};
  p.orig = orig;
  p.dirs = dirs;
  p.n = n;
  for (int k = 0; k < 5; ++k) p.carry[k] = carry[k];
  p.rec = reinterpret_cast<const float4*>(rec);
  p.occw = occw;
  p.nwords = (nb[0] * nb[1] * nb[2] + 31) / 32;
  for (int a = 0; a < 3; ++a) p.nb[a] = nb[a];
  p.vpu = geo[0];
  p.rvpu = geo[1];
  p.bpu = geo[2];
  p.rbpu = geo[3];
  for (int a = 0; a < 3; ++a) p.size[a] = geo[4 + a];
  p.quad = quad;
  p.fine_iters = fine_iters;
  p.t_eps = t_eps;
  return p;
}

}  // namespace

// rec: (NB*512, 4) float32 records, 16-byte aligned.  geo: vpu, 1/vpu,
// vpu/8, 8/vpu, then the volume extent (x, y, z), each rounded to float32
// on the host exactly as the plain version uses them.
extern "C" int vt_integrate_fwd(const float* orig, const float* dirs, int n,
                                const float* const* carry, const float* rec,
                                const uint32_t* occw, const int* nb,
                                const float* geo, int quad, int fine_iters,
                                float t_eps, float* const* out,
                                int32_t* flags, cudaStream_t stream) {
  Params p = make_params(orig, dirs, n, carry, rec, occw, nb, geo, quad,
                         fine_iters, t_eps);
  for (int k = 0; k < 5; ++k) p.out[k] = out[k];
  p.flags = flags;
  integrate_kernel<false><<<(n + FWD_THREADS - 1) / FWD_THREADS, FWD_THREADS, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

// grad: (NB*512, 4) float32, zeroed, 16-byte aligned.
extern "C" int vt_integrate_bwd(const float* orig, const float* dirs, int n,
                                const float* const* carry, const float* rec,
                                const uint32_t* occw, const int* nb,
                                const float* geo, int quad, int fine_iters,
                                float t_eps, const float* const* cts,
                                const float* const* totals, float* grad,
                                cudaStream_t stream) {
  Params p = make_params(orig, dirs, n, carry, rec, occw, nb, geo, quad,
                         fine_iters, t_eps);
  for (int k = 0; k < 5; ++k) {
    p.cts[k] = cts[k];
    p.tot[k] = totals[k];
  }
  p.grad = reinterpret_cast<float4*>(grad);
  integrate_kernel<true><<<(n + BWD_THREADS - 1) / BWD_THREADS, BWD_THREADS, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

extern "C" const char* vt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
