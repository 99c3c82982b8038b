// Independent two-level DDA frame and ray-list tracer for Hopper (sm_90a)
// -- B3 and B4.
//
// Replaces the Pallas TPU kernel built by
// voxel_tracer_tpu/ops/pallas/indep.py:_make_indep_kernel at its two launch
// sites: render_indep_tiles (camera rays, indep.py:468) and
// trace_rays_indep (local-space ray lists, indep.py:523).  It computes what
// that kernel computes -- raygen, slab entry, a brick-level Amanatides-Woo
// DDA in brick units over the brick bitmap, the fine DDA of each occupied
// brick, the material byte, and the shading tail of B1 -- but not with its
// block structure: the TPU kernel marches each lane's brick DDA over a
// broadcast 128-word bitmap and resolves occupied bricks and materials in
// min-vote rounds over the 1024-lane tile, because its vector unit cannot
// gather per lane from a brick's words; a tile that meets more bricks than
// it has vote rounds leaves rays unresolved.  Here one thread walks one ray
// (indep.py:140-169, :302-328) and runs the fine pass of indep.py:171-273
// on each occupied brick it visits; there are no rounds to overflow, so a
// ray is unresolved only if its walk ran out of steps without a hit or an
// exit, which a well-formed ray cannot do.  The float program is indep's,
// not B1's: enter = tmin + bft / bpu, t = enter + h_ft / vpu, steps = brick
// steps + fine steps.
//
// Bound: per-ray dependent loads (one bitmap word per brick step from
// shared memory, where each block keeps the 512-byte bitmap; one
// occupancy word per fine step and one material byte per hit through the
// read-only path, L2-resident for the <= 4096-brick volumes this kernel
// takes) and the divergence of loop trip counts inside a warp.
// Neighbouring rays (16x16-pixel blocks for camera rays) cross the same
// bricks.  Speed is left to later work.
//
// Rounding: compiled with --fmad=false; fmaf where XLA's CPU backend
// contracts the JAX kernel under jit (the brick walk's entry point, enter,
// the fine entry point, t); the plain PyTorch version (ops/cuda/indep.py)
// does the same float32 operations in the same order.
//
// Launchers are extern "C", run on the caller's stream, allocate nothing,
// and return cudaGetLastError().

#include "brick_walk.cuh"
#include "frame.cuh"

namespace {

using walk::BIG;
using walk::Geo;

constexpr int BITMAP_WORDS = 128;   // <= 4096 bricks (indep.py:53)
constexpr int RAY_THREADS = 256;

struct Volume {
  const int32_t* occb;    // (128,) brick bitmap: bit b & 31 of word b >> 5
  const uint32_t* occw;   // (NB, 16) occupancy bits, bit = z*64 + y*8 + x
  const uint8_t* matb;    // (NB, 512) material bytes, same index
  Geo g;
};

struct Hit {
  float t;   // BIG on a miss
  int mat;   // 0 on a miss
  int ax;    // axis*2 + (step sign > 0); entry axis*2 on a miss
  int steps;
  int resolved;
};

__device__ __forceinline__ void load_bitmap(uint32_t* sbits, const int32_t* occb,
                                            int tid, int nthreads) {
  for (int k = tid; k < BITMAP_WORDS; k += nthreads)
    sbits[k] = (uint32_t)__ldg(&occb[k]);
}

__device__ Hit indep_ray(const float o[3], const float d[3],
                         const uint32_t* sbits, const Volume& v) {
  const Geo& g = v.g;
  float rd[3], tmin, tmax;
  int entry_axis;
  const bool valid = walk::volume_slab(o, d, g, rd, tmin, tmax, entry_axis);
  Hit h = {BIG, 0, entry_axis * 2, 0, 1};
  if (!valid) return h;

  int sgn[3], cb[3];
  float dl[3], bt[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    sgn[a] = signbit(d[a]) ? -1 : 1;
    dl[a] = fminf(fabsf(rd[a]), BIG);
    // brick-level DDA init at the entry point, in brick units
    const float fb = fmaf(d[a], tmin, o[a]) * g.bpu;
    cb[a] = (int)fminf(fmaxf(floorf(fb), 0.0f), (float)(g.nb[a] - 1));
    float t0 = (((float)cb[a] - fb) + (sgn[a] > 0 ? 1.0f : 0.0f)) * rd[a];
    if (isnan(t0)) t0 = BIG;
    bt[a] = fminf(t0, BIG);
  }
  float bft = 0.0f;       // brick-unit time of the current brick's entry
  int bax = entry_axis;   // axis of that entry step
  const int max_outer = g.nb[0] + g.nb[1] + g.nb[2] + 2;
  for (int it = 0; it < max_outer; ++it) {
    const int b = (cb[2] * g.nb[1] + cb[1]) * g.nb[0] + cb[0];
    if ((sbits[b >> 5] >> (b & 31)) & 1u) {
      const float enter = fmaf(bft, g.rbpu, tmin);
      const float b0[3] = {(float)cb[0] * g.rbpu, (float)cb[1] * g.rbpu,
                           (float)cb[2] * g.rbpu};
      const int ax0 = (bft <= 1e-12f) ? entry_axis : bax;
      int cell[3], ax;
      float ft;
      const walk::Fine f = walk::fine_brick(v.occw + (size_t)b * 16, o, d, rd, sgn,
                                            dl, b0, enter, ax0, g.vpu, h.steps,
                                            cell, ft, ax);
      if (f == walk::FINE_CAP) break;
      if (f == walk::FINE_HIT) {
        const int bit = cell[2] * 64 + cell[1] * 8 + cell[0];
        h.t = fmaf(ft, g.rvpu, enter);
        h.mat = (int)__ldg(&v.matb[(size_t)b * 512 + bit]);
        h.ax = ax * 2 + (walk::pick3(sgn, ax) > 0 ? 1 : 0);
        return h;
      }
    }
    // one brick step (indep.py:302-328)
    const int a = walk::aw_axis(bt);
    int moved;
    if (a == 0) {
      cb[0] += sgn[0]; bft = bt[0]; bt[0] = bt[0] + dl[0]; moved = cb[0];
    } else if (a == 1) {
      cb[1] += sgn[1]; bft = bt[1]; bt[1] = bt[1] + dl[1]; moved = cb[1];
    } else {
      cb[2] += sgn[2]; bft = bt[2]; bt[2] = bt[2] + dl[2]; moved = cb[2];
    }
    bax = a;
    ++h.steps;
    if (moved < 0 || moved >= g.nb[a]) return h;
  }
  h.resolved = 0;   // a fine pass or the walk ran out of steps
  return h;
}

// Camera frame (B3): one thread per pixel, 16x16 pixel blocks, image order.
__global__ void indep_camera_kernel(const float* __restrict__ cam,
                                    const float* __restrict__ pal, Volume v,
                                    int width, int height, int shading,
                                    int sky_mode, float ambient,
                                    int32_t* __restrict__ rgba_out,
                                    float* __restrict__ t_out,
                                    int32_t* __restrict__ aux_out) {
  __shared__ float spal[256 * 3];
  __shared__ uint32_t sbits[BITMAP_WORDS];
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  for (int i = tid; i < 256 * 3; i += nthreads) spal[i] = __ldg(&pal[i]);
  load_bitmap(sbits, v.occb, tid, nthreads);
  __syncthreads();

  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= width || y >= height) return;

  float o[3], d[3];
  frame::camera_ray(cam, x, y, o, d);
  const Hit h = indep_ray(o, d, sbits, v);
  const size_t idx = (size_t)y * width + x;
  const bool hit = h.t < BIG;
  t_out[idx] = h.t;
  aux_out[idx] = frame::pack_aux(h.mat, h.ax, h.resolved, h.steps);
  rgba_out[idx] = frame::shade_rgba(cam, spal, d, hit, h.mat, h.ax, shading,
                                    sky_mode, ambient);
}

// Ray list (B4): one thread per ray, (N, 3) float32 origins and directions
// in the volume's local frame; trace outputs.
__global__ void __launch_bounds__(RAY_THREADS)
indep_rays_kernel(const float* __restrict__ orig, const float* __restrict__ dirs,
                  int n, Volume v, float* __restrict__ t_out,
                  int32_t* __restrict__ aux_out) {
  __shared__ uint32_t sbits[BITMAP_WORDS];
  load_bitmap(sbits, v.occb, threadIdx.x, blockDim.x);
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t r3 = 3 * (size_t)i;
  const float o[3] = {__ldg(&orig[r3]), __ldg(&orig[r3 + 1]), __ldg(&orig[r3 + 2])};
  const float d[3] = {__ldg(&dirs[r3]), __ldg(&dirs[r3 + 1]), __ldg(&dirs[r3 + 2])};
  const Hit h = indep_ray(o, d, sbits, v);
  t_out[i] = h.t;
  aux_out[i] = frame::pack_aux(h.mat, h.ax, h.resolved, h.steps);
}

Volume make_volume(const int32_t* occb, const uint32_t* occw, const uint8_t* matb,
                   const int* nb, const float* geo) {
  Volume v;
  v.occb = occb;
  v.occw = occw;
  v.matb = matb;
  v.g = walk::make_geo(nb, geo);
  return v;
}

}  // namespace

// nb: bricks (BX, BY, BZ), at most 4096 in all; geo: see walk::make_geo.
extern "C" int vt_indep_camera(const float* cam, const float* pal,
                               const int32_t* occb, const uint32_t* occw,
                               const uint8_t* matb, const int* nb,
                               const float* geo, int width, int height,
                               int shading, int sky_mode, float ambient,
                               int32_t* rgba, float* t, int32_t* aux,
                               cudaStream_t stream) {
  const Volume v = make_volume(occb, occw, matb, nb, geo);
  const dim3 block(16, 16);
  const dim3 grid((width + 15) / 16, (height + 15) / 16);
  indep_camera_kernel<<<grid, block, 0, stream>>>(cam, pal, v, width, height,
                                                  shading, sky_mode, ambient,
                                                  rgba, t, aux);
  return (int)cudaGetLastError();
}

extern "C" int vt_indep_rays(const float* orig, const float* dirs, int n,
                             const int32_t* occb, const uint32_t* occw,
                             const uint8_t* matb, const int* nb,
                             const float* geo, float* t, int32_t* aux,
                             cudaStream_t stream) {
  const Volume v = make_volume(occb, occw, matb, nb, geo);
  indep_rays_kernel<<<(n + RAY_THREADS - 1) / RAY_THREADS, RAY_THREADS, 0,
                      stream>>>(orig, dirs, n, v, t, aux);
  return (int)cudaGetLastError();
}

extern "C" const char* vt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
