// Fused primary-ray frame and ray-list tracer for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel built by
// voxel_tracer_tpu/ops/pallas/mega.py:_make_mega_kernel at its two launch
// sites: render_mega_tiles (camera rays, mega.py:2492) and trace_rays
// (local-space ray lists, mega.py:2768).  It computes what that kernel
// computes -- raygen, slab test, two-level DDA first hit, material byte,
// palette albedo, flat/lambert/raw/trace shading, analytic or constant sky,
// ACES, RGBA8 -- but not with its block structure: the TPU traversal modes
// (hier3 span scans, slice windows, votes) exist to feed an 8x128-lane VPU
// without per-lane gathers.  Here one thread walks one ray through the
// 8^3 two-level Amanatides-Woo DDA of voxel_tracer_tpu/ops/dda.py, so
// every ray resolves except where the shared 256-step budget runs out.
//
// Bound: per-ray dependent loads (brick flag, one occupancy word per fine
// step, one material byte per hit) and the divergence of loop trip counts
// inside a warp; the tables are read through the read-only path (__ldg)
// and stay in L2 for the volumes this slice renders.  The design keeps
// neighbouring rays in one warp (16x16 pixel blocks for camera rays) so
// their loads hit the same bricks.  Speed is left to later work.
//
// Rounding: the traversal is compiled with --fmad=false and uses fmaf at
// exactly the three places where ops/dda.py (and XLA's CPU backend, for
// the JAX function) use a fused multiply-add, so its t, steps and axis
// equal the plain PyTorch version's bit for bit.
//
// Launchers are extern "C", run on the caller's stream, allocate nothing,
// and return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "frame.cuh"

namespace {

constexpr float BIG_F32 = 1e30f;   // DDA miss / clamp value (math3d.py:17)
constexpr float BIG_OUT = 3e37f;   // kernel output miss depth (mega.py:41)
constexpr int BRICK = 8;

enum Mode { MODE_MISS = 0, MODE_BRICK = 1, MODE_FINE = 2, MODE_HIT = 3 };

struct Volume {
  const int32_t* bocc;    // (NB,) 1 where the 8^3 brick holds a solid voxel
  const uint32_t* occw;   // (NB, 16) occupancy bits, bit = z*64 + y*8 + x
  const uint8_t* matb;    // (NB, 512) material bytes, same index
  int bsize[3];           // brick grid (BX, BY, BZ)
  int gsize[3];           // voxel grid (GX, GY, GZ)
  float vpu;
  int max_steps;
};

struct Hit {
  float t;          // BIG_F32 on a miss
  int mat;          // 0 on a miss
  int ax;           // axis*2 + (step sign > 0) on a hit; entry axis*2 on a miss
  int steps;
  int resolved;     // 0 where the step budget ran out
};

// First cell and crossing t's of one axis of a DDA level (dda._cell_setup).
__device__ __forceinline__ void cell_setup(float e, float stepf, float rdir,
                                           int hi, int& cell, float& tm) {
  int c = (int)floorf(e);
  c = min(max(c, 0), hi);
  float v = (((float)c - e) + fmaxf(stepf, 0.0f)) * rdir;
  if (isnan(v)) v = BIG_F32;
  cell = c;
  tm = fminf(v, BIG_F32);
}

// One Amanatides-Woo step in the reference comparison order
// (vv.cpp:176-202, dda._aw_step).  Returns true when the step leaves
// [0, lim) on its axis.
__device__ __forceinline__ bool aw_step(int cell[3], float tm[3],
                                        const int step[3],
                                        const float delta[3], const int lim[3],
                                        float& t, int& axis) {
  const bool use_x = (tm[0] < tm[1]) && (tm[0] < tm[2]);
  const bool use_y = !(tm[0] < tm[1]) && (tm[1] < tm[2]);
  const int a = use_x ? 0 : (use_y ? 1 : 2);
  cell[a] += step[a];
  t = tm[a];
  tm[a] = tm[a] + delta[a];
  axis = a;
  return cell[a] < 0 || cell[a] >= lim[a];
}

__device__ Hit trace_ray(const float o[3], const float d[3], const Volume& v,
                         bool fetch_mat) {
  // ---- slab entry vs [0, size] (dda.slab_test, obb.cpp:48-80) ----------
  float tmin = 0.0f, tmax = 0.0f;
  int entry_arg = 0;
  for (int a = 0; a < 3; ++a) {
    const float size = (float)v.gsize[a] / v.vpu;
    const float rcp = 1.0f / d[a];
    const float t1 = (0.0f - o[a]) * rcp;
    const float t2 = (size - o[a]) * rcp;
    // jnp/torch minimum propagate NaN (0 * inf on a slab plane); the guard
    // then maps it to -BIG / +BIG.  fminf would drop the NaN instead.
    const bool nan = isnan(t1) || isnan(t2);
    const float tn = nan ? -BIG_F32 : fminf(t1, t2);
    const float tf = nan ? BIG_F32 : fmaxf(t1, t2);
    if (tn > tmin) {            // first maximum of [0, tn_x, tn_y, tn_z]
      tmin = tn;
      entry_arg = a + 1;
    }
    tmax = (a == 0) ? tf : fminf(tmax, tf);
  }
  const int entry_axis = max(entry_arg - 1, 0);
  const bool slab_hit = tmax - 1e-4f >= tmin;

  // ---- two-level DDA state (dda.intersect_volume_local) ---------------
  const float bpu = v.vpu / (float)BRICK;
  const float rbpu = 1.0f / bpu;
  float stepf[3], rdir[3], delta[3];
  int stepi[3];
  const int flim[3] = {BRICK, BRICK, BRICK};
  int bcell[3], fcell[3] = {0, 0, 0};
  float btmax[3], ftmax[3] = {0.0f, 0.0f, 0.0f};
  for (int a = 0; a < 3; ++a) {
    stepf[a] = signbit(d[a]) ? -1.0f : 1.0f;
    stepi[a] = (int)stepf[a];
    rdir[a] = 1.0f / d[a];
    delta[a] = fminf(fabsf(rdir[a]), BIG_F32);
    const float e = fmaf(d[a], tmin, o[a]) * bpu;
    cell_setup(e, stepf[a], rdir[a], v.bsize[a] - 1, bcell[a], btmax[a]);
  }

  int mode = slab_hit ? MODE_BRICK : MODE_MISS;
  float bt = 0.0f, ft = 0.0f, b_entry = 0.0f, hit_t = BIG_F32;
  int axis = entry_axis, steps = 0, hit_mat = 0;
  bool hit_entry = false, exhausted = false;

  for (int it = 0; it < 2 * v.max_steps; ++it) {
    if (mode != MODE_BRICK && mode != MODE_FINE) break;
    if (steps >= v.max_steps) {          // budget exhausted -> miss
      mode = MODE_MISS;
      exhausted = true;
      break;
    }
    const int bidx = (bcell[2] * v.bsize[1] + bcell[1]) * v.bsize[0] + bcell[0];
    bool do_bstep = false;
    if (mode == MODE_BRICK) {
      if (__ldg(&v.bocc[bidx]) != 0) {
        // enter the occupied brick (vv.cpp:237-251)
        const float bet = fmaf(bt, rbpu, tmin);
        for (int a = 0; a < 3; ++a) {
          const float p = fmaf(d[a], bet, o[a]);
          const float fe = fmaf(-(float)bcell[a], rbpu, p) * v.vpu;
          cell_setup(fe, stepf[a], rdir[a], BRICK - 1, fcell[a], ftmax[a]);
        }
        ft = 0.0f;
        b_entry = bet;
        mode = MODE_FINE;
      } else {
        do_bstep = true;
      }
    } else {
      const int bit = (fcell[2] * BRICK + fcell[1]) * BRICK + fcell[0];
      const uint32_t w = __ldg(&v.occw[(size_t)bidx * 16 + (bit >> 5)]);
      if ((w >> (bit & 31)) & 1u) {
        hit_t = b_entry + ft / v.vpu;
        hit_mat = fetch_mat ? (int)__ldg(&v.matb[(size_t)bidx * 512 + bit]) : 0;
        hit_entry = steps == 0;
        mode = MODE_HIT;
      } else {
        int ncell[3] = {fcell[0], fcell[1], fcell[2]};
        float ntm[3] = {ftmax[0], ftmax[1], ftmax[2]};
        float nt;
        int nax;
        if (aw_step(ncell, ntm, stepi, delta, flim, nt, nax)) {
          do_bstep = true;               // leave the brick: brick step, same iteration
        } else {
          for (int a = 0; a < 3; ++a) { fcell[a] = ncell[a]; ftmax[a] = ntm[a]; }
          ft = nt;
          axis = nax;
          ++steps;
        }
      }
    }
    if (do_bstep) {
      float nt;
      int nax;
      const bool oob = aw_step(bcell, btmax, stepi, delta, v.bsize, nt, nax);
      bt = nt;
      axis = nax;
      ++steps;
      mode = oob ? MODE_MISS : MODE_BRICK;
    }
  }

  Hit h;
  const bool hit = mode == MODE_HIT;
  // entry-voxel hits keep the slab entry axis (vv.cpp:159)
  const int fin_axis = hit_entry ? entry_axis : axis;
  h.t = hit ? hit_t : BIG_F32;
  h.mat = hit ? hit_mat : 0;
  h.ax = hit ? fin_axis * 2 + (stepf[fin_axis] > 0.0f ? 1 : 0) : entry_axis * 2;
  h.steps = steps;
  h.resolved = (exhausted || mode == MODE_BRICK || mode == MODE_FINE) ? 0 : 1;
  return h;
}

__device__ __forceinline__ int32_t pack_aux(const Hit& h) {
  return frame::pack_aux(h.mat, h.ax, h.resolved, h.steps);
}

// Camera frame: one thread per pixel, 16x16 pixel blocks, image order;
// cam: the 29 camera floats (frame.cuh).
__global__ void mega_camera_kernel(const float* __restrict__ cam,
                                   const float* __restrict__ pal, Volume v,
                                   int width, int height, int shading,
                                   int sky_mode, float ambient,
                                   int32_t* __restrict__ rgba_out,
                                   float* __restrict__ t_out,
                                   int32_t* __restrict__ aux_out) {
  __shared__ float spal[256 * 3];
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int i = tid; i < 256 * 3; i += blockDim.x * blockDim.y) spal[i] = __ldg(&pal[i]);
  __syncthreads();

  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= width || y >= height) return;

  float o[3], d[3];
  frame::camera_ray(cam, x, y, o, d);
  const Hit h = trace_ray(o, d, v, shading != frame::SHADE_TRACE);
  const size_t idx = (size_t)y * width + x;
  const bool hit = h.t < BIG_F32;
  t_out[idx] = hit ? h.t : BIG_OUT;
  aux_out[idx] = pack_aux(h);
  rgba_out[idx] = frame::shade_rgba(cam, spal, d, hit, h.mat, h.ax, shading,
                                    sky_mode, ambient);
}

// Ray list: one thread per ray, (N, 3) float32 origins and directions in
// the volume's local frame; trace-only outputs.
__global__ void mega_rays_kernel(const float* __restrict__ orig,
                                 const float* __restrict__ dirs, int n,
                                 Volume v, int fetch_mat,
                                 float* __restrict__ t_out,
                                 int32_t* __restrict__ aux_out) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)n) return;
  const float o[3] = {__ldg(&orig[3 * i]), __ldg(&orig[3 * i + 1]), __ldg(&orig[3 * i + 2])};
  const float d[3] = {__ldg(&dirs[3 * i]), __ldg(&dirs[3 * i + 1]), __ldg(&dirs[3 * i + 2])};
  const Hit h = trace_ray(o, d, v, fetch_mat != 0);
  t_out[i] = h.t < BIG_F32 ? h.t : BIG_OUT;
  aux_out[i] = pack_aux(h);
}

Volume make_volume(const int32_t* bocc, const uint32_t* occw,
                   const uint8_t* matb, int bx, int by, int bz, int gx, int gy,
                   int gz, float vpu, int max_steps) {
  Volume v;
  v.bocc = bocc;
  v.occw = occw;
  v.matb = matb;
  v.bsize[0] = bx; v.bsize[1] = by; v.bsize[2] = bz;
  v.gsize[0] = gx; v.gsize[1] = gy; v.gsize[2] = gz;
  v.vpu = vpu;
  v.max_steps = max_steps;
  return v;
}

}  // namespace

extern "C" int vt_mega_camera(const float* cam, const float* pal,
                              const int32_t* bocc, const uint32_t* occw,
                              const uint8_t* matb, int bx, int by, int bz,
                              int gx, int gy, int gz, float vpu, int max_steps,
                              int width, int height, int shading, int sky_mode,
                              float ambient, int32_t* rgba, float* t,
                              int32_t* aux, cudaStream_t stream) {
  const Volume v = make_volume(bocc, occw, matb, bx, by, bz, gx, gy, gz, vpu,
                               max_steps);
  const dim3 block(16, 16);
  const dim3 grid((width + 15) / 16, (height + 15) / 16);
  mega_camera_kernel<<<grid, block, 0, stream>>>(cam, pal, v, width, height,
                                                 shading, sky_mode, ambient,
                                                 rgba, t, aux);
  return (int)cudaGetLastError();
}

extern "C" int vt_mega_rays(const float* orig, const float* dirs, int n,
                            const int32_t* bocc, const uint32_t* occw,
                            const uint8_t* matb, int bx, int by, int bz,
                            int gx, int gy, int gz, float vpu, int max_steps,
                            int fetch_mat, float* t, int32_t* aux,
                            cudaStream_t stream) {
  const Volume v = make_volume(bocc, occw, matb, bx, by, bz, gx, gy, gz, vpu,
                               max_steps);
  const int threads = 256;
  mega_rays_kernel<<<(n + threads - 1) / threads, threads, 0, stream>>>(
      orig, dirs, n, v, fetch_mat, t, aux);
  return (int)cudaGetLastError();
}

extern "C" const char* vt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
