// Fused primary-ray frame and ray-list tracer for Hopper (sm_90a) -- B1
// and B2.
//
// Replaces the Pallas TPU kernel built by
// voxel_tracer_tpu/ops/pallas/mega.py:_make_mega_kernel at its two launch
// sites: render_mega_tiles (camera rays, mega.py:2536) and trace_rays
// (local-space ray lists, mega.py:2810).  It computes what that kernel
// computes -- raygen, slab test, two-level DDA first hit, material byte,
// palette albedo, flat/lambert/raw/trace shading, analytic or constant sky,
// ACES, RGBA8 -- but not with its block structure: the TPU traversal modes
// (hier3 span scans, slice windows, votes) exist to feed an 8x128-lane VPU
// without per-lane gathers.  Here one thread walks one ray through the
// 8^3 two-level Amanatides-Woo DDA of voxel_tracer_tpu/ops/dda.py, so
// every ray resolves except where the shared 256-step budget runs out.
//
// Loop shape: an outer brick walk and, inside each occupied brick, a fine
// walk, with the axis of every step chosen by explicit branches, so the
// whole DDA state stays in scalar registers (nothing is indexed by a
// run-time axis; ptxas reports no stack frame).  The brick flags are a
// bitmap (bit b & 31 of word b >> 5) read through the read-only path:
// 4 KB at 32,768 bricks, L1-resident.  Staging it in each block's shared
// memory measured 0-2.5 % slower on every volume tried (16 to 1024 words;
// tools/torch_mega_trials.py, variant shared_bitmap).
//
// Bound: per-ray dependent loads (one bitmap word per brick, one occupancy
// word per fine step, one material byte per hit, read through __ldg and
// L2-resident for the
// volumes the port renders) and the divergence of loop trip counts inside
// a warp.  The fine walk requests the next cell's word before it tests the
// current one, so a step waits on one load less; neighbouring rays (8x4
// pixels a warp for camera rays) cross the same bricks.  Launch bounds of
// (threads, 1) leave ptxas its registers: with (threads) alone it capped
// them at 40-48 and spilled.
//
// Float program and step count: those of ops/dda.py, unchanged by the loop
// shape.  The traversal is compiled with --fmad=false and calls fmaf at
// exactly the places where ops/dda.py (and XLA's CPU backend, for the JAX
// function) fuse a multiply-add -- the brick entry point, the brick entry
// t and the fine entry point -- so t, steps and axis equal the plain
// PyTorch version's bit for bit.  A fine step counts only when it moves;
// entering an occupied brick is free; a fine exit and its brick step count
// once.  The reference loop also stops after 2 * max_steps iterations (an
// iteration is a brick entry or a step); that cap never changes a result:
// every entry is followed by a step or by the end of the walk, so entries
// <= steps + 1, and the cap can only bind once steps == max_steps, where
// the budget ends the walk with the same outputs.
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
constexpr int RAY_THREADS = 256;

struct Volume {
  const uint32_t* bits;   // (ceil(NB / 32),) brick bitmap: bit b & 31 of word b >> 5
  const uint32_t* occw;   // (NB, 16) occupancy bits, bit = z*64 + y*8 + x
  const uint8_t* matb;    // (NB, 512) material bytes, same index
  int bx, by, bz;         // brick grid
  int gx, gy, gz;         // voxel grid
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

// First cell and crossing t of one axis of a DDA level (dda._cell_setup);
// pos: the step sign is +1.
__device__ __forceinline__ void cell_setup(float e, bool pos, float rdir, int hi,
                                           int& cell, float& tm) {
  int c = (int)floorf(e);
  c = min(max(c, 0), hi);
  float v = (((float)c - e) + (pos ? 1.0f : 0.0f)) * rdir;
  if (isnan(v)) v = BIG_F32;
  cell = c;
  tm = fminf(v, BIG_F32);
}

// Slab entry vs [0, size] (dda.slab_test, obb.cpp:48-80): size = gsize /
// vpu, unclamped 1/d, the first maximum's axis; returns whether the ray
// enters (tmax - 1e-4 >= tmin).
__device__ __forceinline__ bool slab_entry(const float o[3], const float d[3],
                                           const Volume& v, float& tmin,
                                           int& entry_axis) {
  const int gs[3] = {v.gx, v.gy, v.gz};
  float tmax = 0.0f;
  int entry_arg = 0;
  tmin = 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float size = (float)gs[a] / v.vpu;
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
  entry_axis = max(entry_arg - 1, 0);
  return tmax - 1e-4f >= tmin;
}

// First hit of one ray (dda.intersect_volume_local).
__device__ __forceinline__ Hit trace_ray(const float o[3], const float d[3],
                                         const Volume& v, bool fetch_mat) {
  float tmin;
  int entry_axis;
  const bool enters = slab_entry(o, d, v, tmin, entry_axis);
  Hit h = {BIG_F32, 0, entry_axis * 2, 0, 1};
  if (!enters) return h;

  // ---- per-axis DDA constants and the brick level's start ---------------
  const float bpu = v.vpu / (float)BRICK;
  const float rbpu = 1.0f / bpu;
  const bool px = !signbit(d[0]), py = !signbit(d[1]), pz = !signbit(d[2]);
  const int sx = px ? 1 : -1, sy = py ? 1 : -1, sz = pz ? 1 : -1;
  const float rx = 1.0f / d[0], ry = 1.0f / d[1], rz = 1.0f / d[2];
  // clamp inf (axis-parallel rays) so tmax += delta never meets 0*inf
  const float dlx = fminf(fabsf(rx), BIG_F32), dly = fminf(fabsf(ry), BIG_F32),
              dlz = fminf(fabsf(rz), BIG_F32);
  int bcx, bcy, bcz;
  float btx, bty, btz;
  cell_setup(fmaf(d[0], tmin, o[0]) * bpu, px, rx, v.bx - 1, bcx, btx);
  cell_setup(fmaf(d[1], tmin, o[1]) * bpu, py, ry, v.by - 1, bcy, bty);
  cell_setup(fmaf(d[2], tmin, o[2]) * bpu, pz, rz, v.bz - 1, bcz, btz);

  float bt = 0.0f;          // t of the last brick step, in brick units
  int axis = entry_axis;    // axis of the last counted step
  int steps = 0;
  const int max_steps = v.max_steps;
  for (;;) {
    if (steps >= max_steps) {            // budget exhausted: a miss
      h.steps = steps;
      h.resolved = 0;
      return h;
    }
    const int b = (bcz * v.by + bcy) * v.bx + bcx;
    if ((__ldg(&v.bits[b >> 5]) >> (b & 31)) & 1u) {
      // enter the occupied brick (vv.cpp:237-251): an iteration, no step
      const float bet = fmaf(bt, rbpu, tmin);
      int fx, fy, fz;
      float fmx, fmy, fmz;
      cell_setup(fmaf(-(float)bcx, rbpu, fmaf(d[0], bet, o[0])) * v.vpu, px, rx,
                 BRICK - 1, fx, fmx);
      cell_setup(fmaf(-(float)bcy, rbpu, fmaf(d[1], bet, o[1])) * v.vpu, py, ry,
                 BRICK - 1, fy, fmy);
      cell_setup(fmaf(-(float)bcz, rbpu, fmaf(d[2], bet, o[2])) * v.vpu, pz, rz,
                 BRICK - 1, fz, fmz);
      const uint32_t* w = v.occw + (size_t)b * 16;
      float ft = 0.0f;
      int bit = (fz * BRICK + fy) * BRICK + fx;
      uint32_t word = __ldg(&w[bit >> 5]);
      for (;;) {
        // the next cell depends only on the crossing t's, not on this
        // cell's bit: choose it (vv.cpp:176-202 comparison order) and
        // request its occupancy word before this cell's test
        const bool ux = (fmx < fmy) && (fmx < fmz);
        const bool uy = !(fmx < fmy) && (fmy < fmz);
        const int nx = ux ? fx + sx : fx, ny = uy ? fy + sy : fy,
                  nz = (!ux && !uy) ? fz + sz : fz;
        const bool leaves = ((unsigned)nx | (unsigned)ny | (unsigned)nz) >= (unsigned)BRICK;
        const int nbit = (nz * BRICK + ny) * BRICK + nx;
        const uint32_t nword = leaves ? 0u : __ldg(&w[nbit >> 5]);
        if ((word >> (bit & 31)) & 1u) {
          // entry-voxel hits keep the slab entry axis (vv.cpp:159)
          const int ha = steps == 0 ? entry_axis : axis;
          const bool hpos = ha == 0 ? px : (ha == 1 ? py : pz);
          h.t = bet + ft / v.vpu;
          h.mat = fetch_mat ? (int)__ldg(&v.matb[(size_t)b * 512 + bit]) : 0;
          // a zero direction (refract's total internal reflection) enters
          // the slab at t = inf and stops at a cell with t = inf or NaN:
          // the output calls that a miss, which keeps the entry axis, as
          // the plain version does
          h.ax = h.t < BIG_F32 ? ha * 2 + (hpos ? 1 : 0) : entry_axis * 2;
          h.steps = steps;
          return h;
        }
        // leaving the brick discards the fine step: the brick step below
        // takes its place in the same iteration
        if (leaves) break;
        if (ux) { ft = fmx; fmx = fmx + dlx; axis = 0; }
        else if (uy) { ft = fmy; fmy = fmy + dly; axis = 1; }
        else { ft = fmz; fmz = fmz + dlz; axis = 2; }
        fx = nx; fy = ny; fz = nz; bit = nbit; word = nword;
        if (++steps >= max_steps) {      // budget exhausted: a miss
          h.steps = steps;
          h.resolved = 0;
          return h;
        }
      }
    }
    // one brick step: an empty brick, or a fine exit in the same iteration
    bool oob;
    if ((btx < bty) && (btx < btz)) {
      bcx += sx; bt = btx; btx = btx + dlx; axis = 0;
      oob = (unsigned)bcx >= (unsigned)v.bx;
    } else if (!(btx < bty) && (bty < btz)) {
      bcy += sy; bt = bty; bty = bty + dly; axis = 1;
      oob = (unsigned)bcy >= (unsigned)v.by;
    } else {
      bcz += sz; bt = btz; btz = btz + dlz; axis = 2;
      oob = (unsigned)bcz >= (unsigned)v.bz;
    }
    ++steps;
    if (oob) {                           // left the grid: a resolved miss
      h.steps = steps;
      return h;
    }
  }
}

// Camera frame: one thread per pixel, 8x32 pixel blocks (a warp covers 8x4
// pixels), image order;
// cam: the 29 camera floats (frame.cuh).
__global__ void __launch_bounds__(256, 1)
mega_camera_kernel(const float* __restrict__ cam, const float* __restrict__ pal,
                   Volume v, int width, int height, int shading, int sky_mode,
                   float ambient, int32_t* __restrict__ rgba_out,
                   float* __restrict__ t_out, int32_t* __restrict__ aux_out) {
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
  aux_out[idx] = frame::pack_aux(h.mat, h.ax, h.resolved, h.steps);
  rgba_out[idx] = frame::shade_rgba(cam, spal, d, hit, h.mat, h.ax, shading,
                                    sky_mode, ambient);
}

// Ray list: one thread per ray, (N, 3) float32 origins and directions in
// the volume's local frame; trace-only outputs.
__global__ void __launch_bounds__(RAY_THREADS, 1)
mega_rays_kernel(const float* __restrict__ orig, const float* __restrict__ dirs,
                 int n, Volume v, int fetch_mat, float* __restrict__ t_out,
                 int32_t* __restrict__ aux_out) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)n) return;
  const float o[3] = {__ldg(&orig[3 * i]), __ldg(&orig[3 * i + 1]), __ldg(&orig[3 * i + 2])};
  const float d[3] = {__ldg(&dirs[3 * i]), __ldg(&dirs[3 * i + 1]), __ldg(&dirs[3 * i + 2])};
  const Hit h = trace_ray(o, d, v, fetch_mat != 0);
  t_out[i] = h.t < BIG_F32 ? h.t : BIG_OUT;
  aux_out[i] = frame::pack_aux(h.mat, h.ax, h.resolved, h.steps);
}

Volume make_volume(const int32_t* bits, const uint32_t* occw, const uint8_t* matb,
                   int bx, int by, int bz, int gx, int gy, int gz, float vpu,
                   int max_steps) {
  Volume v;
  v.bits = reinterpret_cast<const uint32_t*>(bits);
  v.occw = occw;
  v.matb = matb;
  v.bx = bx; v.by = by; v.bz = bz;
  v.gx = gx; v.gy = gy; v.gz = gz;
  v.vpu = vpu;
  v.max_steps = max_steps;
  return v;
}

}  // namespace

// bits: the brick bitmap, ceil(bx * by * bz / 32) words.
extern "C" int vt_mega_camera(const float* cam, const float* pal,
                              const int32_t* bits, const uint32_t* occw,
                              const uint8_t* matb, int bx, int by, int bz,
                              int gx, int gy, int gz, float vpu, int max_steps,
                              int width, int height, int shading, int sky_mode,
                              float ambient, int32_t* rgba, float* t,
                              int32_t* aux, cudaStream_t stream) {
  const Volume v = make_volume(bits, occw, matb, bx, by, bz, gx, gy, gz, vpu,
                               max_steps);
  const dim3 block(8, 32);
  const dim3 grid((width + block.x - 1) / block.x, (height + block.y - 1) / block.y);
  mega_camera_kernel<<<grid, block, 0, stream>>>(cam, pal, v, width, height,
                                                 shading, sky_mode, ambient,
                                                 rgba, t, aux);
  return (int)cudaGetLastError();
}

extern "C" int vt_mega_rays(const float* orig, const float* dirs, int n,
                            const int32_t* bits, const uint32_t* occw,
                            const uint8_t* matb, int bx, int by, int bz,
                            int gx, int gy, int gz, float vpu, int max_steps,
                            int fetch_mat, float* t, int32_t* aux,
                            cudaStream_t stream) {
  const Volume v = make_volume(bits, occw, matb, bx, by, bz, gx, gy, gz, vpu,
                               max_steps);
  mega_rays_kernel<<<(n + RAY_THREADS - 1) / RAY_THREADS, RAY_THREADS, 0, stream>>>(
      orig, dirs, n, v, fetch_mat, t, aux);
  return (int)cudaGetLastError();
}

extern "C" const char* vt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
