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
// ray is unresolved only if a fine pass ran FINE_ITERS steps or the walk
// ran nb_x + nb_y + nb_z + 2 brick iterations without a hit or an exit,
// which a well-formed ray cannot do.
//
// Loop shape: an outer brick walk and, inside each occupied brick, a fine
// walk.  Each step's axis comes from the reference's comparisons and is
// committed with selects, so the whole DDA state stays in scalar registers
// (nothing is indexed by a run-time axis; ptxas reports a 0-byte stack
// frame).  The next cell depends only on the crossing t's, so each level
// requests its next word ahead: the fine walk the next cell's occupancy
// word before it tests the current cell, the brick walk, as it steps into
// a brick, the bitmap word of the brick after it; the float updates commit
// after the test, unchanged.  Those loads stay inside the brick's 16 words
// or the 128-word bitmap even where the ray is about to leave, so they
// need no branch.  Each block stages the bitmap (512 bytes, bit b & 31 of
// word b >> 5) in shared memory; occupancy words and material bytes are
// read through the read-only path.  tools/torch_indep_trials.py keeps the
// alternatives it measured (branches, one loop over both levels, no
// prefetch, the bitmap through __ldg, the occupancy words bulk-copied into
// shared memory, persistent rays, other block shapes).
//
// Bound: per-ray dependent loads (one bitmap word per brick step, one
// occupancy word per fine step, one material byte per hit; L1- or
// L2-resident for the <= 4096-brick volumes this kernel takes), the issue
// rate of the steps, and the divergence of loop trip counts inside a warp.
// Camera blocks are 8x32 pixels (a warp covers 8x4 pixels, whose rays
// cross the same bricks); ray-list blocks are 128 threads, which spread a
// list whose walk lengths follow its order over more SMs than 256-thread
// blocks do.  Launch bounds of (threads, 1) leave ptxas its registers.
//
// Rounding: the float program is indep's, not B1's: enter = tmin + bft /
// bpu, t = enter + ft / vpu, steps = brick steps + fine cells tested (the
// entry cell's test counts).  Compiled with --fmad=false; fmaf where XLA's
// CPU backend contracts the JAX kernel under jit (the brick walk's entry
// point, enter, the fine entry point, t); the plain PyTorch version
// (ops/cuda/indep.py:_walk) does the same float32 operations in the same
// order.
//
// Launchers are extern "C", run on the caller's stream, allocate nothing,
// and return cudaGetLastError().

#include "brick_walk.cuh"
#include "frame.cuh"

namespace {

using walk::BIG;
using walk::FINE_ITERS;
using walk::fine_setup;
using walk::Geo;

constexpr int RAY_THREADS = 128;

struct Volume {
  const uint32_t* bits;   // (128,) brick bitmap: bit b & 31 of word b >> 5
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

// First cell and crossing t of one axis at the brick level's entry point e
// (cells in [0, hi]); pos: the step sign is +1.  The brick level clamps in
// float (indep.py:146-152), the fine level in int (:190-198,
// walk::fine_setup).
__device__ __forceinline__ void brick_setup(float e, bool pos, float rdir, int hi,
                                            int& cell, float& tm) {
  cell = (int)fminf(fmaxf(floorf(e), 0.0f), (float)hi);
  float v = (((float)cell - e) + (pos ? 1.0f : 0.0f)) * rdir;
  if (isnan(v)) v = BIG;
  tm = fminf(v, BIG);
}

// First hit of one ray (indep.py:106-328 for one lane).
__device__ __forceinline__ Hit indep_ray(const float o[3], const float d[3],
                                         const uint32_t* __restrict__ bits,
                                         const Volume& v) {
  const Geo& g = v.g;
  float rd[3], tmin, tmax;
  int entry_axis;
  const bool valid = walk::volume_slab(o, d, g, rd, tmin, tmax, entry_axis);
  Hit h = {BIG, 0, entry_axis * 2, 0, 1};
  if (!valid) return h;

  // ---- per-axis constants and the brick walk's start, in brick units ----
  const bool px = !signbit(d[0]), py = !signbit(d[1]), pz = !signbit(d[2]);
  const int sx = px ? 1 : -1, sy = py ? 1 : -1, sz = pz ? 1 : -1;
  const float dlx = fminf(fabsf(rd[0]), BIG), dly = fminf(fabsf(rd[1]), BIG),
              dlz = fminf(fabsf(rd[2]), BIG);
  const int nbx = g.nb[0], nby = g.nb[1], nbz = g.nb[2];
  int bcx, bcy, bcz;
  float btx, bty, btz;
  brick_setup(fmaf(d[0], tmin, o[0]) * g.bpu, px, rd[0], nbx - 1, bcx, btx);
  brick_setup(fmaf(d[1], tmin, o[1]) * g.bpu, py, rd[1], nby - 1, bcy, bty);
  brick_setup(fmaf(d[2], tmin, o[2]) * g.bpu, pz, rd[2], nbz - 1, bcz, btz);

  float bft = 0.0f;       // brick-unit time of the current brick's entry
  int bax = entry_axis;   // axis of that entry step
  int steps = 0;
  // the brick after the current one depends only on the crossing t's
  // (indep.py:302-328, reference comparison order): its bitmap word is
  // requested a whole iteration before its test.  Past the grid's edge the
  // index is meaningless but the masked load stays inside the bitmap, and
  // the step that would enter that brick ends the walk instead.
  auto next_brick = [&]() {
    const bool ux = (btx < bty) && (btx < btz);
    const bool uy = !(btx < bty) && (bty < btz);
    const int nx = ux ? bcx + sx : bcx, ny = uy ? bcy + sy : bcy,
              nz = (!ux && !uy) ? bcz + sz : bcz;
    return (nz * nby + ny) * nbx + nx;
  };
  int b = (bcz * nby + bcy) * nbx + bcx;
  uint32_t bword = bits[b >> 5];
  int nbi = next_brick();
  uint32_t nbword = bits[((unsigned)nbi >> 5) & 127u];
  const int max_outer = nbx + nby + nbz + 2;
  for (int it = 0; it < max_outer; ++it) {
    if ((bword >> (b & 31)) & 1u) {
      // fine pass of the occupied brick (indep.py:171-273)
      const float enter = fmaf(bft, g.rbpu, tmin);
      int fx, fy, fz;
      float fmx, fmy, fmz;
      fine_setup((fmaf(d[0], enter, o[0]) - (float)bcx * g.rbpu) * g.vpu, px, rd[0], fx, fmx);
      fine_setup((fmaf(d[1], enter, o[1]) - (float)bcy * g.rbpu) * g.vpu, py, rd[1], fy, fmy);
      fine_setup((fmaf(d[2], enter, o[2]) - (float)bcz * g.rbpu) * g.vpu, pz, rd[2], fz, fmz);
      int fax = (bft <= 1e-12f) ? entry_axis : bax;   // the entry cell's axis
      const uint32_t* __restrict__ w = v.occw + (size_t)b * 16;
      float ft = 0.0f;
      int bit = (fz * 8 + fy) * 8 + fx;
      uint32_t word = __ldg(&w[bit >> 5]);
      for (int fi = 1;; ++fi) {
        // the next cell depends only on the crossing t's: choose it and
        // request its occupancy word before this cell's test (a word of
        // this brick even where the ray leaves it: no branch)
        const bool fux = (fmx < fmy) && (fmx < fmz);
        const bool fuy = !(fmx < fmy) && (fmy < fmz);
        const int mx = fux ? fx + sx : fx, my = fuy ? fy + sy : fy,
                  mz = (!fux && !fuy) ? fz + sz : fz;
        const bool out = ((unsigned)mx | (unsigned)my | (unsigned)mz) >= 8u;
        const int mbit = (mz * 8 + my) * 8 + mx;
        const uint32_t mword = __ldg(&w[((unsigned)mbit >> 5) & 15u]);
        ++steps;                                    // this cell's test
        if ((word >> (bit & 31)) & 1u) {
          const bool hpos = fax == 0 ? px : (fax == 1 ? py : pz);
          h.t = fmaf(ft, g.rvpu, enter);
          h.mat = (int)__ldg(&v.matb[(size_t)b * 512 + bit]);
          h.ax = fax * 2 + (hpos ? 1 : 0);
          h.steps = steps;
          return h;
        }
        if (out) break;                             // leave for the brick step
        ft = fux ? fmx : (fuy ? fmy : fmz);
        fmx = fux ? fmx + dlx : fmx;
        fmy = fuy ? fmy + dly : fmy;
        fmz = (!fux && !fuy) ? fmz + dlz : fmz;
        fax = fux ? 0 : (fuy ? 1 : 2);
        fx = mx; fy = my; fz = mz; bit = mbit; word = mword;
        if (fi >= FINE_ITERS) {                     // fine cap: unresolved
          h.steps = steps;
          h.resolved = 0;
          return h;
        }
      }
    }
    // one brick step (indep.py:302-328)
    const bool ux = (btx < bty) && (btx < btz);
    const bool uy = !(btx < bty) && (bty < btz);
    const bool uz = !ux && !uy;
    bcx = ux ? bcx + sx : bcx;
    bcy = uy ? bcy + sy : bcy;
    bcz = uz ? bcz + sz : bcz;
    bft = ux ? btx : (uy ? bty : btz);
    btx = ux ? btx + dlx : btx;
    bty = uy ? bty + dly : bty;
    btz = uz ? btz + dlz : btz;
    bax = ux ? 0 : (uy ? 1 : 2);
    const bool leaves = ((unsigned)bcx >= (unsigned)nbx) | ((unsigned)bcy >= (unsigned)nby) |
                        ((unsigned)bcz >= (unsigned)nbz);
    ++steps;
    if (leaves) {                                   // left the grid: a miss
      h.steps = steps;
      return h;
    }
    b = nbi;
    bword = nbword;
    nbi = next_brick();
    nbword = bits[((unsigned)nbi >> 5) & 127u];
  }
  h.steps = steps;   // the walk ran out of iterations: unresolved
  h.resolved = 0;
  return h;
}

// Camera frame (B3): one thread per pixel, 8x32 pixel blocks, image order.
__global__ void __launch_bounds__(256, 1)
indep_camera_kernel(const float* __restrict__ cam, const float* __restrict__ pal,
                    Volume v, int width, int height, int shading, int sky_mode,
                    float ambient, int32_t* __restrict__ rgba_out,
                    float* __restrict__ t_out, int32_t* __restrict__ aux_out) {
  __shared__ float spal[256 * 3];
  __shared__ uint32_t sbits[128];
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int i = tid; i < 256 * 3; i += blockDim.x * blockDim.y) spal[i] = __ldg(&pal[i]);
  for (int k = tid; k < 128; k += blockDim.x * blockDim.y) sbits[k] = __ldg(&v.bits[k]);
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
__global__ void __launch_bounds__(RAY_THREADS, 1)
indep_rays_kernel(const float* __restrict__ orig, const float* __restrict__ dirs,
                  int n, Volume v, float* __restrict__ t_out,
                  int32_t* __restrict__ aux_out) {
  __shared__ uint32_t sbits[128];
  for (int k = threadIdx.x; k < 128; k += blockDim.x) sbits[k] = __ldg(&v.bits[k]);
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
  v.bits = reinterpret_cast<const uint32_t*>(occb);
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
  const dim3 block(8, 32);
  const dim3 grid((width + block.x - 1) / block.x, (height + block.y - 1) / block.y);
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
