// Coherent-kernel first-hit tracer for Hopper (sm_90a) -- B5.
//
// Replaces the Pallas TPU kernel built by
// voxel_tracer_tpu/ops/pallas/coherent.py:_make_kernel, launched by
// trace_coherent (coherent.py:444).  It computes what that kernel computes
// -- slab entry, the first solid voxel of an 8^3-brick grid, its flat index,
// axis and sign, and the fine steps taken -- but not with its block
// structure: the TPU kernel marches a 1024-ray tile through brick slices
// along the tile's major axis and walks each slice's rect of bricks as
// scalars, because its vector unit has no cheap per-lane gather, and so
// leaves rays that fight the major axis or overflow the rect unresolved.
// Here one thread walks one ray's bricks in t order and applies the TPU
// kernel's per-brick arithmetic (coherent.py:241-356) to every occupied
// brick it crosses: brick-AABB slab test, tf - 1e-5 >= enter, fine entry
// clipped to [0, 7], first-cell axis, at most 24 fine steps.  The first
// hit ends the ray.  There are no fighting rays and no rect budget, so a
// ray is unresolved only if a fine walk ran 24 steps or the brick walk ran
// nb_x + nb_y + nb_z + 2 bricks without a hit or an exit, which a
// well-formed ray cannot do.
//
// Loop shape: an outer brick walk and, inside each occupied brick that the
// ray crosses, a fine walk.  Each brick's [tn, tf] comes from its own
// planes, and the walk steps across the nearest exit plane; the fine walk
// steps across the nearest cell plane.  The per-axis state (brick, planes,
// cell, crossing t's) is indexed only by unrolled loops and by the arms of
// the branch that commits a step on the axis the reference's comparisons
// chose (vv.cpp:176-202), and the stepped axis's grid size comes from the
// same branch, so the whole state stays in registers: ptxas reports a
// 0-byte stack frame.  A warp of camera rays steps mostly along one axis,
// so the branch costs less than committing all three axes with selects.
// The brick occupancy is a bitmap (bit b & 31 of word b >> 5, built once
// per volume beside the flags: 4 KB for the 256^3 crate grid, not 128 KB
// of int32 flags), read with the occupancy words through the read-only
// path, L1- and L2-resident; each word is loaded where it is tested.
// tools/torch_coherent_trials.py keeps the alternatives it measured: the
// kernel's first port and its launcher, the int32 flags, the bitmap
// staged in each block's shared memory, both levels requesting their next
// word ahead of the test, the steps committed with selects (with both
// requests ahead), other block shapes and launch bounds; each was as fast
// or slower on the lists of chip_smoke.py.
//
// Bound: bytes where the rays barely walk (each ray reads 24 bytes and
// writes 17: t, vox, ax, steps and a one-byte resolved flag); elsewhere
// the chain of dependent loads of the walk (one bitmap word a brick step,
// one occupancy word a fine step) and the divergence of loop trip counts
// inside a warp.  Blocks of 128 rays in the caller's order (32x32-pixel
// tiles for camera rays): neighbouring rays cross the same bricks, so
// their loads share cache lines.  At most 64 registers a thread: with
// launch bounds of the thread count alone ptxas keeps 48 registers and
// spills 8 bytes; held to 64 it keeps 54 and spills nothing.
//
// Rounding: compiled with --fmad=false; fmaf at exactly the three places
// where XLA's CPU backend contracts the JAX kernel under jit (the entry
// point of the brick walk, the fine entry point, and t = enter + ft / vpu,
// which XLA turns into a multiply by 1/vpu and fuses); the plain PyTorch
// version (ops/cuda/coherent.py) does the same float32 operations in the
// same order, so t, vox, ax, steps and resolved are equal.
//
// Launchers are extern "C", run on the caller's stream, allocate nothing,
// and return cudaGetLastError().

#include "brick_walk.cuh"

namespace {

using walk::aw_axis;
using walk::BIG;
using walk::FINE_ITERS;
using walk::fine_setup;
using walk::Geo;

constexpr int THREADS = 128;
constexpr int MAX_REGS = 64;

struct Volume {
  const uint32_t* bits;    // brick bitmap, nwords words (a multiple of 4)
  const int32_t* occ;      // (NB,) brick flags (read by a design trial)
  const uint32_t* words;   // (NB, 16) occupancy bits, bit = z*64 + y*8 + x
  Geo g;
  int nwords;              // (read by a design trial)
};

struct Hit {
  float t;        // BIG on a miss
  int vox;        // flat voxel index of the brick-padded grid; -1 on a miss
  int ax;         // axis*2 + (step sign > 0); entry axis*4 on a miss
  int steps;      // fine cells tested
  bool resolved;
};

// Whether brick b holds a solid voxel.
__device__ __forceinline__ bool brick_occupied(const Volume& v, int b) {
  return (__ldg(&v.bits[b >> 5]) >> (b & 31)) & 1u;
}

// First hit of one ray that enters the volume (valid slab: tmin, tmax,
// entry_axis, rd), coherent.py:168-356 for one lane.
__device__ __forceinline__ Hit coherent_ray(const float o[3], const float d[3],
                                            const float rd[3], float tmin, float tmax,
                                            int entry_axis, const Volume& v) {
  const Geo& g = v.g;
  Hit h = {BIG, -1, entry_axis * 4, 0, true};        // coherent.py:168
  int sgn[3], c[3];
  float dl[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    sgn[a] = signbit(d[a]) ? -1 : 1;
    dl[a] = fminf(fabsf(rd[a]), BIG);
    // first brick: the one holding the slab entry point
    const float fb = floorf(fmaf(d[a], tmin, o[a]) * g.bpu);
    c[a] = (int)fminf(fmaxf(fb, 0.0f), (float)(g.nb[a] - 1));
  }
  int steps = 0;
  const int max_bricks = g.nb[0] + g.nb[1] + g.nb[2] + 2;
  for (int it = 0; it < max_bricks; ++it) {
    // ---- brick-AABB slab test (coherent.py:241-261) -----------------------
    float b0[3], hi[3];
    float tn = 0.0f, tf = BIG;
    int b_ax = 0;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      b0[a] = (float)c[a] * g.rbpu;
      float lo;
      walk::slab((b0[a] - o[a]) * rd[a], ((b0[a] + g.rbpu) - o[a]) * rd[a], lo, hi[a]);
      if (lo > tn) b_ax = a;
      tn = fmaxf(tn, lo);
      tf = fminf(tf, hi[a]);
    }
    const float enter = fmaxf(tn, tmin);
    const int b = (c[2] * g.nb[1] + c[1]) * g.nb[0] + c[0];
    if (brick_occupied(v, b) && tf - 1e-5f >= enter) {
      // ---- fine walk of the occupied brick (coherent.py:265-356) ----------
      const uint32_t* __restrict__ w = v.words + (size_t)b * 16;
      int cell[3];
      float tm[3];
      // the fine entry point fuses o + d * enter, as XLA does (vv.cpp:237-251)
#pragma unroll
      for (int a = 0; a < 3; ++a)
        fine_setup((fmaf(d[a], enter, o[a]) - b0[a]) * g.vpu, sgn[a] > 0, rd[a],
                   cell[a], tm[a]);
      int ax = (enter <= tmin + 1e-12f) ? entry_axis : b_ax;   // the entry cell's axis
      float ft = 0.0f;
      for (int fi = 1;; ++fi) {
        const int bit = cell[2] * 64 + cell[1] * 8 + cell[0];
        ++steps;
        if ((__ldg(&w[bit >> 5]) >> (bit & 31)) & 1u) {
          const int s = ax == 0 ? sgn[0] : (ax == 1 ? sgn[1] : sgn[2]);
          h.t = fmaf(ft, g.rvpu, enter);
          h.vox = ((c[2] * 8 + cell[2]) * (g.nb[1] * 8) + (c[1] * 8 + cell[1])) *
                      (g.nb[0] * 8) + (c[0] * 8 + cell[0]);
          h.ax = ax * 2 + (s > 0 ? 1 : 0);
          h.steps = steps;
          return h;
        }
        const int a = aw_axis(tm);
        int moved;
        if (a == 0) {
          cell[0] += sgn[0]; ft = tm[0]; tm[0] = tm[0] + dl[0]; moved = cell[0];
        } else if (a == 1) {
          cell[1] += sgn[1]; ft = tm[1]; tm[1] = tm[1] + dl[1]; moved = cell[1];
        } else {
          cell[2] += sgn[2]; ft = tm[2]; tm[2] = tm[2] + dl[2]; moved = cell[2];
        }
        ax = a;
        if (moved < 0 || moved > 7) break;            // on to the brick step
        if (fi >= FINE_ITERS) {                       // fine cap: unresolved
          h.steps = steps;
          h.resolved = false;
          return h;
        }
      }
    }
    // ---- brick step across the nearest exit plane -------------------------
    const int a = aw_axis(hi);
    int moved, size;
    float t_exit;
    if (a == 0) {
      c[0] += sgn[0]; moved = c[0]; size = g.nb[0]; t_exit = hi[0];
    } else if (a == 1) {
      c[1] += sgn[1]; moved = c[1]; size = g.nb[1]; t_exit = hi[1];
    } else {
      c[2] += sgn[2]; moved = c[2]; size = g.nb[2]; t_exit = hi[2];
    }
    if (!(t_exit < tmax) || moved < 0 || moved >= size) {   // left: a miss
      h.steps = steps;
      return h;
    }
  }
  h.steps = steps;   // the walk ran out of bricks: unresolved
  h.resolved = false;
  return h;
}

// One thread per ray, (N, 3) float32 origins and directions in the
// volume's local frame.
__global__ void __maxnreg__(MAX_REGS)
coherent_kernel(Volume v, const float* __restrict__ orig, const float* __restrict__ dirs,
                int n, float* __restrict__ t_out, int32_t* __restrict__ vox_out,
                int32_t* __restrict__ ax_out, int32_t* __restrict__ steps_out,
                uint8_t* __restrict__ res_out) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const size_t r3 = 3 * (size_t)i;
  const float o[3] = {__ldg(&orig[r3]), __ldg(&orig[r3 + 1]), __ldg(&orig[r3 + 2])};
  const float d[3] = {__ldg(&dirs[r3]), __ldg(&dirs[r3 + 1]), __ldg(&dirs[r3 + 2])};
  float rd[3], tmin, tmax;
  int entry_axis;
  Hit h = {BIG, -1, 0, 0, true};
  if (walk::volume_slab(o, d, v.g, rd, tmin, tmax, entry_axis))
    h = coherent_ray(o, d, rd, tmin, tmax, entry_axis, v);
  else
    h.ax = entry_axis * 4;
  t_out[i] = h.t;
  vox_out[i] = h.vox;
  ax_out[i] = h.ax;
  steps_out[i] = h.steps;
  res_out[i] = h.resolved ? 1 : 0;
}

}  // namespace

// A volume's launch arguments, built once by the caller (the layout of
// ops/cuda/coherent.py:_Params).
struct CoherentParams {
  const uint32_t* bits;    // brick bitmap, nwords words (a multiple of 4)
  const int32_t* occ;      // (NB,) brick flags (read by a design trial)
  const uint32_t* words;   // (NB, 16) occupancy bits
  int nb[3];               // bricks (BX, BY, BZ)
  float geo[7];            // see walk::make_geo
  int nwords;              // (read by a design trial)
  int device;              // CUDA device of the tables
};

// out: (4, n) int32 rows t (float32 bits), vox, ax, steps; resolved: (n,)
// bytes, 0 or 1 (a torch.bool tensor).  Launches on p->device.
extern "C" int vt_coherent(const CoherentParams* p, const float* orig, const float* dirs,
                           int n, int32_t* out, uint8_t* resolved, cudaStream_t stream) {
  int prev = p->device;
  cudaGetDevice(&prev);
  if (prev != p->device) cudaSetDevice(p->device);
  Volume v;
  v.bits = p->bits;
  v.occ = p->occ;
  v.words = p->words;
  v.g = walk::make_geo(p->nb, p->geo);
  v.nwords = p->nwords;
  const size_t m = (size_t)n;
  coherent_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
      v, orig, dirs, n, reinterpret_cast<float*>(out), out + m, out + 2 * m, out + 3 * m,
      resolved);
  const int err = (int)cudaGetLastError();
  if (prev != p->device) cudaSetDevice(prev);
  return err;
}

extern "C" const char* vt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
