// Two-level Amanatides-Woo DDA of a ray list for Hopper (sm_90a) -- D1.
//
// Replaces the XLA program of voxel_tracer_tpu/ops/dda.py:intersect_volume_local
// (jitted at dda.py:169, one lax.while_loop at :377), which the JAX
// package runs inside each frame's jit: the wavefront Renderer's traversal
// (ops/composite.py), the exact fallback of the Whitted frame
// (ops/pallas/whitted.py:233) and the kernel renderer's fallback.  It is
// not a Pallas kernel; the port ran it as a host loop of about 90 eager
// tensor operations per lock-step iteration (ops/dda.py, the plain
// version).  Here one thread walks one ray through the same state machine
// with the same float32 operations in the same order:
//
// - the slab test of dda.slab_test (NaN guard on 0 * inf, the first
//   maximum's entry axis, tmax - 1e-4 >= tmin), size = gsize / vpu;
// - the brick level and the fine level inside an occupied brick, the step
//   budget shared by both: a fine exit and the brick step it triggers are
//   one step, entering a brick is none, a brick step that leaves the grid
//   counts;
// - the medium mode (the interior exit march: the first voxel that
//   differs from the medium, an empty brick exits at its entry plane,
//   leaving the grid exits at the slab tmax, a slab miss exits at t = 0),
//   the ignore mode (pass the id until air is seen; the flag persists) and
//   the stochastic shadow mode (ids > 16 occlude, the rest with p = 0.15 by
//   hash_shadow of (seed, cell) in uint32 arithmetic);
// - stacked (O, Z, Y, X) grids selected per ray by oid, a scalar or
//   per-ray vpu, and a run-time step budget.
//
// Rounding: compiled with --fmad=false; fmaf at exactly the three places
// where XLA's CPU backend fuses a multiply-add (the brick entry point, the
// brick entry t and the fine entry point), IEEE division where the plain
// version divides (size / vpu, vpu / 8, ft / vpu) and IEEE reciprocals, so
// t, axis and steps equal the plain version's bit for bit (hash_shadow
// keys on the hit cell: one ulp of t can flip a stochastic shadow).
//
// The batch rule.  The XLA loop stops once no ray of the call is active
// within the budget, so a ray whose steps reached the budget is marked
// exhausted (a miss; with a medium, the exit at the slab tmax with the
// tmax-ladder axis) only if some other ray of the same call is still
// walking in the iteration after its last step.  Each lock-step iteration
// makes exactly one transition of each ray that is active within the
// budget, so the thread counts its transitions c; the loop ran
// L = max over the call of c iterations (at most 2 * max_steps), and a ray
// that stopped on the budget after c transitions is marked iff c < L.
// Marking changes an output only for medium rays: pass 1 (dda_kernel)
// writes the unmarked state, records c and the ladder axis of each medium
// ray that stopped on the budget, and takes the maximum of c with one
// atomicMax a warp; pass 2 (dda_exhaust_kernel), launched only with a
// medium, applies the marking.  No host sync.
//
// Tables.  The kernel reads what ops/cuda/dda.py derives once from the
// caller's int32 grid and brick counts (dda_tables, cached on the grid):
// a brick bitmap of one bit a brick (brick_occ > 0), 16 32-bit occupancy
// words a brick (grid != 0; bit z*64 + y*8 + x) and one material byte a
// voxel, brick-major.  The material is read only at a solid voxel: where
// the walk stops (a hit), and in the modes that look at the id of a solid
// voxel (shadow's id > 16, ignore's id comparison, medium's voxel != med);
// an air voxel is decided by its bit alone.  Where an id lies outside
// [0, 255] (the wrapper's device flag `wide`, no host sync) the material
// is read from the int32 grid instead, so every grid the plain DDA takes
// gives the same outputs.
//
// Bound: per ray, a chain of dependent loads (the bitmap word of each
// brick test, the occupancy word of each fine step) and the divergence of
// trip counts inside a warp; the tables are L2-resident for the scenes
// the port renders.  The design against it: each block stages the whole
// bitmap in shared memory (128 words at 128^3; up to SMEM_BITMAP_MAX_WORDS
// = 4096 words, 16 KB, above which it is read from global memory through
// __ldg), so an empty brick costs no global load; the occupancy words of
// a brick are 64 bytes in place of 2 KB of int32 grid, and its material
// bytes 512, read only at solid voxels.  The walk is a loop over bricks
// and, inside an occupied brick, a loop over its voxels (B1/B2's shape),
// each occupancy word loaded where it is tested: on the frames of the main
// path this measured faster than one loop over both levels (the parent's
// and the JAX loop's shape, which keeps every ray of a warp advancing and
// wins on walks that alternate levels for hundreds of steps, the budget
// volume's) and than the same loops with the next occupancy word
// requested ahead (tools/torch_dda_trials.py).  The state stays in
// scalar registers: each axis's state is touched only by the arm of the
// branch that commits a step on the axis the reference's comparisons
// chose (vv.cpp:176-202).
//
// A second entry, the candidate race of a stacked group (vt_dda_race):
// the K candidate passes of ops/composite.py over the top-K prepass's
// slots, each a full-width launch of pass 1 between a C1 to_local and a
// C1 record launch, and the merge after them, as one launch.  One thread
// walks, one after another, only its ray's live slots, each carried to
// its object's local space by csrc/composite.cuh's to_local; the walk is
// pass 1's (walk_ray takes the ray in registers and hands its outputs to
// a sink: pass 1's rows, or the race's registers), so the race equals the
// K passes bit for bit.  It is an overload of dda_kernel, so the profiler
// counts its time as D1's: it walks the very traversals D1's roofline
// charges.
//
// Launchers are extern "C", run on the caller's stream, allocate nothing,
// and return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "composite.cuh"   // the race's to_local, normal_albedo, TOPK_MAX

// The launch arguments; ops/cuda/dda.py mirrors the layout (_Args).  Outside
// the anonymous namespace: vt_dda takes it, and a parameter type of internal
// linkage would give the launcher internal linkage too.
struct DdaArgs {
  const float* orig;          // (N, 3) local origins
  const float* dirs;          // (N, 3) local directions
  const uint32_t* bits;       // (nwords,) brick bitmap: bit g & 31 of word g >> 5,
                              // g = obj * NB + (bz * BY + by) * BX + bx
  const uint32_t* occw;       // (O * NB, 16) occupancy words, bit z*64 + y*8 + x
  const uint8_t* matb;        // (O * NB, 512) material bytes, same index
  const int32_t* grid;        // (O, Z, Y, X) int32 ids, read at solid voxels
                              // when *wide (may be null otherwise)
  const int32_t* wide;        // device flag: some id lies outside [0, 255]
  const float* vpu_ray;       // per-ray vpu (stride 1), a device scalar
                              // (stride 0), or null: the vpu field
  const int64_t* oid;         // (N,) object per ray, or null
  const int32_t* medium;      // (N,) medium id (0 = none), or null
  const int32_t* ignore;      // (N,) id passed until air, or null
  const int64_t* seed;        // (N,) uint32 shadow seeds, or null
  float* t;                   // outputs, (N,) unless noted
  float* slab_tmin;
  float* slab_tmax;
  float* step_sign;           // (N, 3)
  int32_t* mat;
  int32_t* axis;
  int32_t* steps;
  int32_t* entry_axis;
  uint8_t* valid;
  uint8_t* resolved;
  int32_t* pend;              // medium: c * 4 + ladder axis of a ray that
                              // stopped on the budget, else -1
  int32_t* maxc;              // medium: max transitions over the call
  int n;
  int gx, gy, gz;
  int bx, by, bz;
  int nwords;                 // bitmap words
  int global_bits;            // 1: read the bitmap from global memory
  int vpu_stride;
  int max_steps;
  int shadow;
  float vpu;
};

// The candidate race's arguments; ops/cuda/dda.py mirrors the layout
// (_RaceArgs).  D1's tables, modes (ignore, seed, shadow) and budget come
// in ``d``, whose ray, vpu, oid, medium and output pointers are unused.
struct RaceArgs {
  DdaArgs d;
  const float* orig;          // (N, 3) world origins, row stride orig_row
  const float* dirs;          // (N, 3) world directions, row stride dirs_row
  const float* rot;           // (O, 3, 3) the group's rotations
  const float* pos;           // (O, 3)
  const float* pivot;         // (O, 3)
  const float* vpu;           // (O,)
  const float* palette;       // (O, 256, 3)
  const float* cand_t;        // (N, K) the prepass's slab entry t, nearest first
  const int32_t* cand_id;     // (N, K) the prepass's objects
  float* rt;                  // the running record, (N,) unless noted; read
  int32_t* rmat;              // unless fresh
  float* rnormal;             // (N, 3)
  float* ralbedo;             // (N, 3)
  int32_t* rsteps;
  int32_t* robj;
  int32_t* walked;            // (N,) slots walked, or null
  int n;
  int k;                      // 1..TOPK_MAX
  int orig_row;               // 3, or 0 (one vector broadcast to every ray)
  int dirs_row;
  int obj_base;
  int fresh;                  // 1: the running record is the miss record
};

namespace {

constexpr float BIG_F32 = 1e30f;   // miss depth and clamp (math3d.py BIG_F32)
constexpr int BRICK = 8;
constexpr int THREADS = 128;
// Largest bitmap staged in shared memory (16 KB: 131,072 bricks, a 1024^3
// grid); a larger one is read from global memory.
constexpr int SMEM_BITMAP_MAX_WORDS = 4096;

enum Mode { MODE_MISS = 0, MODE_BRICK = 1, MODE_FINE = 2, MODE_HIT = 3 };

extern __shared__ uint32_t sbits[];

// Axis of the next Amanatides-Woo step in the reference comparison order
// (vv.cpp:176-202); also the medium's grid-exit ladder (vv.cpp:208-219).
__device__ __forceinline__ int aw_axis(float tx, float ty, float tz) {
  const bool use_x = (tx < ty) && (tx < tz);
  const bool use_y = !(tx < ty) && (ty < tz);
  return use_x ? 0 : (use_y ? 1 : 2);
}

// First cell and crossing t of one axis of a DDA level (dda._cell_setup).
__device__ __forceinline__ void cell_setup(float e, bool pos, float rdir, int hi,
                                           int& cell, float& tm) {
  int c = (int)floorf(e);
  c = min(max(c, 0), hi);
  float v = (((float)c - e) + (pos ? 1.0f : 0.0f)) * rdir;
  if (isnan(v)) v = BIG_F32;
  cell = c;
  tm = fminf(v, BIG_F32);
}

// One axis of the slab test against [0, size] (dda.slab_test): the NaN
// guard maps 0 * inf on a slab plane to -BIG / +BIG; the first maximum of
// [0, tn_x, tn_y, tn_z] names the entry axis.
__device__ __forceinline__ void slab_axis(float o, float d, float size, int a,
                                          float& tmin, float& tmax, int& entry_arg) {
  const float rcp = 1.0f / d;
  const float t1 = (0.0f - o) * rcp;
  const float t2 = (size - o) * rcp;
  const bool nan = isnan(t1) || isnan(t2);
  const float tn = nan ? -BIG_F32 : fminf(t1, t2);
  const float tf = nan ? BIG_F32 : fmaxf(t1, t2);
  if (tn > tmin) {
    tmin = tn;
    entry_arg = a + 1;
  }
  tmax = (a == 0) ? tf : fminf(tmax, tf);
}

// The step of one axis's crossing t: |1 / d| clamped at BIG (torch.clamp:
// NaN stays NaN).
__device__ __forceinline__ float delta(float r) {
  return isnan(r) ? r : fminf(fabsf(r), BIG_F32);
}

// dda.hash_shadow before its float conversion: lowbias32-style avalanche
// of (seed, cell) in uint32 arithmetic.
__device__ __forceinline__ uint32_t hash_shadow(uint32_t seed, int x, int y, int z) {
  uint32_t h = seed ^ ((uint32_t)x * 0x9E3779B1u) ^ ((uint32_t)y * 0x85EBCA77u) ^
               ((uint32_t)z * 0xC2B2AE3Du);
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  h *= 0x846CA68Bu;
  h ^= h >> 16;
  return h;
}

// Whether brick g (over all objects) is occupied: its bitmap bit, from the
// block's shared copy or through the read-only path.
template <bool SMEM>
__device__ __forceinline__ bool brick_bit(const DdaArgs& a, int64_t g) {
  const uint32_t w = SMEM ? sbits[g >> 5] : __ldg(&a.bits[g >> 5]);
  return (w >> (g & 31)) & 1u;
}

// One ray as the walk takes it, in registers: its local origin and
// direction, its vpu and its object of the stacked grids, oid[i] where
// oid is set (read where the walk first needs it: read with the ray, it
// costs pass 1 two registers), else obj.
struct Ray {
  float ox, oy, oz, dx, dy, dz;
  float vpu;
  const int64_t* oid;
  int64_t obj;
};

// Pass 1's ray i: read from D1's inputs.
__device__ __forceinline__ Ray ray_at(const DdaArgs& a, int i) {
  Ray r;
  r.ox = __ldg(&a.orig[3 * i]);
  r.oy = __ldg(&a.orig[3 * i + 1]);
  r.oz = __ldg(&a.orig[3 * i + 2]);
  r.dx = __ldg(&a.dirs[3 * i]);
  r.dy = __ldg(&a.dirs[3 * i + 1]);
  r.dz = __ldg(&a.dirs[3 * i + 2]);
  r.vpu = a.vpu_ray != nullptr ? __ldg(&a.vpu_ray[(size_t)i * a.vpu_stride]) : a.vpu;
  r.oid = a.oid;
  r.obj = 0;
  return r;
}

// Where pass 1 puts a walk: D1's output rows.
struct RowOut {
  const DdaArgs& a;
  int i;
  __device__ __forceinline__ void slab(float tmin, float tmax, int entry_axis, bool valid,
                                       bool px, bool py, bool pz) const {
    a.slab_tmin[i] = tmin;
    a.slab_tmax[i] = tmax;
    a.entry_axis[i] = entry_axis;
    a.valid[i] = valid;
    a.step_sign[3 * i] = px ? 1.0f : -1.0f;
    a.step_sign[3 * i + 1] = py ? 1.0f : -1.0f;
    a.step_sign[3 * i + 2] = pz ? 1.0f : -1.0f;
  }
  __device__ __forceinline__ void end(float t, int mat, int axis, int steps,
                                      bool resolved) const {
    a.t[i] = t;
    a.mat[i] = mat;
    a.axis[i] = axis;
    a.steps[i] = steps;
    a.resolved[i] = resolved;
  }
};

// Where the race puts a walk: registers, of the outputs it reads.
struct RegOut {
  float t;
  int mat, axis, steps;
  __device__ __forceinline__ void slab(float, float, int, bool, bool, bool, bool) const {}
  __device__ __forceinline__ void end(float t_, int mat_, int axis_, int steps_, bool) {
    t = t_;
    mat = mat_;
    axis = axis_;
    steps = steps_;
  }
};

// Walks ``ray`` (row i of the per-ray modes) to its end; hands its outputs
// to ``out`` (all but the batch rule's) and returns the transitions made.
// One transition is one iteration of the JAX loop: entering an occupied
// brick, a fine test (a hit or a step), or a brick step (an empty
// brick's, or a fine exit's in the same iteration).
template <bool SMEM, class Out>
__device__ __forceinline__ int walk_ray(const DdaArgs& a, int i, const Ray& ray, Out& out) {
  const float ox = ray.ox, oy = ray.oy, oz = ray.oz;
  const float dx = ray.dx, dy = ray.dy, dz = ray.dz;
  const float vpu = ray.vpu;

  // ---- slab test --------------------------------------------------------
  float tmin = 0.0f, tmax = 0.0f;
  int entry_arg = 0;
  slab_axis(ox, dx, (float)a.gx / vpu, 0, tmin, tmax, entry_arg);
  slab_axis(oy, dy, (float)a.gy / vpu, 1, tmin, tmax, entry_arg);
  slab_axis(oz, dz, (float)a.gz / vpu, 2, tmin, tmax, entry_arg);
  const bool valid = tmax - 1e-4f >= tmin;
  const int entry_axis = max(entry_arg - 1, 0);

  // ---- constants of both levels and the brick level's start -------------
  const float bpu = vpu / 8.0f;
  const float rbpu = 1.0f / bpu;
  const bool px = !signbit(dx), py = !signbit(dy), pz = !signbit(dz);
  const int sx = px ? 1 : -1, sy = py ? 1 : -1, sz = pz ? 1 : -1;
  const float rx = 1.0f / dx, ry = 1.0f / dy, rz = 1.0f / dz;
  // clamp inf (axis-parallel rays) so tmax += delta never meets 0 * inf;
  // a NaN direction keeps its NaN delta, as the plain version's clamp does
  // (fminf would drop it)
  const float dlx = delta(rx), dly = delta(ry), dlz = delta(rz);
  int bcx, bcy, bcz;
  float btx, bty, btz;
  cell_setup(fmaf(dx, tmin, ox) * bpu, px, rx, a.bx - 1, bcx, btx);
  cell_setup(fmaf(dy, tmin, oy) * bpu, py, ry, a.by - 1, bcy, bty);
  cell_setup(fmaf(dz, tmin, oz) * bpu, pz, rz, a.bz - 1, bcz, btz);

  out.slab(tmin, tmax, entry_axis, valid, px, py, pz);

  // ---- per-ray modes ----------------------------------------------------
  const int64_t obj =
      ray.oid != nullptr ? (int64_t)__ldg((const long long*)&ray.oid[i]) : ray.obj;
  const int64_t bbase = obj * ((int64_t)a.bz * a.by * a.bx);   // the object's first brick
  const uint32_t* occw = a.occw + bbase * 16;
  const uint8_t* matb = a.matb + bbase * 512;
  const bool wide = __ldg(a.wide) != 0;
  const int32_t* grid = wide ? a.grid + obj * ((int64_t)a.gz * a.gy * a.gx) : nullptr;
  const int med = a.medium != nullptr ? __ldg(&a.medium[i]) : 0;
  const bool med_on = med > 0;
  const bool has_ignore = a.ignore != nullptr;
  const int ign = has_ignore ? __ldg(&a.ignore[i]) : 0;
  const uint32_t seed =
      a.shadow ? (uint32_t)__ldg((const long long*)&a.seed[i]) : 0u;

  int mode = valid ? MODE_BRICK : MODE_MISS;
  float hit_t = BIG_F32;
  if (!valid && med_on) {     // a slab miss inside a medium exits at t = 0
    mode = MODE_HIT;
    hit_t = 0.0f;
  }
  float bt = 0.0f;            // t of the last brick step, brick units
  int axis = entry_axis, steps = 0, hit_mat = 0;
  bool hit_entry = false, exited = false, pending = false;
  const int max_steps = a.max_steps;
  const int cap = 2 * max_steps;
  int c = 0;                  // transitions: iterations the ray was active in

  // A loop over bricks and, inside an occupied brick, a loop over its
  // voxels; the transitions and the step budget are the JAX loop's.
  while (mode == MODE_BRICK) {
    if (steps >= max_steps) {   // out of budget: the batch rule decides
      pending = true;
      break;
    }
    if (c >= cap) break;
    ++c;
    const int b = (bcz * a.by + bcy) * a.bx + bcx;
    if (brick_bit<SMEM>(a, bbase + b)) {
      // enter the occupied brick (vv.cpp:237-251): no step
      const float bet = fmaf(bt, rbpu, tmin);
      int fx, fy, fz;
      float fmx, fmy, fmz;
      cell_setup(fmaf(-(float)bcx, rbpu, fmaf(dx, bet, ox)) * vpu, px, rx,
                 BRICK - 1, fx, fmx);
      cell_setup(fmaf(-(float)bcy, rbpu, fmaf(dy, bet, oy)) * vpu, py, ry,
                 BRICK - 1, fy, fmy);
      cell_setup(fmaf(-(float)bcz, rbpu, fmaf(dz, bet, oz)) * vpu, pz, rz,
                 BRICK - 1, fz, fmz);
      const uint32_t* w = occw + (size_t)b * 16;
      const uint8_t* mb = matb + (size_t)b * 512;
      float ft = 0.0f;        // t of the last fine step, voxel units
      int bit = (fz * BRICK + fy) * BRICK + fx;
      mode = MODE_FINE;
      for (;;) {
        if (steps >= max_steps) {
          pending = true;
          break;
        }
        if (c >= cap) break;
        ++c;
        // the next cell depends only on the crossing t's: chosen with
        // selects (vv.cpp:176-202 comparison order) before this cell's test
        const bool ux = (fmx < fmy) && (fmx < fmz);
        const bool uy = !(fmx < fmy) && (fmy < fmz);
        const int nx = ux ? fx + sx : fx, ny = uy ? fy + sy : fy,
                  nz = (!ux && !uy) ? fz + sz : fz;
        const bool leaves = ((unsigned)nx | (unsigned)ny | (unsigned)nz) >= (unsigned)BRICK;
        // an air voxel is decided by its occupancy bit; a solid one reads
        // its id
        const bool solid = (__ldg(&w[bit >> 5]) >> (bit & 31)) & 1u;
        int voxel = 0;
        if (solid) {
          voxel = wide ? __ldg(&grid[((int64_t)(bcz * BRICK + fz) * a.gy +
                                      (bcy * BRICK + fy)) * a.gx + (bcx * BRICK + fx)])
                       : (int)__ldg(&mb[bit]);
        }
        bool hv;
        if (a.shadow) {
          hv = solid && (voxel > 16 ||
                         (float)hash_shadow(seed, bcx * BRICK + fx, bcy * BRICK + fy,
                                            bcz * BRICK + fz) *
                                 2.3283064365386963e-10f > 0.85f);
        } else if (has_ignore) {
          hv = solid && (exited || voxel != ign);
        } else {
          hv = solid;
        }
        if (med_on) hv = voxel != med;   // the first voxel unlike the medium
        if (hv) {
          mode = MODE_HIT;
          hit_t = bet + ft / vpu;
          hit_mat = voxel;
          hit_entry = steps == 0;
          break;
        }
        if (ign > 0 && !solid) exited = true;
        // leaving the brick discards the fine step: the brick step below
        // takes its place in the same iteration
        if (leaves) {
          mode = MODE_BRICK;
          break;
        }
        if (ux) { ft = fmx; fmx = fmx + dlx; axis = 0; }
        else if (uy) { ft = fmy; fmy = fmy + dly; axis = 1; }
        else { ft = fmz; fmz = fmz + dlz; axis = 2; }
        fx = nx; fy = ny; fz = nz;
        bit = (nz * BRICK + ny) * BRICK + nx;
        ++steps;
      }
      if (mode != MODE_BRICK) break;   // a hit, or the walk stopped in the brick
    } else {
      if (med_on) {           // an empty brick exits at its entry plane
        mode = MODE_HIT;
        hit_t = fmaf(bt, rbpu, tmin);
        hit_mat = 0;
        hit_entry = steps == 0;
        break;
      }
      if (ign > 0) exited = true;   // an empty brick is air
    }
    // one brick step: an empty brick, or a fine exit in the same iteration
    const int k = aw_axis(btx, bty, btz);
    bool oob;
    if (k == 0) {
      bcx += sx; bt = btx; btx = btx + dlx;
      oob = (unsigned)bcx >= (unsigned)a.bx;
    } else if (k == 1) {
      bcy += sy; bt = bty; bty = bty + dly;
      oob = (unsigned)bcy >= (unsigned)a.by;
    } else {
      bcz += sz; bt = btz; btz = btz + dlz;
      oob = (unsigned)bcz >= (unsigned)a.bz;
    }
    axis = k;
    ++steps;
    if (oob) {
      if (med_on) {           // the interior grid exit at the slab tmax
        mode = MODE_HIT;
        hit_t = tmax;
        hit_mat = 0;
      } else {
        mode = MODE_MISS;
      }
    }
  }

  const bool hit = mode == MODE_HIT;
  // entry-voxel hits keep the slab entry axis (vv.cpp:159); a ray still
  // walking, or stopped on the budget, is unresolved whether or not the
  // batch rule marks it
  out.end(hit ? hit_t : BIG_F32, hit ? hit_mat : 0, hit_entry ? entry_axis : axis, steps,
          !(mode == MODE_BRICK || mode == MODE_FINE));
  if (a.pend != nullptr)
    a.pend[i] = (pending && med_on) ? c * 4 + aw_axis(btx, bty, btz) : -1;
  return c;
}

// Pass 1.  SMEM: the block first stages the brick bitmap in shared memory
// (a template argument: a run-time flag tested at every brick measured 2-3 %
// slower on the main path's frames, tools/torch_dda_trials.py's smem_flag).
template <bool SMEM>
__global__ void __launch_bounds__(THREADS) dda_kernel(const DdaArgs a) {
  if (SMEM) {
    for (int k = threadIdx.x; k < a.nwords; k += THREADS) sbits[k] = __ldg(&a.bits[k]);
    __syncthreads();
  }
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  int c = 0;
  if (i < a.n) {
    RowOut out{a, i};
    c = walk_ray<SMEM>(a, i, ray_at(a, i), out);
  }
  if (a.maxc != nullptr) {
    const int m = __reduce_max_sync(0xffffffffu, c);
    if ((threadIdx.x & 31) == 0 && m > 0) atomicMax(a.maxc, m);
  }
}

// The batch rule's marking: a medium ray that stopped on the budget after
// c transitions exits at the slab tmax with the ladder axis iff the loop
// ran past it (c < L).
__global__ void __launch_bounds__(THREADS) dda_exhaust_kernel(const DdaArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const int p = a.pend[i];
  if (p < 0) return;
  const int loop = min(*a.maxc, 2 * a.max_steps);
  if ((p >> 2) < loop) {
    a.t[i] = a.slab_tmax[i];
    a.mat[i] = 0;
    a.axis[i] = p & 3;
  }
}

// The candidate race of a stacked group: ops/composite._race_slots' K
// passes (each a C1 to_local launch, pass 1 over every row and a C1
// record launch with the slot's live mask) and its final
// HitResult.nearer, one ray a thread.  The race starts from the miss
// record; slot s is live iff its slab entry t beats 1e30 and the race's
// t so far; a live slot's ray goes to its object's local space
// (to_local), is walked, and is folded into the race as
// composite_record_kernel folds a live row (a strict win takes it, steps
// add); a dead slot is not walked and adds nothing.  The winner's normal
// and albedo are normal_albedo's, computed once at the end.  Candidate
// rays carry no medium, so the batch rule changes no output and each ray
// is walked alone.  The race is then merged into the running record in
// place (a strict win, steps add) or written fresh.
template <bool SMEM>
__global__ void __launch_bounds__(THREADS) dda_kernel(const RaceArgs r) {
  if (SMEM) {
    for (int k = threadIdx.x; k < r.d.nwords; k += THREADS) sbits[k] = __ldg(&r.d.bits[k]);
    __syncthreads();
  }
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= r.n) return;
  const float* po = r.orig + (size_t)r.orig_row * i;
  const float* pd = r.dirs + (size_t)r.dirs_row * i;
  const float wo[3] = {po[0], po[1], po[2]};
  const float wd[3] = {pd[0], pd[1], pd[2]};
  float race_t = BIG_F32;
  int race_steps = 0, walked = 0;
  int win = -1, win_mat = 0, win_axis = 0;   // the winner's object (-1: none)
  float win_s = 0.0f;                        // its -step_sign on win_axis
  for (int s = 0; s < r.k; ++s) {
    const float ct = __ldg(&r.cand_t[(size_t)r.k * i + s]);
    if (!(ct < BIG_F32 && ct < race_t)) continue;   // race_t is 1e30 before a hit
    const int o = __ldg(&r.cand_id[(size_t)r.k * i + s]);
    float lo[3], ld[3];
    to_local(r.rot, r.pos, r.pivot, wo, wd, o, lo, ld);
    const Ray ray{lo[0], lo[1], lo[2], ld[0], ld[1], ld[2], __ldg(&r.vpu[o]), nullptr, o};
    RegOut h;
    walk_ray<SMEM>(r.d, i, ray, h);
    ++walked;
    race_steps += h.steps;
    if (h.t < race_t) {                      // a miss (1e30) never wins
      const int ax = min(max(h.axis, 0), 2);
      const float d = ax == 0 ? ld[0] : (ax == 1 ? ld[1] : ld[2]);
      race_t = h.t;
      win = o;
      win_mat = h.mat;
      win_axis = ax;
      win_s = signbit(d) ? 1.0f : -1.0f;
    }
  }
  if (r.walked != nullptr) r.walked[i] = walked;
  float nv[3] = {0.0f, 0.0f, 0.0f}, av[3] = {0.0f, 0.0f, 0.0f};
  if (win >= 0) normal_albedo(r.rot, r.palette, win, win_axis, win_s, win_mat, nv, av);
  if (!r.fresh) {
    r.rsteps[i] += race_steps;
    if (!(race_t < r.rt[i])) return;
  } else {
    r.rsteps[i] = race_steps;
  }
  r.rt[i] = race_t;
  r.rmat[i] = win_mat;
  r.robj[i] = win >= 0 ? r.obj_base + win : -1;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    r.rnormal[3 * i + k] = nv[k];
    r.ralbedo[3 * i + k] = av[k];
  }
}

}  // namespace

// One call: pass 1 (the bitmap in shared memory unless it is larger than
// SMEM_BITMAP_MAX_WORDS or global_bits is set), and with a medium (pend
// and maxc set) the zeroed maximum and pass 2, all on ``stream``.
extern "C" int vt_dda(const DdaArgs* args, cudaStream_t stream) {
  const DdaArgs a = *args;
  const int blocks = (a.n + THREADS - 1) / THREADS;
  if (a.maxc != nullptr) {
    const cudaError_t e = cudaMemsetAsync(a.maxc, 0, sizeof(int32_t), stream);
    if (e != cudaSuccess) return (int)e;
  }
  const bool smem = !a.global_bits && a.nwords <= SMEM_BITMAP_MAX_WORDS;
  if (smem)
    dda_kernel<true><<<blocks, THREADS, (size_t)a.nwords * 4, stream>>>(a);
  else
    dda_kernel<false><<<blocks, THREADS, 0, stream>>>(a);
  if (a.maxc != nullptr) {
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    dda_exhaust_kernel<<<blocks, THREADS, 0, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

// One candidate race, on ``stream``: the bitmap in shared memory as pass 1
// stages it.
extern "C" int vt_dda_race(const RaceArgs* args, cudaStream_t stream) {
  const RaceArgs r = *args;
  const DdaArgs& a = r.d;
  if (r.k < 1 || r.k > TOPK_MAX) return (int)cudaErrorInvalidValue;
  const int blocks = (r.n + THREADS - 1) / THREADS;
  const bool smem = !a.global_bits && a.nwords <= SMEM_BITMAP_MAX_WORDS;
  if (smem)
    dda_kernel<true><<<blocks, THREADS, (size_t)a.nwords * 4, stream>>>(r);
  else
    dda_kernel<false><<<blocks, THREADS, 0, stream>>>(r);
  return (int)cudaGetLastError();
}

extern "C" const char* vt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
