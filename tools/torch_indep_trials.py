#!/usr/bin/env python3
"""Design trials of the port's indep kernels B3 / B4
(`voxel_tracer_tpu_torch/csrc/indep.cu`) on one NVIDIA GPU: each step
committed with branches in place of selects, one loop over both levels in
place of nested loops, the walks without their request of the next cell's
word ahead of its test (fine level, brick level), launch bounds, the
camera kernel's block shape, the brick bitmap read through the read-only
path in place of each block's shared-memory copy, the occupancy words
copied into shared memory with one bulk asynchronous copy by persistent
blocks, and persistent warps that take rays from a global counter;
optionally against an earlier `indep.cu` (``--baseline FILE``: the same
launcher interface) and that file with the committed launch bounds and
block shape (`baseline_levers`).

Each variant is the committed source with textual changes, compiled with
the port's nvcc flags into `build/voxel_tracer_tpu_torch/trials/` and
called through the port's launchers (`render_indep_tiles`,
`trace_rays_indep`) with its library in place of the port's.  The inputs
are `chip_smoke.py`'s: the bench frame (1920x1088, flat and lambert), its
1 M random rays, the bench frame on a 128^3 noise volume (4096 bricks) and
the long sparse volume's 65,536 rays (`profiling.budget_scene`, 2048
bricks, walked end to end).

Every variant is held against the plain version on every input (aux and t
equal, image within 1 LSB) before it is timed.  Variants are timed in
turns (A B C ... C B A), each turn with CUDA events at two call counts
(their differential) and profiler device time per launch.  Prints the
ptxas lines of each variant, one line per turn, and a JSON summary as the
last line (also written to
`build/voxel_tracer_tpu_torch/trials/indep_trials.json`).

Run from the repository root on a machine with a card:
    python3 tools/torch_indep_trials.py [--baseline path/to/old/indep.cu]
                                        [--variants a,b,...]
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from voxel_tracer_tpu_torch.ops.cuda import _build, indep, mega  # noqa: E402

OUT_DIR = _build.BUILD_DIR / "trials"

# -- no_fine_prefetch: the fine walk loads each cell's occupancy word only
# when it tests that cell; the same float operations in the same order
FINE_START = "      uint32_t word = __ldg(&w[bit >> 5]);\n"
FINE_END = "    // one brick step"
SIMPLE_FINE = """      for (int fi = 1;; ++fi) {
        ++steps;                                    // this cell's test
        if ((__ldg(&w[bit >> 5]) >> (bit & 31)) & 1u) {
          const bool hpos = fax == 0 ? px : (fax == 1 ? py : pz);
          h.t = fmaf(ft, g.rvpu, enter);
          h.mat = (int)__ldg(&v.matb[(size_t)b * 512 + bit]);
          h.ax = fax * 2 + (hpos ? 1 : 0);
          h.steps = steps;
          return h;
        }
        const bool fux = (fmx < fmy) && (fmx < fmz);
        const bool fuy = !(fmx < fmy) && (fmy < fmz);
        const bool fuz = !fux && !fuy;
        fx = fux ? fx + sx : fx;
        fy = fuy ? fy + sy : fy;
        fz = fuz ? fz + sz : fz;
        ft = fux ? fmx : (fuy ? fmy : fmz);
        fmx = fux ? fmx + dlx : fmx;
        fmy = fuy ? fmy + dly : fmy;
        fmz = fuz ? fmz + dlz : fmz;
        fax = fux ? 0 : (fuy ? 1 : 2);
        if (((unsigned)fx | (unsigned)fy | (unsigned)fz) >= 8u) break;   // the brick step
        bit = (fz * 8 + fy) * 8 + fx;
        if (fi >= FINE_ITERS) {                     // fine cap: unresolved
          h.steps = steps;
          h.resolved = 0;
          return h;
        }
      }
    }
"""
# -- no_brick_prefetch: the brick walk loads a brick's bitmap word when it
# tests that brick
def _no_brick_prefetch(src):
    i = src.index("  auto next_brick = [&]() {")
    j = src.index("  };\n", i) + len("  };\n")
    src = src[:i] + src[j:]
    for old, new in (
            ("  uint32_t bword = bits[b >> 5];\n"
             "  int nbi = next_brick();\n"
             "  uint32_t nbword = bits[((unsigned)nbi >> 5) & 127u];\n", ""),
            ("    if ((bword >> (b & 31)) & 1u) {",
             "    if ((bits[b >> 5] >> (b & 31)) & 1u) {"),
            ("    b = nbi;\n    bword = nbword;\n    nbi = next_brick();\n"
             "    nbword = bits[((unsigned)nbi >> 5) & 127u];\n",
             "    b = (bcz * nby + bcy) * nbx + bcx;\n")):
        src = _sub(src, old, new)
    return src


# -- ldg_bitmap: the 128-word bitmap read through the read-only path in
# place of each block's shared-memory copy
LDG_BITMAP = [
    ("  __shared__ uint32_t sbits[128];\n", ""),
    ("  for (int k = tid; k < 128; k += blockDim.x * blockDim.y) sbits[k] = __ldg(&v.bits[k]);\n",
     ""),
    ("  for (int k = threadIdx.x; k < 128; k += blockDim.x) sbits[k] = __ldg(&v.bits[k]);\n"
     "  __syncthreads();\n", ""),
    ("indep_ray(o, d, sbits, v)", "indep_ray(o, d, v.bits, v)"),
    ("= bits[b >> 5];", "= __ldg(&bits[b >> 5]);"),
    ("= bits[((unsigned)nbi >> 5) & 127u];", "= __ldg(&bits[((unsigned)nbi >> 5) & 127u]);")]
CAM_BOUNDS = "__launch_bounds__(256, 1)\nindep_camera_kernel"
RAY_BOUNDS = "__launch_bounds__(RAY_THREADS, 1)\nindep_rays_kernel"
BLOCK = "const dim3 block(8, 32);"
WALK_START = "// First hit of one ray"
WALK_END = "// Camera frame (B3)"
HELPERS_AT = "Volume make_volume("
CAM_LAUNCH_AT = "  const dim3 block(8, 32);\n"
RAY_LAUNCH_AT = "  indep_rays_kernel<<<"

# -- shared_occw: persistent blocks (at most SOCC_BLOCKS_PER_SM an SM) copy
# the occupancy words of volumes of <= 3520 bricks (225,280 bytes) into
# shared memory with one cp.async.bulk completing on an mbarrier, then walk
# their pixels or rays from there; larger volumes take the committed kernels
SOCC_KERNELS = r"""
constexpr int SOCC_MAX_BRICKS = 3520;   // 225,280 bytes beside the static palette
constexpr int SOCC_BLOCKS_PER_SM = @PER_SM@;

// One bulk copy of `bytes` (a multiple of 16) from occw into socc; every
// thread of the block returns once the words have landed.
__device__ __forceinline__ void socc_load(uint32_t* socc, const uint32_t* occw,
                                          uint32_t bytes, uint64_t* bar) {
  const uint32_t b = (uint32_t)__cvta_generic_to_shared(bar);
  if (threadIdx.x == 0 && threadIdx.y == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(b) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(b), "r"(bytes) : "memory");
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
                 " [%0], [%1], %2, [%3];"
                 :: "r"((uint32_t)__cvta_generic_to_shared(socc)), "l"(occw), "r"(bytes),
                    "r"(b) : "memory");
  }
  __syncthreads();
  uint32_t done = 0;
  while (!done) {
    asm volatile("{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
                 " selp.u32 %0, 1, 0, p;\n}" : "=r"(done) : "r"(b) : "memory");
  }
}

__global__ void __launch_bounds__(256, 1)
indep_camera_socc_kernel(const float* __restrict__ cam, const float* __restrict__ pal,
                         Volume v, int width, int height, int shading, int sky_mode,
                         float ambient, int32_t* __restrict__ rgba_out,
                         float* __restrict__ t_out, int32_t* __restrict__ aux_out) {
  extern __shared__ __align__(128) uint32_t socc[];
  __shared__ float spal[256 * 3];
  __shared__ uint32_t sbits[128];
  __shared__ __align__(8) uint64_t bar;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int i = tid; i < 256 * 3; i += blockDim.x * blockDim.y) spal[i] = __ldg(&pal[i]);
  for (int k = tid; k < 128; k += blockDim.x * blockDim.y) sbits[k] = __ldg(&v.bits[k]);
  socc_load(socc, v.occw, (uint32_t)(v.g.nb[0] * v.g.nb[1] * v.g.nb[2]) * 64u, &bar);
  const int tiles_x = (width + blockDim.x - 1) / blockDim.x;
  const int tiles = tiles_x * ((height + blockDim.y - 1) / blockDim.y);
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int x = (tile % tiles_x) * blockDim.x + threadIdx.x;
    const int y = (tile / tiles_x) * blockDim.y + threadIdx.y;
    if (x >= width || y >= height) continue;
    float o[3], d[3];
    frame::camera_ray(cam, x, y, o, d);
    const Hit h = indep_ray_socc(o, d, sbits, v, socc);
    const size_t idx = (size_t)y * width + x;
    const bool hit = h.t < BIG;
    t_out[idx] = h.t;
    aux_out[idx] = frame::pack_aux(h.mat, h.ax, h.resolved, h.steps);
    rgba_out[idx] = frame::shade_rgba(cam, spal, d, hit, h.mat, h.ax, shading,
                                      sky_mode, ambient);
  }
}

__global__ void __launch_bounds__(RAY_THREADS, 1)
indep_rays_socc_kernel(const float* __restrict__ orig, const float* __restrict__ dirs,
                       int n, Volume v, float* __restrict__ t_out,
                       int32_t* __restrict__ aux_out) {
  extern __shared__ __align__(128) uint32_t socc[];
  __shared__ uint32_t sbits[128];
  __shared__ __align__(8) uint64_t bar;
  for (int k = threadIdx.x; k < 128; k += blockDim.x) sbits[k] = __ldg(&v.bits[k]);
  socc_load(socc, v.occw, (uint32_t)(v.g.nb[0] * v.g.nb[1] * v.g.nb[2]) * 64u, &bar);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    const size_t r3 = 3 * (size_t)i;
    const float o[3] = {__ldg(&orig[r3]), __ldg(&orig[r3 + 1]), __ldg(&orig[r3 + 2])};
    const float d[3] = {__ldg(&dirs[r3]), __ldg(&dirs[r3 + 1]), __ldg(&dirs[r3 + 2])};
    const Hit h = indep_ray_socc(o, d, sbits, v, socc);
    t_out[i] = h.t;
    aux_out[i] = frame::pack_aux(h.mat, h.ax, h.resolved, h.steps);
  }
}

// Persistent grid of a socc kernel for `smem` bytes of table: SMs x the
// blocks an SM holds, at most SOCC_BLOCKS_PER_SM; the attribute is set once
// for the largest table seen.
template <typename K>
int socc_blocks(K kernel, int threads, size_t smem) {
  static size_t set_smem = 0;
  static int n_sm = 0;
  if (!n_sm) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  }
  if (smem > set_smem) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    set_smem = smem;
  }
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  return n_sm * (per_sm < 1 ? 1 : (per_sm < SOCC_BLOCKS_PER_SM ? per_sm : SOCC_BLOCKS_PER_SM));
}

"""
SOCC_CAM_LAUNCH = """  const int nbr = nb[0] * nb[1] * nb[2];
  if (nbr <= SOCC_MAX_BRICKS) {
    const size_t smem = (size_t)nbr * 64;
    const int tiles = ((width + 7) / 8) * ((height + 31) / 32);
    const int cap = socc_blocks(indep_camera_socc_kernel, 256, smem);
    const int blocks = tiles < cap ? tiles : cap;
    indep_camera_socc_kernel<<<blocks, dim3(8, 32), smem, stream>>>(
        cam, pal, v, width, height, shading, sky_mode, ambient, rgba, t, aux);
    return (int)cudaGetLastError();
  }
"""
SOCC_RAY_LAUNCH = """  const int nbr = nb[0] * nb[1] * nb[2];
  if (nbr <= SOCC_MAX_BRICKS) {
    const size_t smem = (size_t)nbr * 64;
    const int cap = socc_blocks(indep_rays_socc_kernel, RAY_THREADS, smem);
    const int need = (n + RAY_THREADS - 1) / RAY_THREADS;
    const int blocks = need < cap ? need : cap;
    indep_rays_socc_kernel<<<blocks, RAY_THREADS, smem, stream>>>(orig, dirs, n, v, t, aux);
    return (int)cudaGetLastError();
  }
"""

# -- persistent_rays (B4): warps take batches of 32 rays from a global
# counter (Aila and Laine, HPG 2009), so a few long walks do not hold a
# whole block resident
PERSISTENT_KERNEL = r"""
__device__ unsigned int g_next_ray;

__global__ void __launch_bounds__(RAY_THREADS, 1)
indep_rays_persistent_kernel(const float* __restrict__ orig,
                             const float* __restrict__ dirs, int n, Volume v,
                             float* __restrict__ t_out, int32_t* __restrict__ aux_out) {
  __shared__ uint32_t sbits[128];
  for (int k = threadIdx.x; k < 128; k += blockDim.x) sbits[k] = __ldg(&v.bits[k]);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (;;) {
    unsigned int base = 0;
    if (lane == 0) base = atomicAdd(&g_next_ray, 32u);
    base = __shfl_sync(0xffffffffu, base, 0);
    if (base >= (unsigned int)n) return;
    const int i = (int)base + lane;
    if (i < n) {
      const size_t r3 = 3 * (size_t)i;
      const float o[3] = {__ldg(&orig[r3]), __ldg(&orig[r3 + 1]), __ldg(&orig[r3 + 2])};
      const float d[3] = {__ldg(&dirs[r3]), __ldg(&dirs[r3 + 1]), __ldg(&dirs[r3 + 2])};
      const Hit h = indep_ray(o, d, sbits, v);
      t_out[i] = h.t;
      aux_out[i] = frame::pack_aux(h.mat, h.ax, h.resolved, h.steps);
    }
  }
}

"""
PERSISTENT_LAUNCH = """  {
    static unsigned int* next = nullptr;
    static int n_blocks = 0;
    if (!next) {
      int dev = 0, n_sm = 0, per_sm = 0;
      cudaGetSymbolAddress((void**)&next, g_next_ray);
      cudaGetDevice(&dev);
      cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, indep_rays_persistent_kernel,
                                                    RAY_THREADS, 0);
      n_blocks = n_sm * (per_sm > 1 ? per_sm : 1);
    }
    cudaMemsetAsync(next, 0, sizeof(unsigned int), stream);
    const int need = (n + RAY_THREADS - 1) / RAY_THREADS;
    const int blocks = need < n_blocks ? need : n_blocks;
    indep_rays_persistent_kernel<<<blocks, RAY_THREADS, 0, stream>>>(orig, dirs, n, v, t, aux);
    return (int)cudaGetLastError();
  }
"""


def _shared_occw(src, per_sm):
    i, j = src.index(WALK_START), src.index(WALK_END)
    walk = src[i:j]
    for old, new in (("Hit indep_ray(", "Hit indep_ray_socc("),
                     ("const Volume& v) {", "const Volume& v, const uint32_t* socc) {"),
                     ("const uint32_t* __restrict__ w = v.occw + (size_t)b * 16;",
                      "const uint32_t* w = socc + (size_t)b * 16;"),
                     ("__ldg(&w[", "(w[")):
        walk = _sub(walk, old, new)
    src = _sub(src, HELPERS_AT, walk + SOCC_KERNELS.replace("@PER_SM@", str(per_sm))
               + HELPERS_AT)
    src = _sub(src, CAM_LAUNCH_AT, SOCC_CAM_LAUNCH + CAM_LAUNCH_AT)
    return _sub(src, RAY_LAUNCH_AT, SOCC_RAY_LAUNCH + RAY_LAUNCH_AT)


def _persistent_rays(src):
    src = _sub(src, HELPERS_AT, PERSISTENT_KERNEL + HELPERS_AT)
    return _sub(src, RAY_LAUNCH_AT, PERSISTENT_LAUNCH + RAY_LAUNCH_AT)


def _simple_fine(src):
    i = src.index(FINE_START)
    j = src.index(FINE_END, i)
    return src[:i] + SIMPLE_FINE + src[j:]


# -- branch_commit: each walk's step commits in an if / else-if / else on
# the chosen axis, in place of selects (the same float operations)
BRANCH_COMMIT = [
    ("""        ft = fux ? fmx : (fuy ? fmy : fmz);
        fmx = fux ? fmx + dlx : fmx;
        fmy = fuy ? fmy + dly : fmy;
        fmz = (!fux && !fuy) ? fmz + dlz : fmz;
        fax = fux ? 0 : (fuy ? 1 : 2);
""", """        if (fux) { ft = fmx; fmx = fmx + dlx; fax = 0; }
        else if (fuy) { ft = fmy; fmy = fmy + dly; fax = 1; }
        else { ft = fmz; fmz = fmz + dlz; fax = 2; }
"""),
    ("""    const bool ux = (btx < bty) && (btx < btz);
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
""", """    bool leaves;
    if ((btx < bty) && (btx < btz)) {
      bcx += sx; bft = btx; btx = btx + dlx; bax = 0; leaves = (unsigned)bcx >= (unsigned)nbx;
    } else if (!(btx < bty) && (bty < btz)) {
      bcy += sy; bft = bty; bty = bty + dly; bax = 1; leaves = (unsigned)bcy >= (unsigned)nby;
    } else {
      bcz += sz; bft = btz; btz = btz + dlz; bax = 2; leaves = (unsigned)bcz >= (unsigned)nbz;
    }
""")]
# -- single_loop: one loop whose every iteration takes one step of the
# level the ray is on (a fine step in an occupied brick, else a brick
# step), in place of a fine loop nested in the brick loop: a warp whose
# lanes are at different levels runs both bodies once an iteration instead
# of waiting for its longest fine walk (the "if-if" traversal of Aila and
# Laine, HPG 2009); the same steps, float operations and caps
LOOP_START = "  float bft = 0.0f;       // brick-unit time of the current brick's entry\n"
SINGLE_LOOP = r"""  float bft = 0.0f;       // brick-unit time of the current brick's entry
  int bax = entry_axis;   // axis of that entry step
  int steps = 0;
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
  int it = 0;                 // brick steps taken
  bool inside = false;        // walking the current brick's cells
  float enter = 0.0f, ft = 0.0f, fmx = 0.0f, fmy = 0.0f, fmz = 0.0f;
  int fx = 0, fy = 0, fz = 0, fax = 0, bit = 0, fi = 0;
  uint32_t word = 0u;
  const uint32_t* __restrict__ w = v.occw;
  for (;;) {
    bool brick_step = true;
    if (inside || ((bword >> (b & 31)) & 1u)) {
      if (!inside) {            // enter the occupied brick (indep.py:171-273)
        enter = fmaf(bft, g.rbpu, tmin);
        fine_setup((fmaf(d[0], enter, o[0]) - (float)bcx * g.rbpu) * g.vpu, px, rd[0], fx, fmx);
        fine_setup((fmaf(d[1], enter, o[1]) - (float)bcy * g.rbpu) * g.vpu, py, rd[1], fy, fmy);
        fine_setup((fmaf(d[2], enter, o[2]) - (float)bcz * g.rbpu) * g.vpu, pz, rd[2], fz, fmz);
        fax = (bft <= 1e-12f) ? entry_axis : bax;
        w = v.occw + (size_t)b * 16;
        ft = 0.0f;
        fi = 0;
        bit = (fz * 8 + fy) * 8 + fx;
        word = __ldg(&w[bit >> 5]);
        inside = true;
      }
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
      if (out) {
        inside = false;                           // the brick step below
      } else {
        if (fux) { ft = fmx; fmx = fmx + dlx; fax = 0; }
        else if (fuy) { ft = fmy; fmy = fmy + dly; fax = 1; }
        else { ft = fmz; fmz = fmz + dlz; fax = 2; }
        fx = mx; fy = my; fz = mz; bit = mbit; word = mword;
        if (++fi >= FINE_ITERS) {                 // fine cap: unresolved
          h.steps = steps;
          h.resolved = 0;
          return h;
        }
        brick_step = false;
      }
    }
    if (brick_step) {                             // indep.py:302-328
      bool leaves;
      if ((btx < bty) && (btx < btz)) {
        bcx += sx; bft = btx; btx = btx + dlx; bax = 0; leaves = (unsigned)bcx >= (unsigned)nbx;
      } else if (!(btx < bty) && (bty < btz)) {
        bcy += sy; bft = bty; bty = bty + dly; bax = 1; leaves = (unsigned)bcy >= (unsigned)nby;
      } else {
        bcz += sz; bft = btz; btz = btz + dlz; bax = 2; leaves = (unsigned)bcz >= (unsigned)nbz;
      }
      ++steps;
      if (leaves) {                               // left the grid: a miss
        h.steps = steps;
        return h;
      }
      b = nbi;
      bword = nbword;
      nbi = next_brick();
      nbword = bits[((unsigned)nbi >> 5) & 127u];
      if (++it >= max_outer) {                    // out of iterations: unresolved
        h.steps = steps;
        h.resolved = 0;
        return h;
      }
    }
  }
}

"""


def _single_loop(src):
    i = src.index(LOOP_START)
    j = src.index(WALK_END, i)
    return src[:i] + SINGLE_LOOP + src[j:]


# Variants of the --baseline file (an earlier indep.cu): the committed
# launch bounds and camera block shape on that file's walk
BASELINE_VARIANTS = {
    "baseline_levers": [
        ("__global__ void indep_camera_kernel(",
         "__global__ void __launch_bounds__(256, 1)\nindep_camera_kernel("),
        ("__launch_bounds__(RAY_THREADS)\nindep_rays_kernel",
         "__launch_bounds__(RAY_THREADS, 1)\nindep_rays_kernel"),
        ("  const dim3 block(16, 16);\n  const dim3 grid((width + 15) / 16, (height + 15) / 16);",
         "  const dim3 block(8, 32);\n  const dim3 grid((width + 7) / 8, (height + 31) / 32);")],
}

VARIANTS = {
    "committed": [],
    "branch_commit": BRANCH_COMMIT,
    "single_loop": [_single_loop],
    "no_fine_prefetch": [_simple_fine],
    "no_brick_prefetch": [_no_brick_prefetch],
    "bounds_threads_only": [(CAM_BOUNDS, "__launch_bounds__(256)\nindep_camera_kernel"),
                            (RAY_BOUNDS, "__launch_bounds__(RAY_THREADS)\nindep_rays_kernel")],
    "block_16x16": [(BLOCK, "const dim3 block(16, 16);")],
    "block_8x16": [(BLOCK, "const dim3 block(8, 16);")],
    "rays_256": [("constexpr int RAY_THREADS = 128;", "constexpr int RAY_THREADS = 256;")],
    "rays_64": [("constexpr int RAY_THREADS = 128;", "constexpr int RAY_THREADS = 64;")],
    "ldg_bitmap": LDG_BITMAP,
    "shared_occw": [lambda s: _shared_occw(s, 8)],
    "shared_occw_2": [lambda s: _shared_occw(s, 2)],
    "persistent_rays": [_persistent_rays],
}


def _sub(src, old, new):
    if old not in src:
        raise RuntimeError(f"the source does not hold {old!r}")
    return src.replace(old, new)


def variant_source(name, src=None):
    """The source of one variant: the committed `indep.cu` (or, for a
    variant of BASELINE_VARIANTS, ``src``) with the variant's changes;
    raises if a change no longer applies."""
    if src is None:
        src = (_build.CSRC / "indep.cu").read_text()
    for patch in {**VARIANTS, **BASELINE_VARIANTS}[name]:
        src = patch(src) if callable(patch) else _sub(src, *patch)
    return src


def build_variants(names, baseline):
    """Compile the named variants (and, with a baseline file, it and its
    variants), one nvcc process each, all started together; returns
    {name: (CDLL, ptxas lines)}."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    sources = {name: variant_source(name) for name in names}
    if baseline:
        with open(baseline) as f:
            sources["baseline"] = f.read()
        for name in BASELINE_VARIANTS:
            sources[name] = variant_source(name, sources["baseline"])
    procs = {}
    for name, src in sources.items():
        cu = OUT_DIR / f"indep_{name}.cu"
        cu.write_text(src)
        so = OUT_DIR / f"libindep_{name}.so"
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    out = {}
    for name, (proc, so) in procs.items():
        text = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{text}")
        ptxas = [ln.strip() for ln in text.splitlines()
                 if "entry function" in ln or "registers" in ln or "spill" in ln]
        out[name] = (ctypes.CDLL(str(so)), ptxas)
    return out


def _use(lib):
    _build._LIBS["indep"] = lib
    indep._lib()                                 # argtypes of the port's launchers


def camera_call(lib, cam_p, occb, tb, shading="flat"):
    """fn() rendering one frame with one variant's library: (rgba, t, aux)."""
    def fn():
        _build._LIBS["indep"] = lib
        return indep.render_indep_tiles(cam_p, occb, tb, width=cs.W, height=cs.H,
                                        shading=shading)
    return fn


def rays_call(lib, o, d, occb, tb):
    """fn() tracing a ray list with one variant's library: (t, aux)."""
    def fn():
        _build._LIBS["indep"] = lib
        r = indep.trace_rays_indep(o, d, occb, tb)
        return r["t"], (r["mat"] | (r["ax"] << mega.AUX_AX_SHIFT)
                        | (r["resolved"].int() << mega.AUX_RESOLVED_SHIFT)
                        | (r["steps"] << mega.AUX_STEPS_SHIFT))
    return fn


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline", help="an earlier indep.cu to time beside the variants")
    ap.add_argument("--variants", help="comma-separated subset of the variants (default: all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_indep_trials: no CUDA device available", file=sys.stderr)
        return 2
    from voxel_tracer_tpu_torch.models.volume import VoxelVolume
    smi = cs.nvidia_smi()
    cs.log(f"[device] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    libs = build_variants(args.variants.split(",") if args.variants else list(VARIANTS),
                          args.baseline)
    for name, (lib, ptxas) in libs.items():
        for ln in ptxas:
            cs.log(f"[build] {name}: {ln}")
        _use(lib)

    cam = cs.bench_camera(0.0, cs.W / cs.H)
    mv = mega.MegaVolume(VoxelVolume.noise_filled((64, 64, 64), pos=(0, 0, 0), vpu=20.0))
    cam_p = mega.mega_camera(mv, cam, cs.SUN, cs.W, cs.H)
    occb = indep.occb_of(mv.tables)
    o_r, d_r = cs.random_rays()
    ex = cs.indep_extra_inputs(cam)
    inputs = {
        "bench flat": (lambda lib: camera_call(lib, cam_p, occb, mv.tables), (16, 64),
                       "indep_camera"),
        "bench lambert": (lambda lib: camera_call(lib, cam_p, occb, mv.tables, "lambert"),
                          (16, 64), "indep_camera"),
        "random rays": (lambda lib: rays_call(lib, o_r, d_r, occb, mv.tables), (10, 40),
                        "indep_rays"),
        "grid 128": (lambda lib: camera_call(lib, ex["grid_cam_p"], ex["grid_occb"],
                                             ex["grid"].tables), (8, 32), "indep_camera"),
        "budget rays": (lambda lib: rays_call(lib, ex["budget_o"], ex["budget_d"],
                                              ex["budget_occb"], ex["budget"]), (4, 16),
                        "indep_rays")}
    plain = {
        "bench flat": indep.render_indep_tiles_plain(cam_p, occb, mv.tables, width=cs.W,
                                                     height=cs.H),
        "bench lambert": indep.render_indep_tiles_plain(cam_p, occb, mv.tables, width=cs.W,
                                                        height=cs.H, shading="lambert"),
        "random rays": indep._walk(o_r, d_r, occb, mv.tables),
        "grid 128": indep.render_indep_tiles_plain(ex["grid_cam_p"], ex["grid_occb"],
                                                   ex["grid"].tables, width=cs.W,
                                                   height=cs.H),
        "budget rays": indep._walk(ex["budget_o"], ex["budget_d"], ex["budget_occb"],
                                   ex["budget"])}
    for name, (lib, _) in libs.items():
        for key, (make, _, _) in inputs.items():
            k, p = make(lib)(), plain[key]
            torch.cuda.synchronize()
            if len(k) == 3:
                lsb = int((mega._unpack_rgb8(k[0]) - mega._unpack_rgb8(p[0])).abs().max())
                cs.require(lsb <= cs.LSB, f"variant {name}: {key} image differs by {lsb} LSB")
                k, p = k[1:], p[1:]
            cs.require(torch.equal(k[0], p[0]) and torch.equal(k[1], p[1]),
                       f"variant {name} differs from the plain version on {key}")
        cs.log(f"[trials] {name}: {', '.join(inputs)} equal the plain version")

    order = list(libs)
    readings = {w: {v: [] for v in order} for w in inputs}
    for turn, name in enumerate(order + order[::-1]):
        lib = libs[name][0]
        parts = []
        for wname, (make, counts, span) in inputs.items():
            fn = make(lib)
            fn()
            ms = [cs.cuda_ms(lambda i: fn(), c) for c in counts]
            diff = (ms[1] * counts[1] - ms[0] * counts[0]) / (counts[1] - counts[0])
            dev = cs.kernel_device_ms(fn, counts[0], span)
            readings[wname][name].append((ms[1], diff, dev))
            parts.append(f"{wname} {ms[1]:.4f} ms (differential {diff:.4f}, device "
                         f"{'n/a' if dev is None else f'{dev:.4f}'})")
        cs.log(f"[trials] turn {turn} {name}: " + ", ".join(parts))
    for wname, per in readings.items():
        for name, r in per.items():
            devs = [x[2] for x in r]
            cs.log(f"[trials] {wname} {name}: mean {sum(x[0] for x in r) / len(r):.4f} ms, "
                   f"differential {sum(x[1] for x in r) / len(r):.4f} ms, device mean "
                   + (f"{sum(devs) / len(devs):.4f} ms" if all(x is not None for x in devs)
                      else "not measured"))
    summary = {"device": smi, "ptxas": {n: v[1] for n, v in libs.items()},
               "readings": readings}
    with open(OUT_DIR / "indep_trials.json", "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
