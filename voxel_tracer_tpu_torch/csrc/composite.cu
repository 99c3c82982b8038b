// The traversal glue of the wavefront composite around D1, for Hopper
// (sm_90a): world rays to volume-local rays, D1's outputs to the hit
// record, and the top-K slab prepass of a stacked group.
//
// Replaces no Pallas kernel.  The JAX package runs this glue inside each
// frame's jit, where XLA fuses it around its DDA loop; the port ran it
// (ops/composite.py, the plain version) as about 70 eager tensor
// operations a traversal call over every ray: the rigid inverse transform
// (math3d.rigid_inverse_point / rigid_inverse_vec), the miss record, the
// normal (dda.normal_from_axis), the palette gather, the selects of
// a one-volume record and of a candidate slot, and HitResult.nearer; and
// the prepass (_topk) as about 95 more an object of a stacked group.  Here
// it is three kernels, one thread a ray:
//
// - composite_local_kernel: the ray's object (a scalar index, a per-ray
//   oid, or clamp(obj - obj_base, 0, O - 1) for the interior march), its
//   rot / pos / pivot / vpu from the group's (O, ...) tables, and
//   o_l = R^T (p - pos) + pivot, d_l = R^T d, each product summed left to
//   right as math3d._mat3_t_apply does; optionally the per-ray vpu and the
//   int64 oid that D1 takes.
// - composite_record_kernel: from D1's t, mat, axis, step_sign and steps,
//   the normal (normal_from_axis's program: -sign * the axis column of
//   rot, divided by the clamped length, whose squares are summed
//   (a0 + a2) + a1, the order of torch.sum over a 3-vector on the card),
//   the clamped palette albedo, then one of
//     nearer: the candidate (mat, normal and albedo zeroed on a miss, obj
//       = obj_base + oid or -1, t and steps masked by an optional `live`)
//       merged into the running record: a strict win takes it, steps add;
//       with `fresh` the running record is the miss record (t 1e30, mat 0,
//       zero normal and albedo, steps 0, obj -1) and is not read, so the
//       first group of a scene writes miss.nearer(candidate) directly;
//     select: march_interior's merge: rows whose obj lies in the group
//       take D1's raw outputs (nothing zeroed) and their own obj; with
//       `fresh` the other rows get the miss record.
// - composite_topk_kernel (K = 1..TOPK_MAX, the list in registers): the
//   ray's K nearest objects of a stacked group by slab entry t.  For each
//   of the O objects in order: the local ray (composite_local_kernel's
//   program), then dda.slab_test's: size = (gx, gy, gz) / vpu, rcp = 1 / d,
//   t1 = (0 - o) * rcp, t2 = (size - o) * rcp, min / max with NaN (0 * inf
//   on a slab plane) read as -1e30 / 1e30, tmin = max(0, tn...), tmax =
//   min(tf...), a hit iff tmax - 1e-4 >= tmin; t = tmin on a hit, else 1e30,
//   bubble-inserted into the sorted list with a strict <, so a tie keeps
//   the earlier object.  Writes _topk's (N, K) t and int32 ids (1e30 and 0
//   in slots no object filled).
//
// The local ray (to_local) and the normal and albedo (normal_albedo) are
// the device functions of composite.cuh, which D1's candidate race
// (csrc/dda.cu) runs too.
//
// Rounding: compiled with --fmad=false (no contraction), IEEE division and
// sqrt, so every output equals the plain version's on the card bit for
// bit (stochastic shadows key on the hit cell: one ulp of o_l can flip a
// shadow).  The one exception is the sign of a zero entry t of the prepass:
// the plain version takes tmin with torch.amax, whose reduction order over
// the four values picks between +0 and -0; the candidate passes only
// compare t, so the two signs select the same candidates.
//
// Bound: bytes.  Local reads 24 B a ray (+ 4 or 8 of oid / obj) and writes
// 24 (+ 4 vpu, 8 oid); record reads D1's 28 B a ray (+ 1 live, the
// object's) and writes the 40-byte record, reading it first when it
// merges; the prepass reads 24 B a ray (12 with a broadcast direction) and
// writes 8 K.  The tables are a few hundred bytes an object, L1-resident.
// Consecutive threads touch consecutive rays, so each warp's 12-byte
// vectors fall in contiguous 384-byte spans.
//
// Launchers are extern "C", run on the caller's stream, allocate nothing,
// and return cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "composite.cuh"   // to_local, normal_albedo, TOPK_MAX

// ops/cuda/composite.py mirrors the three layouts (_LocalArgs, _RecordArgs,
// _TopkArgs).
// The ray's object: oid_ray if set, else clamp(obj - obj_base, 0, n_obj -
// 1) if obj is set, else oid_s.
struct LocalArgs {
  const float* orig;     // (N, 3) world origins
  const float* dirs;     // (N, 3) world directions
  const float* rot;      // (O, 3, 3) local -> world rotations
  const float* pos;      // (O, 3)
  const float* pivot;    // (O, 3)
  const float* vpu;      // (O,)
  const int64_t* oid_ray;  // (N,) object per ray, or null
  const int32_t* obj;    // (N,) global object per ray (interior march), or null
  float* o_l;            // (N, 3) outputs
  float* d_l;            // (N, 3)
  float* vpu_out;        // (N,) the ray's vpu, or null
  int64_t* oid_out;      // (N,) the ray's object, or null
  int n;
  int orig_row;          // row strides of orig and dirs: 3, or 0 (one
  int dirs_row;          // vector broadcast to every ray)
  int n_obj;
  int oid_s;
  int obj_base;
};

struct RecordArgs {
  const float* t;        // D1's outputs, (N,) unless noted
  const int32_t* mat;
  const int32_t* axis;
  const float* step_sign;  // (N, 3)
  const int32_t* steps;
  const float* rot;      // (O, 3, 3)
  const float* palette;  // (O, 256, 3)
  const int64_t* oid_ray;
  const int32_t* obj;
  const uint8_t* live;   // (N,) candidate mask (nearer), or null
  float* rt;             // the record, (N,) unless noted; read unless fresh
  int32_t* rmat;
  float* rnormal;        // (N, 3)
  float* ralbedo;        // (N, 3)
  int32_t* rsteps;
  int32_t* robj;
  int n;
  int n_obj;
  int oid_s;
  int obj_base;
  int select;            // 1: select on obj's group, 0: nearer
  int fresh;             // 1: the running record is the miss record
};

struct TopkArgs {
  const float* orig;     // (N, 3) world origins
  const float* dirs;     // (N, 3) world directions
  const float* rot;      // (O, 3, 3)
  const float* pos;      // (O, 3)
  const float* pivot;    // (O, 3)
  const float* vpu;      // (O,)
  float* t;              // (N, K) slab entry t, nearest first (1e30: none)
  int32_t* ids;          // (N, K) the objects
  int n;
  int orig_row;          // row strides of orig and dirs: 3 or 0
  int dirs_row;
  int n_obj;
  int k;                 // 1..TOPK_MAX
  int gx;                // the group's grid dims
  int gy;
  int gz;
};

namespace {

constexpr float BIG_F32 = 1e30f;   // math3d.BIG_F32
constexpr int THREADS = 256;

__device__ __forceinline__ int object_of(const int64_t* oid_ray, const int32_t* obj,
                                         int oid_s, int obj_base, int n_obj, int i) {
  if (oid_ray != nullptr) return (int)oid_ray[i];
  if (obj != nullptr) return min(max(obj[i] - obj_base, 0), n_obj - 1);
  return oid_s;
}

__global__ void composite_local_kernel(const LocalArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const int o = object_of(a.oid_ray, a.obj, a.oid_s, a.obj_base, a.n_obj, i);
  float lo[3], ld[3];
  to_local(a.rot, a.pos, a.pivot, a.orig + (size_t)a.orig_row * i,
           a.dirs + (size_t)a.dirs_row * i, o, lo, ld);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    a.o_l[3 * i + k] = lo[k];
    a.d_l[3 * i + k] = ld[k];
  }
  if (a.vpu_out != nullptr) a.vpu_out[i] = a.vpu[o];
  if (a.oid_out != nullptr) a.oid_out[i] = o;
}

// dda.slab_test's entry t of a local ray against the box [0, size]: tmin on
// a hit, 1e30 on a miss.  torch.minimum / maximum propagate NaN, which the
// guards then replace, so a NaN on either side reads -1e30 / 1e30.
__device__ __forceinline__ float slab_entry(const float* lo, const float* ld,
                                            const float* size) {
  float tmin = 0.0f, tmax = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float rcp = 1.0f / ld[k];
    const float t1 = (0.0f - lo[k]) * rcp;
    const float t2 = (size[k] - lo[k]) * rcp;
    const bool nan = isnan(t1) || isnan(t2);
    const float tn = nan ? -BIG_F32 : fminf(t1, t2);
    const float tf = nan ? BIG_F32 : fmaxf(t1, t2);
    tmin = fmaxf(tmin, tn);
    tmax = k == 0 ? tf : fminf(tmax, tf);
  }
  return tmax - static_cast<float>(1e-4) >= tmin ? tmin : BIG_F32;
}

// The list runs over TOPK_MAX slots, unrolled so that it stays in
// registers; the slots from k on take no part.
__global__ void composite_topk_kernel(const TopkArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const float* po = a.orig + (size_t)a.orig_row * i;
  const float* pd = a.dirs + (size_t)a.dirs_row * i;
  float tk[TOPK_MAX];
  int idk[TOPK_MAX];
#pragma unroll
  for (int j = 0; j < TOPK_MAX; ++j) {
    tk[j] = BIG_F32;
    idk[j] = 0;
  }
  for (int o = 0; o < a.n_obj; ++o) {
    float lo[3], ld[3];
    to_local(a.rot, a.pos, a.pivot, po, pd, o, lo, ld);
    const float vpu = a.vpu[o];
    const float size[3] = {(float)a.gx / vpu, (float)a.gy / vpu, (float)a.gz / vpu};
    float t = slab_entry(lo, ld, size);
    int id = o;
#pragma unroll
    for (int j = 0; j < TOPK_MAX; ++j) {    // the list stays sorted: swap on a strict win
      const bool take = j < a.k && t < tk[j];
      const float ct = tk[j];
      const int ci = idk[j];
      tk[j] = take ? t : ct;
      idk[j] = take ? id : ci;
      t = take ? ct : t;
      id = take ? ci : id;
    }
  }
#pragma unroll
  for (int j = 0; j < TOPK_MAX; ++j) {
    if (j < a.k) {
      a.t[(size_t)a.k * i + j] = tk[j];
      a.ids[(size_t)a.k * i + j] = idk[j];
    }
  }
}

__global__ void composite_record_kernel(const RecordArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const int o = object_of(a.oid_ray, a.obj, a.oid_s, a.obj_base, a.n_obj, i);
  const float t = a.t[i];
  const int m = a.mat[i];
  const int ax = min(max(a.axis[i], 0), 2);   // D1 writes 0..2
  float nv[3], av[3];
  normal_albedo(a.rot, a.palette, o, ax, -a.step_sign[3 * i + ax], m, nv, av);

  if (a.select) {
    const bool sel = a.obj[i] >= a.obj_base && a.obj[i] < a.obj_base + a.n_obj;
    if (sel) {
      a.rt[i] = t;
      a.rmat[i] = m;
      a.rsteps[i] = a.steps[i];
      a.robj[i] = a.obj[i];
    } else if (a.fresh) {
      a.rt[i] = BIG_F32;
      a.rmat[i] = 0;
      a.rsteps[i] = 0;
      a.robj[i] = -1;
    }
    if (sel || a.fresh) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        a.rnormal[3 * i + k] = sel ? nv[k] : 0.0f;
        a.ralbedo[3 * i + k] = sel ? av[k] : 0.0f;
      }
    }
    return;
  }

  const bool live = a.live == nullptr || a.live[i] != 0;
  const bool hit = live && t < BIG_F32;
  const float ct = hit ? t : BIG_F32;
  const int csteps = live ? a.steps[i] : 0;
  const float bt = a.fresh ? BIG_F32 : a.rt[i];
  const int bsteps = a.fresh ? 0 : a.rsteps[i];
  a.rsteps[i] = bsteps + csteps;
  const bool take = ct < bt;
  if (take) {                     // a miss wins only over a record past 1e30
    a.rt[i] = ct;
    a.rmat[i] = hit ? m : 0;
    a.robj[i] = hit ? a.obj_base + o : -1;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      a.rnormal[3 * i + k] = hit ? nv[k] : 0.0f;
      a.ralbedo[3 * i + k] = hit ? av[k] : 0.0f;
    }
  } else if (a.fresh) {
    a.rt[i] = BIG_F32;
    a.rmat[i] = 0;
    a.robj[i] = -1;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      a.rnormal[3 * i + k] = 0.0f;
      a.ralbedo[3 * i + k] = 0.0f;
    }
  }
}

}  // namespace

extern "C" int vt_composite_local(const LocalArgs* args, cudaStream_t stream) {
  const LocalArgs a = *args;
  composite_local_kernel<<<(a.n + THREADS - 1) / THREADS, THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int vt_composite_record(const RecordArgs* args, cudaStream_t stream) {
  const RecordArgs a = *args;
  composite_record_kernel<<<(a.n + THREADS - 1) / THREADS, THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int vt_composite_topk(const TopkArgs* args, cudaStream_t stream) {
  const TopkArgs a = *args;
  if (a.k < 1 || a.k > TOPK_MAX) return (int)cudaErrorInvalidValue;
  const int grid = (a.n + THREADS - 1) / THREADS;
  composite_topk_kernel<<<grid, THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* vt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
