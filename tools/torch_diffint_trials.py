#!/usr/bin/env python3
"""Design trials of the port's integrate kernels B6 / B7
(`voxel_tracer_tpu_torch/csrc/diffint.cu`) on one NVIDIA GPU: the block
size of each kernel (128 or 256 threads), the prefetch of the next
voxel's record, and warp-level aggregation of B7's gradient reductions, at
training shapes and on diff_lambert_512; two diagnostic variants (fast
`__expf`, loads that bypass L1) locate what bounds the march.

Each variant is the committed source with textual changes -- the block
sizes; the fine step without prefetch; for aggregation the one reduction
call replaced by `add_aggregated` below (`__match_any_sync` groups the
lanes of a warp that update one voxel, the group sums with shuffles, its
lowest lane issues the reduction) -- compiled with the port's nvcc flags into
`build/voxel_tracer_tpu_torch/trials/`, loaded in place of the port's
library and called through the port's launchers
(`integrate_fwd_records`, `integrate_bwd_records`).  The inputs are
`chip_smoke.py`'s: its diff_lambert_512 scene, and at training shapes its
32 ring views of 64x64 on the 128^3 grid after 25 `Trainer.fit` steps.

Every variant's B6 is held against the plain version within INT_ATOL and
its B7 within GRAD_RTOL x max|g| before it is timed.  Variants are timed
in turns (A B C D D C B A), each turn with CUDA events over serialized
calls (tables warm in L2) and profiler device time per launch.  Prints the
ptxas lines and the SASS reduction opcodes of each variant, one line per
turn, and a JSON summary as the last line (also written to
`build/voxel_tracer_tpu_torch/trials/diffint_trials.json`).

Run from the repository root on a machine with a card:
    python3 tools/torch_diffint_trials.py
"""

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from voxel_tracer_tpu_torch.ops.cuda import _build, diffint  # noqa: E402

OUT_DIR = _build.BUILD_DIR / "trials"
KERNEL = "template <bool BWD>\n__global__"
AGG_FN = """// Warp-level aggregation: the lanes of a warp that update one voxel sum
// their records with shuffles (in lane order); the lowest issues the one
// vector reduction.
__device__ __forceinline__ void add_aggregated(float4* grad, size_t idx, float4 g) {
  const unsigned act = __activemask();
  const unsigned peers = __match_any_sync(act, (unsigned long long)idx);
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(peers) - 1;
  for (unsigned m = peers & (peers - 1); m != 0; m &= m - 1) {
    const int src = __ffs(m) - 1;
    const float x = __shfl_sync(peers, g.x, src), y = __shfl_sync(peers, g.y, src),
                z = __shfl_sync(peers, g.z, src), w = __shfl_sync(peers, g.w, src);
    if (lane == leader) { g.x += x; g.y += y; g.z += z; g.w += w; }
  }
  if (lane == leader) atomicAdd(&grad[idx], g);
}

"""
# the fine step without prefetch: load, arithmetic, then the step to the
# next voxel
STEP_HEAD = """        for (int s = 0; s < p.fine_iters && live; ++s) {
          const size_t idx = base + (size_t)((vz * BRICK + vy) * BRICK + vx);
          const float4 r = __ldg(&p.rec[idx]);
          const float sg = r.x, ar = r.y, ag = r.z, ab = r.w;
          const float t_next = fminf(fminf(tmx, tmy), fminf(tmz, tf));
"""
STEP_TAIL = """          Cr = Cr2; Cg = Cg2; Cb = Cb2; D = D2;
          T = T * e;
          // fine step, tie rule of diffint.py:404-408
          const bool use_x = (tmx < tmy) && (tmx < tmz);
          const bool use_y = !(tmx < tmy) && (tmy < tmz);
          if (use_x) { vx += sx; tmx = tmx + dlx; }
          else if (use_y) { vy += sy; tmy = tmy + dly; }
          else { vz += sz; tmz = tmz + dlz; }
          const bool oob = ((vx | vy | vz) & ~7) != 0;
          live = !(oob || t_next >= tf) && (T > p.t_eps);
          t = t_next;
        }
"""
# the fine step as committed (software prefetch): step first, request the
# next voxel's record, then the current voxel's arithmetic
PREFETCH_HEAD = """        // software pipelined: the step to the next voxel comes first, its
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
"""
PREFETCH_TAIL = """          Cr = Cr2; Cg = Cg2; Cb = Cb2; D = D2;
          T = T * e;
          live = inside && (T > p.t_eps);
          t = t_next;
          idx = idx_next;
          r = r_next;
        }
"""
# name -> ((forward, backward) threads a block, patches, diagnostic): a
# diagnostic variant changes the float program and is timed only to locate
# the bound
VARIANTS = {
    "committed": ((128, 256), [], False),
    "all_128": ((128, 128), [], False),
    "all_256": ((256, 256), [], False),
    "aggregated": ((128, 256), [("atomicAdd(&p.grad[idx], g);",
                                 "add_aggregated(p.grad, idx, g);"),
                                (KERNEL, AGG_FN + KERNEL)], False),
    "no_prefetch": ((128, 256), [(PREFETCH_HEAD, STEP_HEAD), (PREFETCH_TAIL, STEP_TAIL)],
                    False),
    "diag_fast_exp": ((128, 256), [("expf(-fmaxf(sg, 0.0f) * dl)",
                                    "__expf(-fmaxf(sg, 0.0f) * dl)")], True),
    "diag_no_l1": ((128, 256), [("__ldg(&p.rec[", "__ldcg(&p.rec[")], True),
}


def _sub(src, old, new):
    if old not in src:
        raise RuntimeError(f"diffint.cu does not hold {old!r}")
    return src.replace(old, new)


def variant_source(name):
    (fwd, bwd), patches, _ = VARIANTS[name]
    src = (_build.CSRC / "diffint.cu").read_text()
    src = _sub(src, "constexpr int FWD_THREADS = 128;", f"constexpr int FWD_THREADS = {fwd};")
    src = _sub(src, "constexpr int BWD_THREADS = 256;", f"constexpr int BWD_THREADS = {bwd};")
    for old, new in patches:
        src = _sub(src, old, new)
    return src


def build_variants():
    """Compile every variant, one nvcc process each, all started together;
    returns {name: (CDLL, ptxas lines, SASS reduction opcodes)}."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in VARIANTS:
        cu = OUT_DIR / f"diffint_{name}.cu"
        cu.write_text(variant_source(name))
        so = OUT_DIR / f"libdiffint_{name}.so"
        procs[name] = (subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = {}
    for name, (proc, so) in procs.items():
        text = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{text}")
        ptxas = [ln.strip() for ln in text.splitlines()
                 if "entry function" in ln or "registers" in ln or "spill" in ln]
        sass = subprocess.run([cuobjdump, "-sass", str(so)], capture_output=True,
                              text=True, timeout=120).stdout
        ops = sorted({m.group(0) for m in
                      re.finditer(r"\b(?:RED|ATOM)[A-Z]*\.[A-Za-z0-9._]+", sass)})
        out[name] = (ctypes.CDLL(str(so)), ptxas, ops)
    return out


def trained_grid():
    """chip_smoke.py's training shapes: the ring views, the targets the
    kernel forward renders from its known field, and the grid after 25
    Trainer.fit steps."""
    from voxel_tracer_tpu_torch.trainer import TrainConfig, Trainer
    from voxel_tracer_tpu_torch.utils.profiling import blob_field, ring_views
    o, d = ring_views(cs.TRAIN_G, cs.TRAIN_VIEWS, cs.TRAIN_PX, cs.TRAIN_VPU)
    true_s, true_a = (torch.from_numpy(x).cuda()
                      for x in blob_field(cs.TRAIN_G, 1, 40.0, 0.25))
    o_t, d_t = torch.from_numpy(o).cuda(), torch.from_numpy(d).cuda()
    with torch.no_grad():
        c = diffint.render_density_mega(true_s, true_a, o_t, d_t, cs.TRAIN_VPU,
                                        t_eps=cs.T_EPS)["color"]
    cfg = TrainConfig(grid_size=(cs.TRAIN_G,) * 3, vpu=cs.TRAIN_VPU, lr=1e-2,
                      steps=25, rays_per_batch=o.shape[0], backend="kernel")
    tr = Trainer(cfg)
    tr.fit(o, d, c.cpu().numpy(), log_every=25, log_fn=lambda s: None)
    return (tr.params["sigma"].detach(), tr.params["albedo"].detach(), o_t, d_t,
            cs.TRAIN_VPU, c)


def scene_inputs(sigma, albedo, o, d, vpu, target):
    rec, occ, bsize = cs._packed(sigma, albedo)
    n = o.shape[0]
    carry = diffint._init_carry(n, o.device)
    kw = dict(bsize=bsize, vpu=vpu, t_eps=cs.T_EPS)
    fwd = diffint.integrate_fwd_plain(0, occ, o, d, carry, rec, **kw)
    color = torch.stack(fwd[:3], dim=-1)
    g_color = 2.0 * (color - target) / color.numel()
    zero = torch.zeros(n, device=o.device)
    cts = tuple(g_color[:, i].contiguous() for i in range(3)) + (zero, zero)
    grad = diffint.integrate_bwd_plain(0, occ, o, d, carry, rec, cts, fwd[:5], **kw)
    return dict(fwd_args=(0, occ, o, d, carry, rec),
                bwd_args=(0, occ, o, d, carry, rec, cts, fwd[:5]), kw=kw,
                plain_fwd=fwd, plain_grad=grad)


def check(name, scene_name, sc):
    k = diffint.integrate_fwd_records(*sc["fwd_args"], **sc["kw"])
    err_f = max(float((a - b).abs().max()) for a, b in zip(k[:5], sc["plain_fwd"][:5]))
    g = diffint.integrate_bwd_records(*sc["bwd_args"], **sc["kw"])
    p = sc["plain_grad"]
    rel = max(float((g[:, c] - p[:, c]).abs().max()) / float(p[:, c].abs().max())
              for c in range(4))
    cs.log(f"[trials] {name} on {scene_name}: fwd max |d| {err_f:.3g} "
           f"(limit {cs.INT_ATOL}), bwd {rel:.3g} x max|g| (limit {cs.GRAD_RTOL})")
    cs.require(VARIANTS[name][2] or (err_f <= cs.INT_ATOL and rel <= cs.GRAD_RTOL),
               f"variant {name} disagrees with the plain version on {scene_name}")


def time_turn(sc, reps):
    out = {}
    for mode, fn, args in (("fwd", diffint.integrate_fwd_records, sc["fwd_args"]),
                           ("bwd", diffint.integrate_bwd_records, sc["bwd_args"])):
        fn(*args, **sc["kw"])
        ms = cs.cuda_ms(lambda i: fn(*args, **sc["kw"]), reps)
        dev = cs.kernel_device_ms(lambda: fn(*args, **sc["kw"]), reps, "integrate_kernel")
        out[mode] = (ms, dev)
    return out


def main():
    if not torch.cuda.is_available():
        print("torch_diffint_trials: no CUDA device available", file=sys.stderr)
        return 2
    smi = cs.nvidia_smi()
    cs.log(f"[device] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    libs = build_variants()
    for name, (_, ptxas, ops) in libs.items():
        for ln in ptxas:
            cs.log(f"[build] {name}: {ln}")
        cs.log(f"[build] {name}: SASS reduction opcodes {ops}")
    saved = _build.load("diffint")
    try:
        scenes = {}
        ds = cs.diff_scene()
        scenes["diff_lambert_512"] = (scene_inputs(ds["sigma"], ds["albedo"], ds["o"],
                                                   ds["d"], ds["vpu"], ds["target"]), 80)
        scenes["train shapes"] = (scene_inputs(*trained_grid()), 40)
        for name, (lib, _, _) in libs.items():
            _build._LIBS["diffint"] = lib
            for scene_name, (sc, _) in scenes.items():
                check(name, scene_name, sc)
        order = list(VARIANTS)
        readings = {s: {v: {"fwd": [], "bwd": []} for v in order} for s in scenes}
        for turn, name in enumerate(order + order[::-1]):
            _build._LIBS["diffint"] = libs[name][0]
            for scene_name, (sc, reps) in scenes.items():
                t = time_turn(sc, reps)
                for mode in ("fwd", "bwd"):
                    readings[scene_name][name][mode].append(t[mode])
                cs.log(f"[trials] turn {turn} {name} on {scene_name}: "
                       + ", ".join(f"{m} {t[m][0]:.4f} ms (device "
                                   f"{'n/a' if t[m][1] is None else f'{t[m][1]:.4f}'})"
                                   for m in ("fwd", "bwd")))
    finally:
        _build._LIBS["diffint"] = saved
    summary = {"device": smi, "ptxas": {n: v[1] for n, v in libs.items()},
               "sass_reductions": {n: v[2] for n, v in libs.items()}, "readings": readings}
    for scene_name, per in readings.items():
        for name, modes in per.items():
            cs.log(f"[trials] {scene_name} {name}: " + "; ".join(
                f"{m} mean {sum(x[0] for x in r) / len(r):.4f} ms, device mean "
                + (f"{sum(x[1] for x in r) / len(r):.4f} ms"
                   if all(x[1] is not None for x in r) else "not measured")
                for m, r in modes.items()))
    with open(OUT_DIR / "diffint_trials.json", "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
