"""The suite's workloads: `bench_suite.py`'s ten and `bench.py`'s headline
on the port's entry points, then four end-to-end metrics of PERF.md §2.

Each workload function builds its inputs from ``seed`` on ``device`` and
returns a `Workload`: ``frame(i)`` runs frame or step i through the
port's entry point (its kernels on a CUDA device, their plain versions
on the CPU), and ``check(i, state, out)`` holds that frame's outputs
against the plain version on the same inputs, at the tolerances
`chip_smoke.py` holds each path to.  ``run(i)`` does both.  Sizes are
arguments, so that the CPU tests run every workload small.

Geometry is the JAX suite's exactly: volumes, cameras, orbits, ring
views, sizes, bounce counts.  Frame i takes row i of a camera table
built up front, so consecutive frames differ as in the JAX loops
(`bench_suite.py:36-57`).  Random inputs (densities, albedos, targets,
plane rays) follow the JAX suite's distributions and shapes, drawn with
`numpy.random.RandomState` from ``seed`` (`jax.random`'s values cannot
be reproduced without JAX).  Three of the JAX suite's `.vox` assets are
absent from the repository; their workloads run on the stand-ins built
in code and say so in `info["scene"]`.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Optional

import numpy as np
import torch

from voxel_tracer_tpu_torch.models.camera import Camera, rays_for_image
from voxel_tracer_tpu_torch.models.volume import VoxelVolume
from voxel_tracer_tpu_torch.utils import profiling

SUN = (-0.619501, 0.465931, -0.631765)     # bench.py:70
# kernel vs plain version on identical inputs: the traversal is the same
# float32 program, so hits, materials, axes and steps must be equal
HIT_MISMATCH_BUDGET = 0
T_ATOL = 1e-5       # depth, kernel vs plain
LSB = 1             # image, kernel vs plain (expf may differ by an ulp)
FRAME_TOL = {"image": LSB, "depth": T_ATOL, "irradiance": T_ATOL}   # others: equal
# integrate kernels (B6/B7) vs their plain versions on identical inputs
INT_ATOL = 1e-5     # color, trans, depth, loss (expf may differ by an ulp)
GRAD_RTOL = 1e-4    # x max|g|: atomics and index_add_ sum in run-dependent orders
T_EPS = 1e-4        # transmittance floor of bench_suite's integrate calls
# the wavefront march on the card vs on the CPU (tests/test_torch_diff.py);
# the CPU reference runs in chunks of WF_CHUNK rays, the forward alone
# on every WF_SUBSET-th ray
WF_ATOL, WF_GRAD_RTOL, WF_SUBSET, WF_CHUNK = 1e-5, 1e-4, 64, 1 << 16
# the surface path: palette[mat]'s backward sorts the indices, so both
# paths sum each row in one order
SF_COLOR_ATOL = 1e-6
SF_GRAD_RTOL = 1e-6
# the size at which the exact and refdepth Whitted frames are held to
# their plain version: at 1280x768 the plain frame takes 15-19 s on the
# card's host (PERF.md), so a 320x192 frame of the same scene stands in
WH_CHECK_SIZE = (320, 192)
WH_SHADOW_ROUNDS = 2
MU_TARGET, MU_OFFSET = (1.0, 0.8, -1.5), (4.0, 2.0, 4.0)   # multi_camera's orbit


# ---------------------------------------------------------------------------
# The workload record and its checks
# ---------------------------------------------------------------------------

def _no_state():
    return None


@dataclasses.dataclass
class Workload:
    """One workload, built: see the module docstring."""

    metric: str
    unit: str
    work: float                 # rays a frame (1 for a training step): value = work / s
    frames: int                 # frames of the long timed run (K; the short is K // 4)
    frame: Callable             # frame(i) -> outputs
    check: Callable             # check(i, state, outputs) -> `checked` dict
    jax_metric: Optional[str] = None
    snapshot: Callable = _no_state      # the state frame(i) starts from, cloned
    graph_frame: Optional[Callable] = None   # graph_frame(i, c) -> c + 1 (one launch)
    subs: dict = dataclasses.field(default_factory=dict)   # name -> Workload, timed alone
    info: dict = dataclasses.field(default_factory=dict)   # fields of the JSON line

    def run(self, i=0):
        """Frame i and its check: (outputs, `checked` dict)."""
        state = self.snapshot()
        out = self.frame(i)
        return out, self.check(i, state, out)


def checked(figures: dict, note: str = None) -> dict:
    """{name: (value, limit)} -> the check's record: correct where every
    value is within its limit, and the worst figure by value / limit (its
    `ratio`)."""
    figs = {k: [float(v), float(lim)] for k, (v, lim) in figures.items()}

    def ratio(vl):
        v, lim = vl
        return v / lim if lim > 0 else (math.inf if v > 0 else 0.0)

    worst = max(figs, key=lambda k: ratio(figs[k]))
    out = {"correct": all(v <= lim for v, lim in figs.values()), "figures": figs,
           "worst": {"name": worst, "value": figs[worst][0], "limit": figs[worst][1],
                     "ratio": ratio(figs[worst])}}
    if note:
        out["note"] = note
    return out


def _maxabs(t):
    return float(t.detach().abs().max()) if t.numel() else 0.0


def _grad_rel(a, b):
    """max |a - b| / max |b|."""
    return _maxabs(a - b) / max(_maxabs(b), 1e-30)


def camera_figures(k, p):
    """A camera kernel frame (rgba, t, aux) vs its plain version."""
    from voxel_tracer_tpu_torch.ops.cuda import mega
    (rk, tk, ak), (rp, tp, ap) = k, p
    hk, hp = tk < mega.BIG, tp < mega.BIG
    both = hk & hp
    return {"hit_mismatches": (int((hk != hp).sum()), HIT_MISMATCH_BUDGET),
            "image_lsb": (_maxabs(mega._unpack_rgb8(rk) - mega._unpack_rgb8(rp)), LSB),
            "depth": (_maxabs(tk[both] - tp[both]), T_ATOL),
            "aux_mismatches": (int((ak != ap).sum()), 0)}


def trace_figures(k, p):
    """Ray-list outputs vs the plain version's: hits and integer fields
    equal, t within T_ATOL."""
    hk, hp = k["t"] < 1e30, p["t"] < 1e30
    both = hk & hp
    figs = {"hit_mismatches": (int((hk != hp).sum()), HIT_MISMATCH_BUDGET),
            "t": (_maxabs(k["t"][both] - p["t"][both]), T_ATOL)}
    for f in ("vox", "mat", "ax", "steps", "resolved"):
        if f in p:
            figs[f"{f}_mismatches"] = (int((k[f] != p[f]).sum()), 0)
    return figs


def field_figures(k, p, tol=None):
    """A frame dict vs the plain version's, field by field: hit masks
    equal, each field's max |d| within ``tol`` (image in 8-bit LSB; depth
    on pixels both hit), 0 for fields ``tol`` does not name (default: every
    field equal)."""
    tol = tol or {}
    hk, hp = k["depth"] < 1e29, p["depth"] < 1e29
    both = hk & hp
    figs = {"hit_mismatches": (int((hk != hp).sum()), HIT_MISMATCH_BUDGET)}
    for f in p:
        a, b = (k[f][both], p[f][both]) if f == "depth" else (k[f], p[f])
        d = _maxabs(a.double() - b.double())
        if f == "image" and a.is_floating_point():
            d *= 255
        figs[f] = (d, tol.get(f, 0.0))
    return figs


def _value(x):
    return float(x.detach()) if isinstance(x, torch.Tensor) else float(x)


def grad_figures(loss_k, grads_k, loss_p, grads_p, atol, grad_rtol, names):
    """A step's loss within ``atol`` and each gradient within ``grad_rtol``
    x max |g| of the plain version's."""
    figs = {"loss": (abs(_value(loss_k) - _value(loss_p)), atol)}
    for n, a, b in zip(names, grads_k, grads_p):
        figs[f"grad_{n}_rel"] = (_grad_rel(a, b), grad_rtol)
    return figs


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# Scenes and cameras shared with chip_smoke.py
# ---------------------------------------------------------------------------

def bench_camera(theta, aspect):
    """bench.py's orbit camera (bench.py:72-78)."""
    px = 2.0 * math.cos(theta) + 2.4 * math.sin(theta)
    pz = -2.4 * math.cos(theta) + 2.0 * math.sin(theta)
    return Camera.create((px, 1.4, pz), (0.0, 0.0, 0.0), aspect)


def bench_volume(grid=64):
    """bench.py's scene: dense noise, 512 bricks at 64^3, all occupied."""
    return VoxelVolume.noise_filled((grid,) * 3, pos=(0, 0, 0), vpu=20.0)


def camera_table(mv, cameras, width, height):
    """The kernel's camera floats of each camera, stacked on the volume's
    device once, up front (bench.py:90-93)."""
    from voxel_tracer_tpu_torch.ops.cuda import mega
    return torch.stack([mega.mega_camera(mv, c, SUN, width, height) for c in cameras])


def batched_rays(mv, thetas, size):
    """bench_suite.py:157-167: the volume-local rays of bench cameras at
    ``thetas``, each view in 32x32-pixel tile order, views concatenated."""
    from voxel_tracer_tpu_torch.ops.composite import _to_local
    from voxel_tracer_tpu_torch.ops.cuda.diffint import tile_raster
    dev = mv.device
    rot, pos, pivot = (x.to(dev) for x in (mv.rot, mv.pos, mv.pivot))
    os_, ds_ = [], []
    for th in thetas:
        o, d = rays_for_image(bench_camera(th, 1.0), size, size, device=dev)
        o_l, d_l = _to_local(rot, pos, pivot, o, d)
        os_.append(tile_raster(o_l, size, size))
        ds_.append(tile_raster(d_l, size, size))
    return torch.cat(os_).contiguous(), torch.cat(ds_).contiguous()


def diff_scene(device="cuda", seed=0, *, grid=64, size=512, vpu=20.0):
    """diff_lambert_512 (bench_suite.py:183-210): the grid^3 blob (exact
    zeros outside, about 15 % of voxels occupied) and size^2 camera rays
    in 32x32-pixel tile order, taken as volume-local rays, with uniform
    random targets."""
    from voxel_tracer_tpu_torch.ops.cuda import diffint
    sigma, albedo = (torch.from_numpy(x).to(device)
                     for x in profiling.blob_field(grid, seed, 40.0, 0.25))
    cam = Camera.create((2.0, 1.4, -2.4), (0.0, 0.0, 0.0), 1.0)
    o, d = (diffint.tile_raster(x, size, size).contiguous()
            for x in rays_for_image(cam, size, size, device=device))
    n = o.shape[0]
    target = torch.from_numpy(np.random.RandomState(seed + 7).rand(n, 3)
                              .astype(np.float32)).to(device)
    return dict(sigma=sigma, albedo=albedo, o=o, d=d, target=target, vpu=vpu, cam=cam)


def whitted_config(width, height, bounces=3, glass_reflections=2, **kw):
    """full_whitted_720p's RenderConfig (bench_suite.py:435-437)."""
    from voxel_tracer_tpu_torch.renderer import RenderConfig
    return RenderConfig(width=width, height=height, shading="full", max_bounces=bounces,
                        glass_reflections=glass_reflections, **{"compact": True, **kw})


def whitted_launches(n_glass, bounces, glass_reflections, shadow_rounds=WH_SHADOW_ROUNDS):
    """bench_suite.py:446-450: trace launches a frame (1 camera + ray lists)
    when every stage runs."""
    glass_sub = glass_reflections * n_glass + (glass_reflections - 1) * (1 + 2 * n_glass)
    return (1 + bounces * 3 * shadow_rounds
            + (bounces - 1) * ((1 + 2 * n_glass) + glass_sub))


def multi_scene():
    """make_drone_scene's default scene (procedural stand-ins unless
    VOXEL_TRACER_ASSET_DIR names the reference's assets): the glass box and
    four drones turned to yaws != 0 as Enemy.tick sets them, one live laser
    capsule toward drone 1 and seven parked ones (game_demo's 8 slots)."""
    from voxel_tracer_tpu_torch.game.enemy import _yaw_matrix
    from voxel_tracer_tpu_torch.ops.cuda.multi import make_drone_scene
    vols, scene = make_drone_scene()
    for i, v in enumerate(vols[1:]):
        v.set_rotation(_yaw_matrix(0.4 + 0.9 * i))
    scene.add_capsule((2.6, 2.9, -2.2), tuple(vols[2].pos), 0.02)
    far = np.array([1e5, 1e5, 1e5], np.float32)
    for _ in range(7):
        scene.add_capsule(far, far + np.array([0, 0, 0.01], np.float32), 0.02)
    return vols, scene


def multi_camera(theta, width, height):
    """A camera orbiting MU_TARGET (angle 10 theta about y): at theta = 0
    it sees the glass box, the mirror plate's face, the four drones and
    the laser (stand-in layout; outside every volume's grid)."""
    a = theta * 10.0
    ox, oy, oz = MU_OFFSET
    pos = (MU_TARGET[0] + ox * math.cos(a) - oz * math.sin(a), MU_TARGET[1] + oy,
           MU_TARGET[2] + ox * math.sin(a) + oz * math.cos(a))
    return Camera.create(pos, MU_TARGET, width / height)


def multi_config(width, height, bounces=2):
    """game_demo's frame config (--bounces 2, glass reflections 2)."""
    return whitted_config(width, height, bounces, 2)


def build_multi(mvs, **kw):
    from voxel_tracer_tpu_torch.ops.cuda.multi import MultiMegaIntersector
    from voxel_tracer_tpu_torch.ops.cuda.whitted import MegaIntersector
    return MultiMegaIntersector([MegaIntersector(mv, shadow_rounds=WH_SHADOW_ROUNDS,
                                                 compact=True, **kw) for mv in mvs])


def crate_volume(crates_per_axis=8):
    """The 512-crate profiling scene baked into one grid (256^3 at 8 per
    axis; bench_suite.py:355)."""
    from voxel_tracer_tpu_torch.ops.cuda.renderer_fast import bake_aligned_scene
    return bake_aligned_scene(profiling.profiling_volumes(crates_per_axis))


def dolly_cameras(aspect, frames):
    """bench_suite.py:362: the profiling pose, moved by theta * 1e-5 along
    each axis at theta = 0.01 i."""
    cam0 = profiling.profiling_camera(aspect)
    return [cam0._replace(pos=cam0.pos + 0.01 * i * 1e-5) for i in range(frames)]


# ---------------------------------------------------------------------------
# Builders shared by several workloads
# ---------------------------------------------------------------------------

def _camera_workload(metric, jax_metric, mv, cameras, width, height, info):
    """B1 frames (`render_mega_tiles`, flat, analytic sky) over a camera
    table; the one-launch frame feeds each frame's first pixel x 1e-38
    into the next frame's camera (bench.py:100-107)."""
    from voxel_tracer_tpu_torch.ops.cuda import mega
    cams = camera_table(mv, cameras, width, height)
    n = cams.shape[0]
    kw = dict(width=width, height=height)

    def frame(i):
        return mega.render_mega_tiles(cams[i % n], mv.tables, **kw)

    def check(i, _state, out):
        return checked(camera_figures(out, mega.render_mega_tiles_plain(cams[i % n], mv.tables,
                                                                         **kw)))

    def graph_frame(i, c):
        rgba, _t, _aux = mega.render_mega_tiles(cams[i % n] + c * 1e-38, mv.tables, **kw)
        return c + 1.0 + rgba[0, 0].to(torch.float32) * 1e-38

    return Workload(metric, "rays/s", width * height, n, frame, check, jax_metric,
                    graph_frame=graph_frame, info=info)


def _frame_check(render, kernel, plain, size, check_size, tag):
    """check(i, state, out) of a frame ``render(ix, i, w, h)``: ``out``
    against the plain intersector's frame at full ``size``, or, where
    ``check_size`` is given, a kernel frame against a plain frame at that
    size (noted in the line), every field equal (`field_figures`); the
    plain frame's host seconds go into the record as `plain_s`."""
    w, h = check_size or size

    def check(i, _state, out):
        k = out if check_size is None else render(kernel, i, w, h)
        t0 = time.perf_counter()
        p = render(plain, i, w, h)
        _sync(p["depth"].device)
        plain_s = time.perf_counter() - t0
        note = None if check_size is None else (
            f"{tag} checked at {w}x{h}, not the timed {size[0]}x{size[1]} frame")
        return dict(checked(field_figures(k, p), note), plain_s=plain_s)
    return check


# ---------------------------------------------------------------------------
# The JAX suite's workloads (bench.py, bench_suite.py), in its order
# ---------------------------------------------------------------------------

def primary_rays_per_s_1080p(device="cuda", seed=0, *, width=1920, height=1088,
                             frames=64, grid=64):
    """1. bench.py:56-133: B1 flat frames of the dense 64^3 noise volume at
    1920x1088, orbit cameras 0.01 rad apart."""
    from voxel_tracer_tpu_torch.ops.cuda import mega
    mv = mega.MegaVolume(bench_volume(grid), device)
    cams = [bench_camera(0.01 * i, width / height) for i in range(frames)]
    return _camera_workload("primary_rays_per_s_1080p", "primary_rays_per_s_1080p", mv, cams,
                            width, height, {"size": [width, height], "scene": "noise 64^3"})


def flat_256_dense64(device="cuda", seed=0, *, size=256, frames=64, batch=8,
                     batched_frames=16, grid=64):
    """2. bench_suite.py:116-180: B1 frames at 256x256; then 8 frames'
    local rays in 32x32-pixel tiles through one B2 launch
    (`batched8_rays_per_s`)."""
    from voxel_tracer_tpu_torch.ops.cuda import mega
    mv = mega.MegaVolume(bench_volume(grid), device)
    cams = [bench_camera(0.01 * i, 1.0) for i in range(frames)]
    wl = _camera_workload("flat_256_dense64", "flat_256_dense64", mv, cams, size, size,
                          {"size": [size, size], "scene": "noise 64^3", "batch": batch})
    rows = [batched_rays(mv, [0.01 * (j + k) for k in range(batch)], size)
            for j in range(batched_frames)]

    def bframe(i):
        o, d = rows[i % batched_frames]
        return mega.trace_rays(o, d, mv.tables)

    def bcheck(i, _state, out):
        o, d = rows[i % batched_frames]
        return checked(trace_figures(out, mega.trace_rays_plain(o, d, mv.tables)))

    wl.subs["batched8_rays_per_s"] = Workload("batched8_rays_per_s", "rays/s",
                                              batch * size * size, batched_frames, bframe,
                                              bcheck)
    return wl


def _sgd_step(render, params, loss_fn, lr):
    """frame(i): a gradient step of loss_fn(render(*params)) with SGD at
    ``lr`` (the JAX suite's `p - lr * g` loops), returning the loss, the
    gradients and the forward outputs; and the snapshot of ``params``."""
    def frame(_i):
        out = render(*params)
        loss = loss_fn(out)
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            for p, g in zip(params, grads):
                p.sub_(lr * g)
        return dict({k: out[k].detach() for k in ("color", "trans", "depth")},
                    loss=loss.detach(), grads=grads)

    def snapshot():
        return tuple(p.detach().clone() for p in params)

    return frame, snapshot


def _plain_grad_check(render_plain, loss_fn, names):
    """check(i, state, out): the step's loss and gradients against
    loss_fn(render_plain(*state)) and its gradients."""
    def check(_i, state, out):
        ps = tuple(s.clone().requires_grad_() for s in state)
        loss = loss_fn(render_plain(*ps))
        grads = torch.autograd.grad(loss, ps)
        return checked(grad_figures(out["loss"], out["grads"], loss, grads, INT_ATOL, GRAD_RTOL,
                                    names))
    return check


def diff_lambert_512(device="cuda", seed=0, *, grid=64, size=512, frames=8):
    """3. bench_suite.py:272-309: render_density_mega (B6) and its autograd
    backward (B7) on the diff scene, an SGD step of mean((color -
    target)^2) a frame; the forward alone as `pallas_fwd_rays_per_s`."""
    from voxel_tracer_tpu_torch.ops.cuda import diffint
    sc = diff_scene(device, seed, grid=grid, size=size)
    o, d, vpu, target = sc["o"], sc["d"], sc["vpu"], sc["target"]
    params = (sc["sigma"].clone().requires_grad_(), sc["albedo"].clone().requires_grad_())

    def render(s, a):
        return diffint.render_density_mega(s, a, o, d, vpu, t_eps=T_EPS)

    def render_plain(s, a):
        return diffint.render_density_mega_plain(s, a, o, d, vpu, t_eps=T_EPS)

    def loss_of(out):
        return torch.mean((out["color"] - target) ** 2)

    frame, snapshot = _sgd_step(render, params, loss_of, 1e-6)
    check = _plain_grad_check(render_plain, loss_of, ("sigma", "albedo"))
    n = o.shape[0]
    wl = Workload("diff_lambert_512", "bwd_rays/s", n, frames, frame, check,
                  "diff_lambert_512", snapshot=snapshot,
                  info={"size": [size, size], "grid": grid, "t_eps": T_EPS})

    def fwd(_i):
        with torch.no_grad():
            return render(*params)

    def fwd_check(_i, _state, out):
        with torch.no_grad():
            p = render_plain(*params)
        return checked({k: (_maxabs(out[k] - p[k]), INT_ATOL) for k in ("color", "trans",
                                                                        "depth")})

    wl.subs["pallas_fwd_rays_per_s"] = Workload("pallas_fwd_rays_per_s", "rays/s", n, frames,
                                                fwd, fwd_check)
    return wl


def plane_rays(n, grid, seed):
    """Workload 4's rays (numpy): origins spread over the plane z = -0.5 in
    front of a grid of ``grid`` voxels at vpu 20, one direction for all."""
    u = np.random.RandomState(seed + 3).rand(n, 2).astype(np.float32) * np.float32(grid / 20.0)
    o = np.stack([u[:, 0], u[:, 1], np.full(n, -0.5, np.float32)], axis=1)
    d0 = np.array([0.15, 0.1, 1.0], np.float32)
    d0 /= np.linalg.norm(d0)
    return (np.ascontiguousarray(o, np.float32),
            np.ascontiguousarray(np.broadcast_to(d0, (n, 3)), np.float32))


def diff_lambert_512_wavefront(device="cuda", seed=0, *, grid=64, size=512, max_steps=128,
                               frames=2):
    """4. bench_suite.py:218-247: the JAX suite's non-Pallas path,
    `render_density` (D2 forward, D3 backward: `ops/cuda/diff.py`) under
    torch.autograd on rays from a plane in front of the blob; an SGD step
    of mean(color^2) a frame, the forward alone as
    `wavefront_fwd_rays_per_s`.  The step is held against the plain march
    (`ops/diff.py`) on the CPU on every ray, its forward alone on every
    WF_SUBSET-th ray."""
    from voxel_tracer_tpu_torch.ops import diff
    from voxel_tracer_tpu_torch.ops.cuda import diff as diff_kernel
    n = size * size
    sigma, albedo = (torch.from_numpy(x).to(device)
                     for x in profiling.blob_field(grid, seed, 40.0, 0.25))
    o, d = (torch.from_numpy(x).to(device) for x in plane_rays(n, grid, seed))
    vpu = 20.0
    params = (sigma.clone().requires_grad_(), albedo.clone().requires_grad_())
    sub = slice(None, None, WF_SUBSET)

    def render(s, a, oo=o, dd=d, march=diff_kernel.render_density):
        return march(s, a, oo, dd, vpu, max_steps)

    def loss_of(out):
        return torch.mean(out["color"] ** 2)

    frame, snapshot = _sgd_step(render, params, loss_of, 1e-6)

    def cpu_reference(state):
        """The CPU port's forward outputs on every ray and the gradients of
        the frame's loss at ``state``: mean(color^2) over all n rays as a
        sum over chunks of WF_CHUNK rays."""
        ps = tuple(s.detach().cpu().clone().requires_grad_() for s in state)
        o_c, d_c = o.cpu(), d.cpu()
        outs, loss, grads = {k: [] for k in ("color", "trans", "depth")}, 0.0, None
        for a in range(0, n, WF_CHUNK):
            out = render(*ps, o_c[a:a + WF_CHUNK], d_c[a:a + WF_CHUNK], diff.render_density)
            part = torch.sum(out["color"] ** 2) / (3.0 * n)
            g = torch.autograd.grad(part, ps)
            grads = g if grads is None else tuple(x + y for x, y in zip(grads, g))
            loss += float(part.detach())
            for k in outs:
                outs[k].append(out[k].detach())
        return {k: torch.cat(v) for k, v in outs.items()}, loss, grads

    def check(_i, state, out):
        ref, loss, grads = cpu_reference(state)
        figs = {k: (_maxabs(out[k].cpu() - ref[k]), WF_ATOL)
                for k in ("color", "trans", "depth")}
        figs.update(grad_figures(out["loss"], tuple(g.cpu() for g in out["grads"]), loss,
                                 grads, WF_ATOL, WF_GRAD_RTOL, ("sigma", "albedo")))
        return checked(figs, f"the step vs the CPU port on all {n} rays")

    wl = Workload("diff_lambert_512_wavefront", "bwd_rays/s", n, frames, frame, check,
                  "diff_lambert_512_xla", snapshot=snapshot,
                  info={"size": [size, size], "grid": grid, "max_steps": max_steps})

    def fwd(_i):
        with torch.no_grad():
            out = render(*params)
        return {k: out[k] for k in ("color", "trans", "depth")}

    def fwd_check(_i, _state, out):
        with torch.no_grad():
            ref = diff.render_density(*(p.detach().cpu() for p in params), o[sub].cpu(),
                                      d[sub].cpu(), vpu, max_steps)
        return checked({k: (_maxabs(out[k][sub].cpu() - ref[k]), WF_ATOL)
                        for k in ("color", "trans", "depth")},
                       f"card vs CPU on every {WF_SUBSET}th ray")

    wl.subs["wavefront_fwd_rays_per_s"] = Workload("wavefront_fwd_rays_per_s", "rays/s", n,
                                                   frames, fwd, fwd_check)
    return wl


def diff_surface_512(device="cuda", seed=0, *, size=512, grid=64, frames=4):
    """5. bench_suite.py:250-269: palette_fit_loss_mega (B1 + B2 under
    autograd) on the noise volume at 512x512 from the diff scene's camera,
    an SGD step of the grey palette a frame."""
    from voxel_tracer_tpu_torch.ops import diff_surface
    from voxel_tracer_tpu_torch.ops.cuda import mega
    mv = mega.MegaVolume(VoxelVolume.noise_filled((grid,) * 3, vpu=20.0), device)
    cam = Camera.create((2.0, 1.4, -2.4), (0.0, 0.0, 0.0), 1.0)
    n = size * size
    pal = torch.full((256, 3), 0.5, device=device, requires_grad=True)
    tgt = torch.zeros((n, 3), device=device)

    def loss(p, **kw):
        return diff_surface.palette_fit_loss_mega(p, mv, cam, size, size, tgt, **kw)

    def frame(_i):
        lv = loss(pal)
        (g,) = torch.autograd.grad(lv, pal)
        with torch.no_grad():
            pal.sub_(1e-3 * g)
        return dict(loss=lv.detach(), grads=(g,))

    def check(_i, state, out):
        p = state.clone().requires_grad_()
        lv = loss(p, lambert_fn=mega.render_lambert_mega_plain)
        (g,) = torch.autograd.grad(lv, p)
        return checked(grad_figures(out["loss"], out["grads"], lv, (g,), SF_COLOR_ATOL,
                                    SF_GRAD_RTOL, ("palette",)))

    return Workload("diff_surface_512", "bwd_rays/s", n, frames, frame, check,
                    "diff_surface_512", snapshot=lambda: pal.detach().clone(),
                    info={"size": [size, size], "scene": "noise 64^3, one material"})


def vox_brickmap_720p(device="cuda", seed=0, *, width=1280, height=768, frames=64):
    """6. bench_suite.py:312-343: B1 frames of the 16^3 crate at 1280x768 on
    its orbit (bench_suite.py:328-329)."""
    from voxel_tracer_tpu_torch.ops.cuda import mega
    mv = mega.MegaVolume(VoxelVolume(profiling._procedural_crate(16)), device)
    cams = []
    for i in range(frames):
        th = 0.01 * i
        cams.append(Camera.create((1.6 * math.cos(th), 1.1,
                                   -1.6 * math.cos(th) + 1.2 * math.sin(th)),
                                  (0.0, 0.0, 0.0), width / height))
    return _camera_workload("vox_brickmap_720p", "vox_brickmap_720p", mv, cams, width, height,
                            {"size": [width, height],
                             "scene": "stand-in for crate-16.vox: utils/profiling."
                                      "_procedural_crate(16), 16^3"})


def multiobj_shadow_1080p(device="cuda", seed=0, *, width=1920, height=1088, frames=16,
                          crates_per_axis=8):
    """7. bench_suite.py:346-378: render_lambert_mega (B1 + B2, primary and
    sun shadow ray a pixel) on the 512-crate scene baked into one grid,
    the profiling pose dollied 1e-7 a frame."""
    from voxel_tracer_tpu_torch.ops.cuda import mega
    mv = mega.MegaVolume(crate_volume(crates_per_axis), device)
    cams = dolly_cameras(width / height, frames)

    def frame(i):
        return mega.render_lambert_mega(mv, cams[i % frames], width, height)

    def check(i, _state, out):
        return checked(field_figures(out, mega.render_lambert_mega_plain(
            mv, cams[i % frames], width, height), FRAME_TOL))

    return Workload("multiobj_shadow_1080p", "rays/s", 2 * width * height, frames, frame,
                    check, "multiobj_shadow_1080p",
                    info={"size": [width, height], "scene": "512 crates baked, "
                          f"{'x'.join(map(str, mv.volume.grid.shape[::-1]))}"})


def _whitted(metric, jax_metric, device, *, width, height, bounces, glass_reflections,
             frames, exact, grid, check_size):
    """8-10. bench_suite.py:381-470 on render_whitted_mega (B1 + B2; 9's
    fallback on D1)."""
    from voxel_tracer_tpu_torch.ops import dda
    from voxel_tracer_tpu_torch.ops.cuda import mega
    from voxel_tracer_tpu_torch.ops.cuda.whitted import MegaIntersector, render_whitted_mega
    merged, scene = profiling.glass_box_scene(grid)
    sd = scene.data(device)
    mv = mega.MegaVolume(merged, device)
    kw = dict(shadow_rounds=WH_SHADOW_ROUNDS, compact=True, exact_fallback=exact)
    isect = MegaIntersector(mv, **kw)
    plain = MegaIntersector(mv, trace_fn=mega.trace_rays_plain,
                            tiles_fn=mega.render_mega_tiles_plain,
                            dda_fn=dda.intersect_volume_local, **kw)

    def render(ix, i, w, h):
        cam = profiling.glass_box_camera(merged, 0.01 * (i % frames), w, h)
        return render_whitted_mega(ix, sd, cam, w, h, 0,
                                   config=whitted_config(w, h, bounces, glass_reflections))

    def frame(i):
        return render(isect, i, width, height)

    check = _frame_check(render, isect, plain, (width, height), check_size, metric)
    n_glass = len(isect.glass_ids)
    return Workload(metric, "primary_rays/s", width * height, frames, frame, check, jax_metric,
                    info={"size": [width, height],
                          "kernel_launches_per_frame": whitted_launches(n_glass, bounces,
                                                                        glass_reflections),
                          "compact": True, "exact_fallback": exact,
                          "config": {"bounces": bounces, "glass_reflections": glass_reflections,
                                     "shadow_rounds": WH_SHADOW_ROUNDS,
                                     "glass_ids": isect.glass_ids},
                          "scene": f"stand-in for testing/glass-box.vox and enemy-drone.vox: "
                                   f"utils/profiling.glass_box_scene({grid})"})


def full_whitted_720p(device="cuda", seed=0, *, width=1280, height=768, frames=16, grid=128,
                      check_size=None):
    """8. bench_suite.py:381-470: 3 bounces, 2 glass reflections, 2 shadow
    rounds, compacted."""
    return _whitted("full_whitted_720p", "full_whitted_720p", device, width=width,
                    height=height, bounces=3, glass_reflections=2, frames=frames,
                    exact=False, grid=grid, check_size=check_size)


def full_whitted_exact_720p(device="cuda", seed=0, *, width=1280, height=768, frames=8,
                            grid=128, check_size=WH_CHECK_SIZE):
    """9. bench_suite.py:585-592: as 8 with exact_fallback=True."""
    return _whitted("full_whitted_exact_720p", "full_whitted_exact_720p", device, width=width,
                    height=height, bounces=3, glass_reflections=2, frames=frames,
                    exact=True, grid=grid, check_size=check_size)


def full_whitted_refdepth_720p(device="cuda", seed=0, *, width=1280, height=768, frames=8,
                               grid=128, check_size=WH_CHECK_SIZE):
    """10. bench_suite.py:560-582 at the reference's depth, 8 bounces and 8
    glass reflections (materials.cpp:16,128): the port has no compile
    whose limit made the JAX suite step down a ladder."""
    return _whitted("full_whitted_refdepth_720p", "full_whitted_refdepth_720p", device,
                    width=width, height=height, bounces=8, glass_reflections=8,
                    frames=frames, exact=False, grid=grid, check_size=check_size)


def inverse_data(seed, grid, views, px, vpu):
    """inverse_128_32views' rays (ring views, numpy) and uniform targets."""
    o, d = profiling.ring_views(grid, views, px, vpu)
    target = np.random.RandomState(seed).rand(o.shape[0], 3).astype(np.float32)
    return o, d, target


def inverse_128_32views(device="cuda", seed=0, *, grid=128, views=32, px=64, vpu=20.0,
                        slabs=8, frames=16):
    """11. bench_suite.py:473-557: render_density_slabs (8 z-slabs, B6 / B7)
    under autograd and torch.optim.Adam(lr 1e-2) on a uniform random
    grid^3 sigma + albedo, all 131,072 ring-view rays a step."""
    from voxel_tracer_tpu_torch.ops.cuda import diffint
    o, d, target = inverse_data(seed, grid, views, px, vpu)
    o, d, target = (torch.from_numpy(x).to(device) for x in (o, d, target))
    rng = np.random.RandomState(seed + 1)
    params = (torch.from_numpy(rng.rand(grid, grid, grid).astype(np.float32)).to(device),
              torch.from_numpy(rng.rand(grid, grid, grid, 3).astype(np.float32)).to(device))
    params = tuple(p.requires_grad_() for p in params)
    opt = torch.optim.Adam(params, lr=1e-2)

    def loss_of(out):
        return torch.mean((out["color"] - target) ** 2)

    def frame(_i):
        loss = loss_of(diffint.render_density_slabs(*params, o, d, vpu, slabs, t_eps=T_EPS))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        grads = tuple(p.grad for p in params)
        opt.step()
        return dict(loss=loss.detach(), grads=grads)

    check = _plain_grad_check(
        lambda s, a: diffint.render_density_slabs_plain(s, a, o, d, vpu, slabs, t_eps=T_EPS),
        loss_of, ("sigma", "albedo"))

    n = o.shape[0]
    return Workload("inverse_128_32views", "train_steps/s", 1, frames, frame, check,
                    "inverse_128_32views",
                    snapshot=lambda: tuple(p.detach().clone() for p in params),
                    info={"bwd_rays_per_step": n, "rays_per_step": n, "grid": grid,
                          "views": views, "slabs": slabs})


# ---------------------------------------------------------------------------
# PERF.md §2's end-to-end metrics that the JAX suite lacks
# ---------------------------------------------------------------------------

def lambert_mega_1080p(device="cuda", seed=0, *, width=1920, height=1088, frames=32, grid=64):
    """12. render_lambert_mega (B1 + B2) on the bench scene, bench.py's
    orbit."""
    from voxel_tracer_tpu_torch.ops.cuda import mega
    mv = mega.MegaVolume(bench_volume(grid), device)
    cams = [bench_camera(0.01 * i, width / height) for i in range(frames)]

    def frame(i):
        return mega.render_lambert_mega(mv, cams[i % frames], width, height, sun_dir=SUN)

    def check(i, _state, out):
        return checked(field_figures(out, mega.render_lambert_mega_plain(
            mv, cams[i % frames], width, height, sun_dir=SUN), FRAME_TOL))

    return Workload("lambert_mega_1080p", "primary_rays/s", width * height, frames, frame,
                    check, info={"size": [width, height], "scene": "noise 64^3"})


def lambert_fast_crate_1080p(device="cuda", seed=0, *, width=1920, height=1088, frames=16,
                             crates_per_axis=8):
    """13. render_lambert_fast (B5, primary and shadow pass) on the
    512-crate scene baked into one grid, the profiling pose dollied as in
    workload 7."""
    from voxel_tracer_tpu_torch.ops.cuda import renderer_fast
    scene = renderer_fast.FastScene.build([crate_volume(crates_per_axis)], device=device)
    cams = dolly_cameras(width / height, frames)

    def frame(i):
        return renderer_fast.render_lambert_fast(scene, cams[i % frames], width, height)

    def check(i, _state, out):
        return checked(field_figures(out, renderer_fast.render_lambert_fast_plain(
            scene, cams[i % frames], width, height)))

    return Workload("lambert_fast_crate_1080p", "primary_rays/s", width * height, frames, frame,
                    check, info={"size": [width, height], "scene": "512 crates baked"})


def default_scene_720p(device="cuda", seed=0, *, width=1280, height=768, frames=4,
                       check_size=None):
    """14. render_whitted_multi (B2 per volume) over make_drone_scene's five
    volumes with game_demo's config, orbiting 0.01 rad a frame."""
    from voxel_tracer_tpu_torch.ops.cuda import mega
    from voxel_tracer_tpu_torch.ops.cuda.multi import render_whitted_multi
    vols, scene = multi_scene()
    sd = scene.data(device)
    mvs = [mega.MegaVolume(v, device) for v in vols]
    multi, plain = build_multi(mvs), build_multi(mvs, trace_fn=mega.trace_rays_plain)

    def render(m, i, w, h):
        return render_whitted_multi(m, sd, multi_camera(0.001 * (i % frames), w, h), w, h, 0,
                                    config=multi_config(w, h))

    def frame(i):
        return render(multi, i, width, height)

    check = _frame_check(render, multi, plain, (width, height), check_size,
                         "default_scene_720p")

    return Workload("default_scene_720p", "primary_rays/s", width * height, frames, frame,
                    check, info={"size": [width, height], "volumes": len(vols),
                                 "scene": "stand-in for glass-box.vox and enemy-drone.vox: "
                                          "ops/cuda/multi.make_drone_scene"})


def train_step_inverse_128(device="cuda", seed=0, *, grid=128, views=32, px=64, vpu=20.0,
                           frames=16):
    """15. Trainer(backend="kernel").fit (B6, B7) on inverse_128_32views'
    data, 131,072 rays a step: one step a frame."""
    from voxel_tracer_tpu_torch.ops.cuda import diffint
    from voxel_tracer_tpu_torch.trainer import (KERNEL_T_EPS, PARAM_NAMES, TrainConfig,
                                                Trainer, draw_batch)
    o, d, c = inverse_data(seed, grid, views, px, vpu)
    n = o.shape[0]
    cfg = TrainConfig(grid_size=(grid,) * 3, vpu=vpu, lr=1e-2, steps=0, rays_per_batch=n,
                      backend="kernel")
    tr = Trainer(cfg, device=device)
    # Trainer.fit draws its batches from RandomState(0) on each call: a
    # call of one step takes this batch
    idx = draw_batch(np.random.RandomState(0), n, n, "kernel")
    batch = tuple(torch.from_numpy(np.ascontiguousarray(a[idx])).to(device) for a in (o, d, c))

    def frame(_i):
        tr.cfg.steps += 1
        losses = tr.fit(o, d, c, log_every=1, log_fn=lambda _s: None)
        return dict(loss=losses[-1], grads=tuple(tr.params[k].grad for k in PARAM_NAMES))

    ob, db, cb = batch
    check = _plain_grad_check(
        lambda s, a: diffint.render_density_mega_plain(s, a, ob, db, vpu, t_eps=KERNEL_T_EPS),
        lambda out: torch.mean((out["color"] - cb) ** 2), PARAM_NAMES)

    return Workload("train_step_inverse_128", "train_steps/s", 1, frames, frame, check,
                    snapshot=lambda: tuple(tr.params[k].detach().clone() for k in PARAM_NAMES),
                    info={"rays_per_step": n, "grid": grid, "views": views})


# name -> workload function, in the suite's order
WORKLOADS = {f.__name__: f for f in (
    primary_rays_per_s_1080p, flat_256_dense64, diff_lambert_512, diff_lambert_512_wavefront,
    diff_surface_512, vox_brickmap_720p, multiobj_shadow_1080p, full_whitted_720p,
    full_whitted_exact_720p, full_whitted_refdepth_720p, inverse_128_32views,
    lambert_mega_1080p, lambert_fast_crate_1080p, default_scene_720p, train_step_inverse_128)}
