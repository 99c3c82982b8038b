"""The port's benchmark suite (`voxel_tracer_tpu_torch/bench/`) on the CPU.

- Every workload runs one frame or step at a small size (sizes are the
  workload functions' arguments) through the plain versions, and its
  check against the plain version reads `correct`.
- The geometry is the JAX suite's, computed through JAX on the CPU:
  bench.py's orbit camera through JAX `mega.mega_camera`, a ring view of
  inverse_128_32views, the 8-view local rays of flat_256_dense64's
  batched frame (atol 2e-6 on coordinates of a few units: float32
  rounding), and the Whitted launch formula of `bench_suite.py:446-450`
  read out of that file.
- `measure.py`'s alternating rounds and agreement rule on a fake clock,
  and its split of profiler events by kernel.
- Each `__global__` kernel of `csrc/*.cu` (each instantiation of a
  template) maps to exactly one B label.
- The suite imports neither jax nor the JAX package, and its timing path
  raises without a card.
"""

import ast
import inspect
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from voxel_tracer_tpu.models.camera import Camera as JCamera, rays_for_image as j_rays
from voxel_tracer_tpu.models.volume import VoxelVolume as JVolume
from voxel_tracer_tpu.ops.composite import _to_local as j_to_local
from voxel_tracer_tpu.ops.pallas import diffint as jdiffint, mega as jmega

from voxel_tracer_tpu_torch.bench import measure, workloads as wls
from voxel_tracer_tpu_torch.ops.cuda import mega
from voxel_tracer_tpu_torch.utils import timer

ROOT = Path(__file__).resolve().parent.parent

# each workload at a small size on the CPU
SMALL = {
    "primary_rays_per_s_1080p": dict(width=64, height=32, frames=3),
    "flat_256_dense64": dict(size=32, frames=3, batch=2, batched_frames=2),
    "diff_lambert_512": dict(grid=16, size=32, frames=2),
    "diff_lambert_512_wavefront": dict(grid=16, size=64, frames=2, max_steps=32),
    "diff_surface_512": dict(size=32, grid=16, frames=2),
    "vox_brickmap_720p": dict(width=64, height=32, frames=3),
    "multiobj_shadow_1080p": dict(width=64, height=32, frames=2, crates_per_axis=2),
    "full_whitted_720p": dict(width=64, height=32, frames=2, grid=32),
    "full_whitted_exact_720p": dict(width=64, height=32, frames=2, grid=32,
                                    check_size=(32, 16)),
    "full_whitted_refdepth_720p": dict(width=64, height=32, frames=2, grid=32,
                                       check_size=(32, 16)),
    "inverse_128_32views": dict(grid=16, views=2, px=32, slabs=2, frames=2),
    "lambert_mega_1080p": dict(width=64, height=32, frames=2),
    "lambert_fast_crate_1080p": dict(width=64, height=32, frames=2, crates_per_axis=2),
    "default_scene_720p": dict(width=64, height=32, frames=2),
    "train_step_inverse_128": dict(grid=16, views=2, px=32, frames=2),
}


def test_every_workload_has_a_small_size():
    assert list(SMALL) == list(wls.WORKLOADS)
    assert len(wls.WORKLOADS) == 15


@pytest.mark.parametrize("name", list(SMALL))
def test_workload_runs_and_matches_plain_on_cpu(name):
    wl = wls.WORKLOADS[name]("cpu", 0, **SMALL[name])
    assert wl.metric == name and wl.unit in ("rays/s", "primary_rays/s", "bwd_rays/s",
                                             "train_steps/s")
    for w in (wl, *wl.subs.values()):
        _out, chk = w.run(0)
        assert chk["correct"], (w.metric, chk)
        assert chk["worst"]["name"] in chk["figures"]


def test_frame_check_holds_the_timed_frame_or_a_fixed_smaller_one():
    """`_frame_check` holds the timed frame to the plain one at full size,
    or, with a `check_size`, a kernel frame to a plain one at that size;
    which frames are held at which size is data of each workload."""
    calls = []

    def render(tag, _i, w, h):
        calls.append((tag, w, h))
        return {"depth": torch.zeros(h, w)}

    timed = {"depth": torch.zeros(64, 128)}
    chk = wls._frame_check(render, "kernel", "plain", (128, 64), None, "t")(0, None, timed)
    assert chk["correct"] and "note" not in chk and chk["plain_s"] >= 0
    assert calls == [("plain", 128, 64)]
    calls.clear()
    chk = wls._frame_check(render, "kernel", "plain", (128, 64), (64, 32), "t")(0, None, timed)
    assert chk["correct"] and "checked at 64x32" in chk["note"]
    assert calls == [("kernel", 64, 32), ("plain", 64, 32)]
    sizes = {name: inspect.signature(wls.WORKLOADS[name]).parameters["check_size"].default
             for name in ("full_whitted_720p", "full_whitted_exact_720p",
                          "full_whitted_refdepth_720p", "default_scene_720p")}
    assert sizes == {"full_whitted_720p": None, "full_whitted_exact_720p": (320, 192),
                     "full_whitted_refdepth_720p": (320, 192), "default_scene_720p": None}


def test_wavefront_check_holds_the_timed_step_over_chunks(monkeypatch):
    """diff_lambert_512_wavefront's check compares the timed step's
    outputs and gradients on every ray with the CPU port's, summed over
    chunks of WF_CHUNK rays; a wrong gradient reads incorrect."""
    monkeypatch.setattr(wls, "WF_CHUNK", 1000)          # 4096 rays: five chunks
    wl = wls.diff_lambert_512_wavefront("cpu", 0, **SMALL["diff_lambert_512_wavefront"])
    state = wl.snapshot()
    out = wl.frame(0)
    chk = wl.check(0, state, out)
    assert chk["correct"], chk
    assert set(chk["figures"]) == {"color", "trans", "depth", "loss", "grad_sigma_rel",
                                   "grad_albedo_rel"}
    bad = dict(out, grads=(out["grads"][0] * 1.01, out["grads"][1]))
    assert not wl.check(0, state, bad)["correct"]


def test_bench_camera_matches_jax_mega_camera():
    """bench.py:72-78's orbit through JAX mega.mega_camera (1920x1088) vs
    the suite's camera table, at three angles."""
    w, h = 1920, 1088
    vol = wls.bench_volume()
    jmv = jmega.MegaVolume(JVolume.noise_filled((64, 64, 64), pos=(0, 0, 0), vpu=20.0))
    sun = jnp.asarray(wls.SUN, jnp.float32)
    thetas = (0.0, 0.37, 2.5)
    table = wls.camera_table(mega.MegaVolume(vol, "cpu"),
                             [wls.bench_camera(t, w / h) for t in thetas], w, h)
    for k, th in enumerate(thetas):
        theta = jnp.float32(th)
        px = 2.0 * jnp.cos(theta) + 2.4 * jnp.sin(theta)
        pz = -2.4 * jnp.cos(theta) + 2.0 * jnp.sin(theta)
        cam = JCamera.create(jnp.stack([px, jnp.full_like(px, 1.4), pz]), jnp.zeros(3), w / h)
        ref = np.asarray(jmega.mega_camera(jmv, cam, sun, w, h))
        np.testing.assert_allclose(table[k].numpy(), ref, rtol=2e-6, atol=2e-7,
                                   err_msg=f"theta {th}")


def test_ring_view_matches_jax():
    """One ring view of inverse_128_32views (bench_suite.py:489-499)."""
    g, views, px, vpu = 128, 32, 64, 20.0
    o, d, target = wls.inverse_data(0, g, views, px, vpu)
    assert o.shape == (views * px * px, 3) and target.shape == o.shape
    center = g / (2 * vpu)
    v = 5
    th = 2 * np.pi * v / views
    pos = (center + 2.2 * g / vpu / 4 * np.cos(th), center * 1.35,
           center + 2.2 * g / vpu / 4 * np.sin(th))
    jo, jd = j_rays(JCamera.create(pos, (center, center, center), px / px), px, px)
    sl = slice(v * px * px, (v + 1) * px * px)
    np.testing.assert_allclose(o[sl], np.asarray(jdiffint.tile_raster(jo, px, px)), atol=2e-6)
    np.testing.assert_allclose(d[sl], np.asarray(jdiffint.tile_raster(jd, px, px)), atol=2e-6)


def test_batched_rays_match_jax():
    """bench_suite.py:157-167's 8 views of volume-local rays in 32x32
    tiles (at 64x64 a view)."""
    size, batch = 64, 8
    vol = wls.bench_volume()
    jmv = jmega.MegaVolume(JVolume.noise_filled((64, 64, 64), pos=(0, 0, 0), vpu=20.0))
    o, d = wls.batched_rays(mega.MegaVolume(vol, "cpu"), [0.01 * k for k in range(batch)],
                            size)
    ros, rds = [], []
    for k in range(batch):
        th = jnp.float32(0.0) + jnp.float32(k) * 0.01
        px = 2.0 * jnp.cos(th) + 2.4 * jnp.sin(th)
        pz = -2.4 * jnp.cos(th) + 2.0 * jnp.sin(th)
        cam = JCamera.create(jnp.stack([px, jnp.full_like(px, 1.4), pz]), jnp.zeros(3), 1.0)
        jo, jd = j_rays(cam, size, size)
        o_l, d_l = j_to_local(jmv.rot, jmv.pos, jmv.pivot, jo.reshape(-1, 3), jd.reshape(-1, 3))
        ros.append(np.asarray(jdiffint.tile_raster(o_l, size, size)))
        rds.append(np.asarray(jdiffint.tile_raster(d_l, size, size)))
    np.testing.assert_allclose(o.numpy(), np.concatenate(ros), atol=2e-6)
    np.testing.assert_allclose(d.numpy(), np.concatenate(rds), atol=2e-6)


def _bench_suite_launches():
    """bench_suite.py's launch formula (its statements from `per_bounce =`
    to `launches =` in bench_full_whitted), as a function."""
    tree = ast.parse((ROOT / "bench_suite.py").read_text())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "bench_full_whitted")
    stmts = [s for s in fn.body if isinstance(s, ast.Assign) and len(s.targets) == 1
             and getattr(s.targets[0], "id", None) in ("per_bounce", "glass_sub", "launches")]
    assert [s.targets[0].id for s in stmts] == ["per_bounce", "glass_sub", "launches"]
    code = compile(ast.Module(body=stmts, type_ignores=[]), "bench_suite.py", "exec")

    def launches(n_glass, bounces, glass_refl, shadow_rounds):
        ns = dict(n_glass=n_glass, BOUNCES=bounces, GLASS_REFL=glass_refl,
                  SHADOW_ROUNDS=shadow_rounds)
        exec(code, ns)
        return ns["launches"]
    return launches


def test_whitted_launch_formula_matches_bench_suite():
    ref = _bench_suite_launches()
    for n_glass in (0, 1, 2):
        for bounces, refl in ((3, 2), (8, 8), (8, 4), (1, 1)):
            assert wls.whitted_launches(n_glass, bounces, refl, 2) == ref(n_glass, bounces,
                                                                          refl, 2)
    wl = wls.full_whitted_refdepth_720p("cpu", **SMALL["full_whitted_refdepth_720p"])
    glass = wl.info["config"]["glass_ids"]
    assert wl.info["kernel_launches_per_frame"] == ref(len(glass), 8, 8, 2)
    assert wl.info["config"]["bounces"] == 8 and wl.info["config"]["glass_reflections"] == 8


class FakeClock:
    """ms a frame for each call: the next value of the list for the count
    asked; records the counts asked, in order."""

    def __init__(self, by_count):
        self.by_count = {n: list(v) for n, v in by_count.items()}
        self.counts = []

    def __call__(self, frame, n):
        self.counts.append(n)
        return self.by_count[n].pop(0)


def test_alternating_rounds_order_and_agreement():
    clock = FakeClock({4: [10.0, 10.2, 10.4, 10.0, 10.4], 16: [10.5, 10.0, 10.5, 10.0, 10.5]})
    r = measure.alternating_rounds(None, (4, 16), 5, clock=clock)
    # the counts take turns, in alternating order from round to round
    assert clock.counts == [4, 16, 16, 4, 4, 16, 16, 4, 4, 16]
    assert r.agree and r.attempts == 1
    assert r.per == ([10.0, 10.2, 10.4, 10.0, 10.4], [10.5, 10.0, 10.5, 10.0, 10.5])
    assert r.ms == [pytest.approx(10.2), pytest.approx(10.3)]


def test_alternating_rounds_retries_a_disagreeing_pair():
    # attempt 1: means 10 vs 12 (over 10 % apart): measured again; attempt 2 agrees
    clock = FakeClock({1: [10.0] * 3 + [11.0] * 3, 4: [12.0] * 3 + [11.0] * 3})
    logged = []
    r = measure.alternating_rounds(None, (1, 4), 3, clock=clock, log=logged.append)
    assert r.attempts == 2 and r.agree and r.ms == [11.0, 11.0]
    assert len(logged) == 1 and "disagree" in logged[0]
    # never agreeing: ATTEMPTS pairs, reported as disagreeing
    clock = FakeClock({1: [10.0] * 6, 4: [13.0] * 6})
    r = measure.alternating_rounds(None, (1, 4), 2, clock=clock)
    assert r.attempts == measure.ATTEMPTS == 3 and not r.agree
    assert clock.by_count == {1: [], 4: []}
    # a difference of exactly SLOPE_RTOL of the long count's mean agrees
    assert measure.alternating_rounds(None, (1, 4), 1,
                                      clock=FakeClock({1: [9.0], 4: [10.0]})).agree


def test_quartiles():
    q = measure.quartiles([5.0, 1.0, 3.0, 2.0, 4.0])
    assert q == {"median": 3.0, "q1": 2.0, "q3": 4.0, "n": 5}


def test_split_events_by_kernel():
    # names as the profiler prints them on the card
    ev = [("(anonymous namespace)::mega_camera_kernel(float const*, float const*, "
           "(anonymous namespace)::Volume, int)", 0.0, 100.0),
          ("mega_rays_kernel", 100.0, 150.0),
          ("void (anonymous namespace)::integrate_kernel<true>((anonymous namespace)::Params)",
           150.0, 170.0),
          ("void (anonymous namespace)::integrate_kernel<false>((anonymous namespace)::Params)",
           170.0, 180.0),
          ("void at::native::vectorized_elementwise_kernel<4>(int)", 160.0, 190.0),
          ("Memcpy HtoD (Pageable -> Device)", 300.0, 310.0),
          ("void at::native::vectorized_elementwise_kernel<4>(int)", 400.0, 420.0)]
    s = measure.split_events(ev, frames=2, wall_ms=1.0)
    # busy: [0, 190] + [300, 310] + [400, 420] us = 0.22 ms over 2 frames
    assert s["device_busy_ms"] == pytest.approx(0.11)
    assert timer.busy_ms(ev) == pytest.approx(0.22)        # the port's one busy time
    assert s["idle_share"] == pytest.approx(1.0 - 0.22)
    # spans that outlast the wall read below 0, unclamped
    assert measure.split_events(ev, frames=2, wall_ms=0.2)["idle_share"] == pytest.approx(-0.1)
    assert s["kernels_per_frame"] == 3.5
    assert s["kernel_ms"] == {"B1": pytest.approx(0.05), "B2": pytest.approx(0.025),
                              "B6": pytest.approx(0.005), "B7": pytest.approx(0.01)}
    assert s["glue_ms"] == pytest.approx(0.11 - 0.09)
    assert [g["name"] for g in s["top_glue"]] == [
        "void at::native::vectorized_elementwise_kernel<4>(int)",
        "Memcpy HtoD (Pageable -> Device)"]
    assert s["top_glue"][0]["ms"] == pytest.approx(0.025)
    assert measure.label_of("void omega_camera_kernel(int)") is None
    assert measure.label_of("void integrate_kernel<bool>(Params)") is None


def test_count_host_syncs_counts_sync_warnings_only(monkeypatch):
    """Each "called a synchronizing CUDA operation" warning of the sync
    debug mode is a sync; its prototype notice is not."""
    import warnings
    modes = []
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)

    def frame():
        warnings.warn("Synchronization debug mode is a prototype feature and does not yet "
                      "detect all synchronizing operations")
        for _ in range(2):
            warnings.warn("called a synchronizing CUDA operation")
        warnings.warn("an unrelated warning")

    assert measure.count_host_syncs(frame) == 2
    assert modes == [1, 0]


def _global_kernels():
    """Names of the `__global__` kernels of csrc/*.cu, a template as each
    instantiation its launches name (``name<args>``)."""
    names = []
    for path in sorted((ROOT / "voxel_tracer_tpu_torch" / "csrc").glob("*.cu")):
        src = path.read_text()
        for name in re.findall(r"__global__\s+void\s+(?:__\w+__\s*\([^)]*\)\s*)*(\w+)\s*\(",
                               src):
            inst = sorted(set(re.findall(rf"\b({name}<[^<>]+>)\s*<<<", src)))
            names += inst or [name]
    return names


def test_every_kernel_maps_to_one_label():
    """Each kernel of csrc/*.cu has one label: B1-B7 the Pallas kernels'
    counterparts, D1 the DDA's passes (dda_kernel<true>, dda_kernel<false>:
    the brick bitmap from shared or from global memory; dda_exhaust_kernel),
    D2 and D3 the differentiable march's forward and backward, D2 with its
    two templates (diff_fwd_kernel<true>, <false>: on the float4 record, on
    the plain grids) and the record's pack (diff_pack_kernel)."""
    names = _global_kernels()
    assert len(names) == 14, names
    labels = []
    for name in names:
        hits = [lab for key, lab in measure.KERNEL_LABELS.items()
                if measure.label_of(f"void {name}(int)") == lab and key == name]
        assert len(hits) == 1, (name, hits)
        labels += hits
    assert sorted(labels) == [f"B{i}" for i in range(1, 8)] + ["D1"] * 3 + ["D2"] * 3 + ["D3"]


def test_dda_passes_sum_under_one_label():
    """D1's passes, as the profiler prints them, add up under "D1"; a
    longer symbol that ends in the name is glue."""
    ev = [("void (anonymous namespace)::dda_kernel<true>((anonymous namespace)::DdaArgs)",
           0.0, 30.0),
          ("void (anonymous namespace)::dda_kernel<false>((anonymous namespace)::DdaArgs)",
           30.0, 40.0),
          ("void (anonymous namespace)::dda_exhaust_kernel((anonymous namespace)::DdaArgs)",
           40.0, 50.0),
          ("void (anonymous namespace)::mega_rays_kernel(float const*)", 50.0, 60.0),
          ("void at::native::vectorized_elementwise_kernel<4>(int)", 60.0, 80.0)]
    s = measure.split_events(ev, frames=1, wall_ms=0.1)
    assert s["kernel_ms"] == {"B2": pytest.approx(0.01), "D1": pytest.approx(0.05)}
    assert s["glue_ms"] == pytest.approx(0.02)
    assert measure.label_of("void my_dda_kernel<true>(int)") is None
    assert measure.label_of("void dda_kernel<true>2(int)") is None


def test_suite_imports_no_jax():
    code = ("import sys\n"
            "import voxel_tracer_tpu_torch.bench\n"
            "import voxel_tracer_tpu_torch.bench.workloads\n"
            "import voxel_tracer_tpu_torch.bench.measure\n"
            "import voxel_tracer_tpu_torch.bench.__main__\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'voxel_tracer_tpu')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_timing_path_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        measure.measure_workload(wls.flat_256_dense64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        measure.kernel_split(lambda: None, 1, 1.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        measure.graph_time(lambda i, c: c + 1, 1.0, 1)


def test_command_line_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: nothing to refuse")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    for args in ([], ["--one", "flat_256_dense64", "--seed", "3"]):
        proc = subprocess.run([sys.executable, "-m", "voxel_tracer_tpu_torch.bench", *args],
                              cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert proc.stdout == "" and "no CUDA device" in proc.stderr
