"""Parity: the port's parallel layer at world 2 (two gloo ranks on the
CPU) against the JAX package's sharded steps on conftest's 8 virtual
devices, on `tools/multiproc_worker.py`'s problem.

One spawn of `python -m voxel_tracer_tpu_torch.parallel.worker` per rank
runs every mode (a module fixture); the ranks meet through a file store
in tmp_path (no TCP port, so xdist workers never collide), and each is
killed if it outlives its timeout.  Compared:

- the ray-sharded step (`make_train_step`) against JAX's on the same
  problem: losses within rtol 1e-5 (test_distributed.py's tolerance for
  the same compute on another process topology); with sync_grads=False,
  rank 0 against one process on rank 0's rays: rtol 1e-6;
- `overlap_slabs=4` against JAX's `make_train_step(overlap_slabs=4)` on
  the same problem: rtol 1e-5; and against `overlap_slabs=1`, both at a
  march budget no ray exhausts: rtol 2e-4 (test_grid_train.py's);
- `Trainer.fit` (wavefront) at world 2 against the single-process Trainer:
  rtol 1e-5; only rank 0 writes metrics;
- `Trainer(backend="kernel")` under the group raises a ValueError that
  names the wavefront backend;
- the grid-sharded trace (2 slabs) against the replicated trace, and
  against JAX's replicated `intersect_scene`: test_grid_shard.py's pinned
  budget of 2 hit mismatches, t within 2e-3 on common hits;
- `sharded_render` (full shading, compacted) against the unsharded
  `render_rays`: every field equal.
"""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT_S = 150        # a rank that outlives this is killed
GLOO_TIMEOUT_S = 120        # a collective waiting longer than this fails

LOSS_RTOL = 1e-5            # same compute, other topology (test_distributed.py:94)
SLAB_RTOL = 2e-4            # slab re-association (test_grid_train.py:111, :144)
UNTRUNCATED_STEPS = 96      # > the most cells a ray crosses in a 32^3 grid (94)
TRACE_MISMATCH_BUDGET = 2   # test_grid_shard.py:59 (observed 0 here too)
TRACE_T_ATOL = 2e-3

WORLD2_MODES = ("replicated", f"replicated:{UNTRUNCATED_STEPS}",
                f"overlap:{UNTRUNCATED_STEPS}", "nosync", "trainer", "kernel", "trace:2",
                "render")


def spawn_world(tmp_path, world, modes, timeout=RANK_TIMEOUT_S):
    """Run the worker on ``world`` gloo ranks; rank 0's JSON line."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "voxel_tracer_tpu_torch.parallel.worker",
           "--world", str(world), "--init-method", f"file://{tmp_path}/store",
           "--device", "cpu", "--timeout", str(GLOO_TIMEOUT_S),
           "--mode", ",".join(modes), "--out", str(tmp_path)]
    procs = [subprocess.Popen(cmd + ["--rank", str(r)], env=env, cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{err[-3000:]}"
    return json.loads(outs[0][0].strip().splitlines()[-1])


def jax_problem():
    """The JAX worker's problem, and a check that the port's copy equals it."""
    from voxel_tracer_tpu_torch.parallel import worker
    spec = importlib.util.spec_from_file_location(
        "multiproc_worker", os.path.join(ROOT, "tools", "multiproc_worker.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    ref = mod.build_problem()
    for a, b in zip(ref, worker.build_problem()):
        np.testing.assert_array_equal(a, b)
    return ref


def jax_replicated_losses(max_steps, steps=3, lr=5e-2, overlap_slabs=1):
    """tools/multiproc_worker.py's replicated run (``overlap_slabs`` > 1:
    its overlap run) on 8 virtual devices."""
    import jax
    import optax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from voxel_tracer_tpu.ops.diff import render_density
    from voxel_tracer_tpu.parallel.mesh import RAYS
    from voxel_tracer_tpu.parallel.sharding import make_train_step

    s, a, o, d = jax_problem()
    g = s.shape[0]
    vpu = float(g)
    mesh = Mesh(np.asarray(jax.devices()[:8]), (RAYS,))
    ray_sh, rep = NamedSharding(mesh, P(RAYS)), NamedSharding(mesh, P())
    o, d = jax.device_put(o, ray_sh), jax.device_put(d, ray_sh)
    target = jax.jit(lambda s, a, o, d: render_density(s, a, o, d, vpu, max_steps)["color"])(
        jax.device_put(s, rep), jax.device_put(a, rep), o, d)
    opt = optax.adam(lr)
    params = jax.device_put({"sigma": np.full((g,) * 3, 5.0, np.float32),
                             "albedo": np.full((g,) * 3 + (3,), 0.5, np.float32)}, rep)
    state = jax.device_put(opt.init(params), rep)
    step = make_train_step(mesh, opt, vpu, max_steps=max_steps, overlap_slabs=overlap_slabs)
    losses = []
    for _ in range(steps):
        params, state, loss = step(params, state, o, d, target)
        losses.append(float(loss))
    return losses


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("world2")
    return spawn_world(tmp, 2, WORLD2_MODES), tmp


def test_world2_ran_on_gloo(world2):
    res, _ = world2
    assert res["world"] == 2 and res["backend"] == "gloo" and res["device"] == "cpu"
    assert set(res["modes"]) == set(WORLD2_MODES)


def test_ray_sharded_step_matches_jax(world2):
    res, _ = world2
    got = res["modes"]["replicated"]
    assert got["rays_per_rank"] == 256 and got["march_steps"] == 48
    lp = np.asarray(got["losses"])
    assert np.all(np.isfinite(lp)) and lp[-1] < lp[0], lp
    np.testing.assert_allclose(lp, jax_replicated_losses(48), rtol=LOSS_RTOL)


def test_overlap_slabs_match_jax(world2):
    """The per-slab origin shift, the composition order and the per-slab
    gradient averages against JAX's overlap step on the same problem."""
    got = world2[0]["modes"][f"overlap:{UNTRUNCATED_STEPS}"]
    assert got["march_steps"] == UNTRUNCATED_STEPS
    np.testing.assert_allclose(got["losses"], jax_replicated_losses(UNTRUNCATED_STEPS,
                                                                    overlap_slabs=4),
                               rtol=LOSS_RTOL)


def test_overlap_slabs_match_one_reduction(world2):
    res, _ = world2
    one = res["modes"][f"replicated:{UNTRUNCATED_STEPS}"]["losses"]
    four = res["modes"][f"overlap:{UNTRUNCATED_STEPS}"]["losses"]
    np.testing.assert_allclose(four, one, rtol=SLAB_RTOL)


def test_unsynced_step_trains_each_shard_alone(world2):
    """sync_grads=False skips both reductions: rank 0 trains on its block
    of the rays as one process would on those rays alone (the same
    compute, so equal)."""
    from voxel_tracer_tpu_torch.parallel import worker
    res, _ = world2
    s, a, o, d, cfg = worker.train_problem("small")
    half = o.shape[0] // 2
    alone = worker.run_train("replicated", (s, a, o[:half], d[:half], cfg), "cpu", 3)
    np.testing.assert_allclose(res["modes"]["nosync"]["losses"], alone["losses"], rtol=1e-6)
    assert abs(res["modes"]["nosync"]["losses"][-1]
               - res["modes"]["replicated"]["losses"][-1]) > 1e-6


def test_trainer_world2_matches_one_process(world2):
    """Trainer.fit pads the batch to the world size and each rank takes
    its block of the same draw, so the losses are the one-process run's;
    only rank 0 writes the metrics stream."""
    from voxel_tracer_tpu_torch.parallel import worker
    res, tmp = world2
    got = res["modes"]["trainer"]
    assert got["world"] == 2
    one = worker.run_trainer(worker.train_problem("small"), "cpu", 3)
    assert one["world"] == 1
    np.testing.assert_allclose(got["losses"], one["losses"], rtol=LOSS_RTOL)
    lines = (tmp / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(x)["step"] for x in lines] == [1, 2, 3]


def test_kernel_backend_refuses_a_group(world2):
    res, _ = world2
    err = res["modes"]["kernel"]["error"]
    assert err is not None and "wavefront" in err


def test_grid_sharded_trace_matches_replicated(world2):
    """Two z-slabs over GRID vs the replicated trace (rank 0's own) and
    vs JAX's `intersect_scene` on the same volume and rays."""
    import jax.numpy as jnp
    from voxel_tracer_tpu.models.camera import Camera
    from voxel_tracer_tpu.models.camera import rays_for_image
    from voxel_tracer_tpu.models.scene import Scene
    from voxel_tracer_tpu.models.volume import VoxelVolume
    from voxel_tracer_tpu.ops import composite
    from voxel_tracer_tpu_torch.parallel import worker
    res, tmp = world2
    tr = res["modes"]["trace:2"]
    assert tr["rays"] == 1024 and tr["hits"] > 200
    assert tr["mismatches"] <= TRACE_MISMATCH_BUDGET
    assert tr["t_max_diff"] <= TRACE_T_ATOL
    assert tr["mat_equal"] > 0.99 and tr["normal_equal"] > 0.99

    vol, _ = worker.trace_volume(48)
    jvol = VoxelVolume(vol.grid, vol.palette, pos=tuple(vol.pos), vpu=vol.vpu)
    cam = Camera.create((0.1, 0.2, -3.0), (0.1, 0.0, -0.2), 1.0)
    ref = composite.intersect_scene(Scene(volumes=[jvol]).data(), *rays_for_image(cam, 32, 32))
    got = np.load(tmp / "trace_2.npz")
    t_ref, t_got = np.asarray(ref.t), got["t"]
    h_ref, h_got = t_ref < 1e30, t_got < 1e30
    assert (h_ref != h_got).sum() <= TRACE_MISMATCH_BUDGET
    both = h_ref & h_got
    np.testing.assert_allclose(t_got[both], t_ref[both], atol=TRACE_T_ATOL, rtol=1e-4)
    assert (got["mat"][both] == np.asarray(ref.mat)[both]).mean() > 0.99
    assert (np.abs(got["normal"] - np.asarray(jnp.asarray(ref.normal))).max(-1)[both]
            < 1e-5).mean() > 0.99


def test_sharded_render_equals_unsharded(world2):
    """Each rank shades its rows with their global ray indices: the frame
    equals the unsharded one field for field (a shard that restarted its
    noise and shadow seeds at 0 would differ)."""
    res, _ = world2
    r = res["modes"]["render"]
    assert r["glass_hits"] > 0 and r["mirror_hits"] > 0 and 0.05 < r["hit_fraction"] < 0.99
    assert all(v == 0.0 for v in r["max_abs_diff"].values()), r["max_abs_diff"]
