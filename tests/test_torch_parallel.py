"""Parity: the port's parallel layer against the JAX package's.

In-process, on seed-made inputs: `compose_slabs`, `split_volume_z`,
`_min_reduce_hits`, `pad_to_multiple`, the batch split of `Trainer.fit`,
`make_sharded_trace`'s blocks, the mesh without a process group, the
JAX-style calls of `make_ray_mesh`, `make_ray_grid_mesh`,
`sharding.shard_rays` and `Trainer(cfg, mesh)`, and the slab composition
against one `render_density` at test_grid_train.py's tolerances.

At world 4 (four gloo ranks on the CPU, one spawn of the worker per rank
for every mode): the grid-sharded step on a (grid 2, rays 2) mesh against
JAX's `make_grid_sharded_train_step` on a (grid 2, rays 4) mesh of
conftest's virtual devices, each rank holding only its slab and its Adam
moments; at a march budget no ray exhausts, the grid-sharded step
against JAX's and against the replicated one; the grid-sharded trace at (rays 1, grid 4) and
(rays 2, grid 2) against the replicated trace.
"""

import numpy as np
import pytest
import torch

from test_torch_distributed import (LOSS_RTOL, SLAB_RTOL, TRACE_MISMATCH_BUDGET,
                                    TRACE_T_ATOL, UNTRUNCATED_STEPS, jax_problem,
                                    spawn_world)

COMPOSE_RTOL = 1e-6         # the same products and sums in the same order
WORLD4_MODES = ("grid", f"grid:{UNTRUNCATED_STEPS}", f"replicated:{UNTRUNCATED_STEPS}",
                "trace:4", "trace:2")


def _rank_mesh(world, rank):
    """Rank ``rank``'s view of a 1-D ray mesh of ``world``, without a
    process group: enough for what needs no collective."""
    from voxel_tracer_tpu_torch.parallel import mesh as tmesh
    return tmesh.Mesh((tmesh.RAYS,), {tmesh.RAYS: world}, {tmesh.RAYS: rank},
                      {tmesh.RAYS: None}, "cpu")


def _slab_problem(g=64, n_rays=512, seed=0):
    """test_grid_train.py's `_problem`: a Gaussian blob, rays from a ring,
    many crossing several z-slabs (numpy)."""
    rng = np.random.RandomState(seed)
    zz, yy, xx = np.meshgrid(*[np.linspace(0, 1, g)] * 3, indexing="ij")
    r2 = (xx - 0.5) ** 2 + (yy - 0.5) ** 2 + (zz - 0.5) ** 2
    sigma = (30.0 * np.exp(-r2 * 25.0)).astype(np.float32)
    albedo = np.stack([xx, yy, 1.0 - xx], axis=-1).astype(np.float32)
    th = rng.rand(n_rays) * 2 * np.pi
    o = np.stack([0.5 + 1.5 * np.cos(th), rng.rand(n_rays) * 0.8 + 0.1,
                  0.5 + 1.5 * np.sin(th)], axis=1).astype(np.float32)
    d = np.array([0.5, 0.5, 0.5], np.float32) - o
    d += rng.randn(n_rays, 3).astype(np.float32) * 0.15
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return sigma, albedo, o, d


def test_compose_slabs_matches_jax():
    from voxel_tracer_tpu.parallel import grid_train as jgt
    from voxel_tracer_tpu_torch.parallel import grid_train as tgt
    rng = np.random.RandomState(3)
    g, n = 4, 257
    T = rng.rand(g, n).astype(np.float32)
    C = rng.rand(g, n, 3).astype(np.float32)
    D = rng.rand(g, n).astype(np.float32) * 5
    dz = rng.randn(n).astype(np.float32)
    dz[:7] = 0.0                                   # dz == 0 composes ascending
    ref = jgt.compose_slabs(T, C, D, dz)
    got = tgt.compose_slabs(*(torch.from_numpy(x) for x in (T, C, D, dz)))
    for r, t in zip(ref, got):
        np.testing.assert_allclose(t.numpy(), np.asarray(r), rtol=COMPOSE_RTOL, atol=1e-7)


def test_slab_composition_matches_render_density():
    """Four z-slabs rendered apart and composed equal one march
    (test_grid_train.py:63-68's tolerances)."""
    from voxel_tracer_tpu_torch.ops import diff
    from voxel_tracer_tpu_torch.parallel.grid_train import compose_slabs, slab_origins
    sigma, albedo, o, d = (torch.from_numpy(x) for x in _slab_problem())
    vpu, steps, g = 64.0, 256, 4
    ref = diff.render_density(sigma, albedo, o, d, vpu, steps)
    zs = sigma.shape[0] // g
    outs = [diff.render_density(sigma[j * zs:(j + 1) * zs], albedo[j * zs:(j + 1) * zs],
                                slab_origins(o, np.float32(j) * np.float32(zs / vpu)), d,
                                vpu, steps) for j in range(g)]
    color, trans, depth = compose_slabs(*(torch.stack([x[k] for x in outs])
                                          for k in ("trans", "color", "depth")), d[:, 2])
    np.testing.assert_allclose(trans, ref["trans"], rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(color, ref["color"], rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(depth, ref["depth"], rtol=2e-4, atol=2e-3)


@pytest.mark.parametrize("g", [2, 3, 4])
def test_split_volume_z_matches_jax(g):
    """The slabs cover the volume (test_grid_shard.py:70-78) and equal
    JAX's field for field."""
    from voxel_tracer_tpu.models.volume import VoxelVolume as JVolume
    from voxel_tracer_tpu.parallel import grid_shard as jgs
    from voxel_tracer_tpu_torch.parallel import grid_shard as tgs, worker
    vol, _ = worker.trace_volume(48)
    rot = np.array([[0.8, 0.0, -0.6], [0.0, 1.0, 0.0], [0.6, 0.0, 0.8]], np.float32)
    vol.rot = rot
    jvol = JVolume(vol.grid, vol.palette, pos=tuple(vol.pos), rot=rot, vpu=vol.vpu)
    got, ref = tgs.split_volume_z(vol, g, "cpu"), jgs.split_volume_z(jvol, g)
    per = got.grid.shape[1]
    assert per % 8 == 0
    rebuilt = np.concatenate([got.grid[j].numpy() for j in range(g)])[: vol.grid.shape[0]]
    np.testing.assert_array_equal(rebuilt, vol.grid)
    for f in got._fields:
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                   rtol=1e-6, atol=1e-6, err_msg=f)


def test_min_reduce_hits_matches_jax():
    import jax.numpy as jnp
    from voxel_tracer_tpu.ops import composite as jc
    from voxel_tracer_tpu.parallel import grid_shard as jgs
    from voxel_tracer_tpu_torch.ops import composite as tc
    from voxel_tracer_tpu_torch.parallel import grid_shard as tgs
    rng = np.random.RandomState(8)
    g, n = 3, 200
    t = np.where(rng.rand(g, n) < 0.4, 1e30, rng.rand(g, n) * 4).astype(np.float32)
    t[:, :5] = 2.0                                 # ties keep the first slab
    fields = dict(t=t, mat=rng.randint(0, 256, (g, n)).astype(np.int32),
                  normal=rng.randn(g, n, 3).astype(np.float32),
                  albedo=rng.rand(g, n, 3).astype(np.float32),
                  steps=rng.randint(0, 300, (g, n)).astype(np.int32),
                  obj=rng.randint(-1, 2, (g, n)).astype(np.int32))
    ref = jgs._min_reduce_hits(jc.HitResult(**{k: jnp.asarray(v) for k, v in fields.items()}), g)
    got = tgs._min_reduce_hits(tc.HitResult(**{k: torch.from_numpy(v) for k, v in fields.items()}), g)
    for f in tc.HitResult._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f)


def test_pad_to_multiple_and_batch_split():
    """`fit` pads the batch to the world size and hands each rank its
    contiguous block of one global draw: the blocks in rank order are
    the JAX trainer's batch (its `rng.randint(0, n, padded)`)."""
    from voxel_tracer_tpu.parallel import mesh as jmesh
    from voxel_tracer_tpu_torch.parallel import mesh as tmesh
    from voxel_tracer_tpu_torch.trainer import draw_batch
    for n in range(0, 40):
        for dev in (1, 2, 3, 4, 8):
            assert tmesh.pad_to_multiple(n, dev) == jmesh.pad_to_multiple(n, dev)
    n_rays = 5000
    for world in (1, 2, 4, 8):
        batch = tmesh.pad_to_multiple(8190, world)
        ref = np.random.RandomState(0).randint(0, n_rays, batch)
        draw = draw_batch(np.random.RandomState(0), n_rays, batch, "wavefront")
        blocks = [tmesh.shard_rays(_rank_mesh(world, r), draw) for r in range(world)]
        assert all(len(b) == batch // world for b in blocks)
        np.testing.assert_array_equal(np.concatenate(blocks), ref)


def test_mesh_without_a_group_is_one_rank():
    from voxel_tracer_tpu_torch.parallel import distributed, mesh as tmesh
    assert distributed.initialize() is False
    assert distributed.process_info() == dict(process_index=0, process_count=1,
                                              local_devices=1, global_devices=1)
    m = tmesh.make_ray_grid_mesh(1, 1, device="cpu")
    assert m.size == 1 and m.coords == {"rays": 0, "grid": 0}
    x = torch.arange(6.0)
    np.testing.assert_array_equal(m.pmean("rays", x), x)
    np.testing.assert_array_equal(m.all_gather("grid", x), x[None])
    with pytest.raises(ValueError, match="2 devices"):
        tmesh.make_ray_grid_mesh(2, 1, device="cpu")


def test_jax_style_mesh_calls():
    """JAX's calls carry over: `make_ray_mesh(n_devices, devices)` and
    `grid_shard.make_ray_grid_mesh(n_ray, n_grid, devices)` build the
    mesh of every rank, here the one process; a count or rank list that
    is not the whole world raises ValueError, not an accelerator
    error."""
    from voxel_tracer_tpu_torch.parallel import grid_shard, mesh as tmesh
    for m in (tmesh.make_ray_mesh(1, device="cpu"), tmesh.make_ray_mesh(device="cpu"),
              tmesh.make_ray_mesh(None, [0], device="cpu"),
              tmesh.make_ray_mesh(1, range(1), device="cpu")):
        assert m.axis_names == ("rays",) and m.size == 1 and m.coords == {"rays": 0}
        assert m.device == torch.device("cpu")
    m = grid_shard.make_ray_grid_mesh(1, 1, [0], device="cpu")
    assert m.shape == {"rays": 1, "grid": 1}
    with pytest.raises(ValueError, match="2 devices.*not 1"):
        tmesh.make_ray_mesh(2, device="cpu")
    with pytest.raises(ValueError, match=r"range\(1\)"):
        tmesh.make_ray_mesh(devices=[1], device="cpu")
    with pytest.raises(ValueError):
        grid_shard.make_ray_grid_mesh(1, 2, device="cpu")


def test_sharding_shard_rays_returns_both_blocks():
    """JAX's `shard_rays(mesh, origins, dirs)`: each rank gets its RAYS
    block of both arrays; the blocks in rank order are the arrays."""
    from voxel_tracer_tpu_torch.parallel import sharding
    rng = np.random.RandomState(6)
    o, d = (torch.from_numpy(rng.randn(12, 3).astype(np.float32)) for _ in range(2))
    for world in (1, 2, 4):
        blocks = [sharding.shard_rays(_rank_mesh(world, r), o, d) for r in range(world)]
        assert all(len(b) == 2 and b[0].shape == b[1].shape == (12 // world, 3)
                   for b in blocks)
        assert torch.equal(torch.cat([b[0] for b in blocks]), o)
        assert torch.equal(torch.cat([b[1] for b in blocks]), d)


def test_trainer_takes_a_positional_mesh():
    """`Trainer(cfg, mesh)`, JAX's call, trains bit for bit like
    `Trainer(cfg, mesh=mesh)` for two wavefront steps."""
    from voxel_tracer_tpu_torch.ops import diff as tdiff
    from voxel_tracer_tpu_torch.parallel import mesh as tmesh
    from voxel_tracer_tpu_torch.trainer import TrainConfig, Trainer
    sigma, albedo, o, d = _slab_problem(g=8, n_rays=256, seed=2)
    c = tdiff.render_density(torch.from_numpy(sigma), torch.from_numpy(albedo),
                             torch.from_numpy(o), torch.from_numpy(d), 8.0, 32)["color"]
    cfg = TrainConfig(grid_size=(8, 8, 8), vpu=8.0, lr=1e-2, steps=2, rays_per_batch=128,
                      march_steps=32)
    mesh = tmesh.make_ray_mesh(1, device="cpu")
    runs = []
    for tr in (Trainer(cfg, mesh, device="cpu"), Trainer(cfg, mesh=mesh, device="cpu")):
        assert tr.mesh is mesh
        losses = tr.fit(o, d, c.numpy(), log_every=1, log_fn=lambda s: None)
        runs.append((losses, tr.params))
    assert len(runs[0][0]) == 2 and runs[0][0] == runs[1][0]
    for k in ("sigma", "albedo"):
        assert torch.equal(runs[0][1][k], runs[1][1][k]), k


def test_nccl_without_a_gpu_raises(monkeypatch):
    """No quiet switch to gloo: NCCL asked for without a card raises."""
    from voxel_tracer_tpu_torch.parallel import distributed
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="nccl"):
        distributed.initialize(init_method="tcp://127.0.0.1:1", num_processes=1,
                               process_id=0, device="cuda")
    assert not torch.distributed.is_initialized()


def jax_grid_losses(max_steps, steps=3, lr=5e-2):
    """JAX `make_grid_sharded_train_step` on a (grid 2, rays 4) mesh of
    conftest's virtual devices, as tools/multiproc_worker.py's grid mode."""
    import jax
    import optax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from voxel_tracer_tpu.ops.diff import render_density
    from voxel_tracer_tpu.parallel.grid_shard import GRID
    from voxel_tracer_tpu.parallel.grid_train import make_grid_sharded_train_step
    from voxel_tracer_tpu.parallel.mesh import RAYS

    s, a, o, d = jax_problem()
    g = s.shape[0]
    vpu = float(g)
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(2, 4), (GRID, RAYS))
    ray_sh, rep, grid_sh = (NamedSharding(mesh, P(RAYS)), NamedSharding(mesh, P()),
                            NamedSharding(mesh, P(GRID)))
    o, d = jax.device_put(o, ray_sh), jax.device_put(d, ray_sh)
    target = jax.jit(lambda s, a, o, d: render_density(s, a, o, d, vpu, max_steps)["color"])(
        jax.device_put(s, rep), jax.device_put(a, rep), o, d)
    opt = optax.adam(lr)
    init = {"sigma": np.full((g,) * 3, 5.0, np.float32),
            "albedo": np.full((g,) * 3 + (3,), 0.5, np.float32)}
    params = jax.device_put(init, grid_sh)
    state = jax.tree.map(lambda x: jax.device_put(
        x, grid_sh if getattr(x, "ndim", 0) >= 3 else rep), opt.init(init))
    step = make_grid_sharded_train_step(mesh, opt, vpu, max_steps=max_steps)
    losses = []
    for _ in range(steps):
        params, state, loss = step(params, state, o, d, target)
        losses.append(float(loss))
    return losses


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return spawn_world(tmp_path_factory.mktemp("world4"), 4, WORLD4_MODES)


def test_world4_grid_step_matches_jax(world4):
    got = world4["modes"]["grid"]
    assert world4["world"] == 4 and world4["backend"] == "gloo"
    assert got["march_steps"] == 48 and got["rays_per_rank"] == 256
    lp = np.asarray(got["losses"])
    assert np.all(np.isfinite(lp)) and lp[-1] < lp[0], lp
    np.testing.assert_allclose(lp, jax_grid_losses(48), rtol=LOSS_RTOL)


def test_world4_grid_step_holds_only_its_slab(world4):
    """Each rank's parameters and both Adam moments are its 16-deep z-slab
    of the 32^3 grid: nothing about the grid is replicated."""
    got = world4["modes"]["grid"]
    assert got["slab_shapes"] == {"sigma": [16, 32, 32], "albedo": [16, 32, 32, 3]}
    assert got["moment_shapes"] == {"sigma": [[16, 32, 32]] * 2,
                                    "albedo": [[16, 32, 32, 3]] * 2}


def test_world4_untruncated_grid_step_matches_jax(world4):
    """The grid-sharded step at the march budget no ray exhausts, against
    JAX's at the same budget."""
    got = world4["modes"][f"grid:{UNTRUNCATED_STEPS}"]
    assert got["march_steps"] == UNTRUNCATED_STEPS
    np.testing.assert_allclose(got["losses"], jax_grid_losses(UNTRUNCATED_STEPS),
                               rtol=LOSS_RTOL)


def test_world4_grid_step_matches_replicated(world4):
    grid = world4["modes"][f"grid:{UNTRUNCATED_STEPS}"]["losses"]
    rep = world4["modes"][f"replicated:{UNTRUNCATED_STEPS}"]["losses"]
    np.testing.assert_allclose(grid, rep, rtol=SLAB_RTOL)


@pytest.mark.parametrize("mode", ["trace:4", "trace:2"])
def test_world4_grid_sharded_trace(world4, mode):
    tr = world4["modes"][mode]
    assert tr["slabs"] == int(mode[-1]) and tr["hits"] > 200
    assert tr["mismatches"] <= TRACE_MISMATCH_BUDGET
    assert tr["t_max_diff"] <= TRACE_T_ATOL
    assert tr["mat_equal"] > 0.99 and tr["normal_equal"] > 0.99


def test_sharded_trace_blocks_match_jax():
    """`make_sharded_trace` on each rank of a 4-rank ray mesh traces that
    rank's block; the
    blocks in rank order equal JAX's `make_sharded_trace` on 8 virtual
    devices, hit for hit."""
    import jax
    from voxel_tracer_tpu.models.camera import Camera as JCamera, rays_for_image as jrays
    from voxel_tracer_tpu.models.scene import Scene as JScene
    from voxel_tracer_tpu.models.volume import VoxelVolume as JVolume
    from voxel_tracer_tpu.parallel import mesh as jmesh, sharding as jsharding
    from voxel_tracer_tpu.renderer import RenderConfig as JConfig
    from voxel_tracer_tpu_torch.models.camera import Camera, rays_for_image
    from voxel_tracer_tpu_torch.models.scene import Scene
    from voxel_tracer_tpu_torch.parallel import sharding, worker
    from voxel_tracer_tpu_torch.renderer import RenderConfig
    vol, _ = worker.trace_volume(48)
    jvol = JVolume(vol.grid, vol.palette, pos=tuple(vol.pos), vpu=vol.vpu)
    pose = ((0.4, 0.9, -2.6), (0.1, 0.0, -0.2), 1.0)
    jo, jd = jrays(JCamera.create(*pose), 32, 32)
    ref = jsharding.make_sharded_trace(jmesh.make_ray_mesh(8), JConfig())(
        JScene(volumes=[jvol]).data(), jo, jd)
    o, d = rays_for_image(Camera.create(*pose), 32, 32, device="cpu")
    sd = Scene(volumes=[vol]).data("cpu")
    blocks = [sharding.make_sharded_trace(_rank_mesh(4, r), RenderConfig())(sd, o, d)
              for r in range(4)]
    assert all(b.t.shape[0] == 256 for b in blocks)
    t = torch.cat([b.t for b in blocks]).numpy()
    hit, hit_ref = t < 1e30, np.asarray(ref.t) < 1e30
    assert hit.mean() > 0.2
    np.testing.assert_array_equal(hit, hit_ref)
    np.testing.assert_allclose(t[hit], np.asarray(ref.t)[hit], atol=1e-5)
    np.testing.assert_array_equal(torch.cat([b.mat for b in blocks]).numpy(), np.asarray(ref.mat))
