"""The differentiable march's route to its kernels D2 / D3
(`ops/cuda/diff.py`), on the CPU.

`ops/cuda/diff.render_density` launches D2 (forward) and D3 (replay
backward) for CUDA tensors and runs the plain march (`ops/diff.py`) for
CPU tensors; the kernels against the plain march are
tests/test_torch_cuda.py's (card only).  Here:

- routing, with the wrapper replaced by a recorder that runs the plain
  march: the wavefront `Trainer.fit` step, `make_train_step` with
  overlap_slabs 1 and 4, the grid-sharded step, `Trainer.render`, the
  worker's targets, the inverse-rendering example's views and workload
  4's frame reach the wrapper; `ops/diff.render_density` and workload 4's
  CPU reference never do;
- per-ray independence, the property D2's and D3's per-thread exit rests
  on: the plain loop steps a dead ray on until no ray of the batch is
  alive, a thread stops with its ray.  Every ray rendered alone and in
  batches of mixed lengths gives the batch's color, trans and depth
  within 2 ulp (PyTorch's CPU exp takes a vector path in a batch and a
  scalar path for a lone ray, which may differ in the last bit), and the
  gradients of a loss on all three outputs summed over the parts equal
  the batch's within 1e-6 x max|g| (float32 sums in other orders).  The
  one exception is the depth of a ray whose set-up leaves t_exit or a
  first crossing at -inf (an axis-parallel ray outside the slab on its
  parallel axis): its dead steps make its depth NaN in JAX's scan and in
  the plain loop whenever the loop runs, and 0 when it is alone (the
  loop never starts); D2 writes NaN for it, as JAX does;
- the wrapper on CPU tensors equals the plain version bit for bit, and
  both equal JAX's `render_density` at tests/test_torch_diff.py's
  tolerances (outputs 1e-5, gradients 1e-4 x max|g|), forward and
  gradients of a loss on color, trans and depth;
- the wrapper's input checks (dtype, devices, shapes).
"""

import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from voxel_tracer_tpu.ops import diff as jdiff

from voxel_tracer_tpu_torch.bench import workloads
from voxel_tracer_tpu_torch.examples import inverse_render
from voxel_tracer_tpu_torch.models.camera import Camera
from voxel_tracer_tpu_torch.ops import diff
from voxel_tracer_tpu_torch.ops.cuda import diff as diff_kernel
from voxel_tracer_tpu_torch.parallel import grid_train, mesh as pmesh, worker
from voxel_tracer_tpu_torch.parallel.sharding import make_train_step
from voxel_tracer_tpu_torch.trainer import TrainConfig, Trainer

from test_torch_diff import _scene as edge_scene

torch.set_num_threads(1)

VPU = 10.0
STEPS = 192


def _random_scene(n=192, g=16, seed=5):
    """A 16^3 random field (a quarter of sigma 0) and rays from around and
    inside it, one in eight axis-parallel with +-0 components."""
    rng = np.random.RandomState(seed)
    sigma = rng.uniform(0, 6.0, (g, g, g)).astype(np.float32)
    sigma[rng.rand(g, g, g) < 0.25] = 0.0
    albedo = rng.uniform(-0.2, 1.0, (g, g, g, 3)).astype(np.float32)
    o = (rng.uniform(-0.4, 1.4, (n, 3)) * (g / VPU)).astype(np.float32)
    d = rng.randn(n, 3).astype(np.float32)
    k = n // 8
    d[:k] = np.where(rng.rand(k, 3) < 0.5, -0.0, 0.0)
    d[np.arange(k), rng.randint(0, 3, k)] = np.where(rng.rand(k) < 0.5, -1.0, 1.0)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return sigma, albedo, o, d


def _scenes():
    s, a, o, d, _ = edge_scene()
    return {"edge": (s, a, o, d), "random": _random_scene()}


def _cotangents(n, seed=9):
    rng = np.random.RandomState(seed)
    return tuple(torch.from_numpy(rng.randn(*shape).astype(np.float32))
                 for shape in ((n, 3), (n,), (n,)))


def _render(sigma, albedo, o, d, cts):
    """Outputs and (d sigma, d albedo) of <outputs, cotangents> through the
    plain march."""
    s = torch.from_numpy(sigma).requires_grad_()
    a = torch.from_numpy(albedo).requires_grad_()
    out = diff.render_density(s, a, torch.from_numpy(o), torch.from_numpy(d), VPU, STEPS)
    outs = (out["color"], out["trans"], out["depth"])
    grads = torch.autograd.grad(outs, (s, a), cts)
    return tuple(x.detach().numpy() for x in outs), tuple(g.numpy() for g in grads)


# ---------------------------------------------------------------------------
# Per-ray independence
# ---------------------------------------------------------------------------

def _nan_depth_rays(sigma, o, d):
    """The rays whose set-up leaves t_exit or a first crossing at -inf."""
    _, (st, _, _, _, t_exit) = diff._setup(torch.from_numpy(sigma), torch.from_numpy(o),
                                           torch.from_numpy(d), VPU)
    inf = float("inf")
    return ((t_exit == -inf) | (st.tmax3 == -inf).any(-1)).numpy()


def _parts(n, mode):
    """Index ranges: every ray alone, or batches of mixed lengths."""
    if mode == "alone":
        return [slice(i, i + 1) for i in range(n)]
    out, a, k = [], 0, 0
    lengths = (1, 17, 3, 40, 2, 9, 64, 5)
    while a < n:
        b = min(n, a + lengths[k % len(lengths)])
        out.append(slice(a, b))
        a, k = b, k + 1
    return out


@pytest.mark.parametrize("mode", ["alone", "mixed"])
@pytest.mark.parametrize("scene", ["edge", "random"])
def test_rays_march_independently(scene, mode):
    sigma, albedo, o, d = _scenes()[scene]
    n = o.shape[0]
    cts = _cotangents(n)
    (c, t, dp), (gs, ga) = _render(sigma, albedo, o, d, cts)
    assert (t < 1.0).sum() > n // 4 and (t == 1.0).sum() > 0      # hits and misses
    nan = _nan_depth_rays(sigma, o, d)
    np.testing.assert_array_equal(np.isnan(dp), nan)
    parts = _parts(n, mode)
    pc, pt, pd = np.empty_like(c), np.empty_like(t), np.empty_like(dp)
    ps, pa = np.zeros_like(gs), np.zeros_like(ga)
    for sl in parts:
        (c1, t1, d1), (g1, g2) = _render(sigma, albedo, o[sl], d[sl],
                                         tuple(x[sl] for x in cts))
        pc[sl], pt[sl], pd[sl] = c1, t1, d1
        ps += g1
        pa += g2
    for name, got, ref in (("color", pc, c), ("trans", pt, t), ("depth", pd[~nan], dp[~nan])):
        np.testing.assert_array_max_ulp(got, ref, maxulp=2)
    # the exception: NaN where the part's loop ran, 0 where it never started
    assert (np.isnan(pd[nan]) | (pd[nan] == 0)).all()
    if mode == "alone":
        assert (pd[nan] == 0).all()
    for name, got, ref in (("d sigma", ps, gs), ("d albedo", pa, ga)):
        err = np.abs(got - ref).max()
        assert err <= 1e-6 * np.abs(ref).max(), (name, err)


@pytest.mark.parametrize("scene", ["edge", "random"])
def test_dead_steps_leave_nan_depth_as_in_jax(scene):
    """The exception above, in JAX's scan and the plain loop: the same rays,
    all misses here, get NaN depth, T = 1 and C = 0."""
    sigma, albedo, o, d = _scenes()[scene]
    nan = _nan_depth_rays(sigma, o, d)
    assert nan.any()
    ref = jdiff.render_density(jnp.asarray(sigma), jnp.asarray(albedo), jnp.asarray(o),
                               jnp.asarray(d), VPU, STEPS)
    np.testing.assert_array_equal(np.isnan(np.asarray(ref["depth"])), nan)
    (c, t, dp), _ = _render(sigma, albedo, o, d, _cotangents(o.shape[0]))
    np.testing.assert_array_equal(np.isnan(dp), nan)
    assert (t[nan] == 1).all() and (c[nan] == 0).all()
    assert np.isfinite(c).all() and np.isfinite(t).all()


def test_missed_rays_stay_untouched():
    """A batch of rays that all miss the slab: the loop never starts, and
    T = 1, C = 0, D = 0 with no gradient (the first ray is one of the
    exception's, whose depth a running loop would make NaN)."""
    sigma, albedo, _, _ = _random_scene()
    o = np.array([[3.0, 3.0, 3.0], [-1.0, -1.0, -1.0], [-0.5, 0.5, 0.5]], np.float32)
    d = np.array([[1.0, 0.0, 0.0], [0.0, 0.0, -1.0], [-1.0, 0.0, 0.0]], np.float32)
    (c, t, dp), (gs, ga) = _render(sigma, albedo, o, d, _cotangents(3))
    assert (c == 0).all() and (t == 1).all() and (dp == 0).all()
    assert not gs.any() and not ga.any()


# ---------------------------------------------------------------------------
# The wrapper on CPU tensors vs the plain version and JAX
# ---------------------------------------------------------------------------

def _loss(out, target):
    return (((out["color"] - target) ** 2).mean() + 0.1 * out["trans"].mean()
            + 0.01 * out["depth"].mean())


@pytest.mark.parametrize("scene", ["edge", "random"])
def test_wrapper_equals_plain_and_jax(scene):
    sigma, albedo, o, d = _scenes()[scene]
    target = np.random.RandomState(1).uniform(0, 1, (o.shape[0], 3)).astype(np.float32)
    got = {}
    for name, fn in (("wrapper", diff_kernel.render_density), ("plain", diff.render_density)):
        s, a = (torch.tensor(x, requires_grad=True) for x in (sigma, albedo))
        out = fn(s, a, torch.from_numpy(o), torch.from_numpy(d), VPU, STEPS)
        _loss(out, torch.from_numpy(target)).backward()
        got[name] = {k: v.detach().numpy() for k, v in out.items()}
        got[name].update(d_sigma=s.grad.numpy(), d_albedo=a.grad.numpy())
    for k, v in got["plain"].items():
        np.testing.assert_array_equal(got["wrapper"][k], v, err_msg=k)

    def jloss(s, a):
        out = jdiff.render_density(s, a, jnp.asarray(o), jnp.asarray(d), VPU, STEPS)
        return (jnp.mean((out["color"] - target) ** 2) + 0.1 * jnp.mean(out["trans"])
                + 0.01 * jnp.mean(out["depth"]))

    ref = jdiff.render_density(jnp.asarray(sigma), jnp.asarray(albedo), jnp.asarray(o),
                               jnp.asarray(d), VPU, STEPS)
    for k in ("color", "trans", "depth"):
        np.testing.assert_allclose(got["wrapper"][k], np.asarray(ref[k]), atol=1e-5, rtol=0,
                                   err_msg=k)
    grads = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(sigma), jnp.asarray(albedo))
    for k, g in zip(("d_sigma", "d_albedo"), grads):
        g = np.asarray(g)
        assert np.abs(got["wrapper"][k] - g).max() <= 1e-4 * np.abs(g).max(), k


def test_launchers_run_the_plain_halves_on_the_cpu():
    """march_fwd / march_bwd on CPU tensors: the plain forward and replay
    backward, equal to what the autograd path gives."""
    sigma, albedo, o, d = _random_scene(64)
    args = [torch.from_numpy(x) for x in (sigma, albedo, o, d)]
    fwd = diff_kernel.march_fwd(*args, VPU, STEPS)
    cts = _cotangents(64)
    bwd = diff_kernel.march_bwd(*args, VPU, STEPS, *fwd, *cts)
    (c, t, dp), (gs, ga) = _render(sigma, albedo, o, d, cts)
    for got, ref in zip((*fwd, *bwd), (c, t, dp, gs, ga)):
        np.testing.assert_array_equal(got.numpy(), ref)
    assert diff_kernel.KERNEL_LAUNCHES == {"diff_fwd": 0, "diff_bwd": 0}


def test_wrapper_rejects_bad_input():
    sigma, albedo, o, d = (torch.from_numpy(x) for x in _random_scene(8))
    with pytest.raises(TypeError):
        diff_kernel.render_density(sigma.double(), albedo, o, d, VPU)
    with pytest.raises(TypeError):
        diff_kernel.render_density(sigma, albedo, o, d.half(), VPU)
    with pytest.raises(ValueError):
        diff_kernel.render_density(sigma.to("meta"), albedo, o, d, VPU)
    with pytest.raises(ValueError):
        diff_kernel.render_density(sigma, albedo[..., :2], o, d, VPU)
    with pytest.raises(ValueError):
        diff_kernel.render_density(sigma, albedo, o, d[:4], VPU)
    with pytest.raises(ValueError):
        diff_kernel.render_density(sigma[:0], albedo[:0], o, d, VPU)


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------

@pytest.fixture
def calls(monkeypatch):
    """The wrapper replaced by a recorder that runs the plain march:
    (grid shape, rays, max_steps) of each call."""
    rec, plain = [], diff.render_density

    def record(sigma, albedo, origin_l, dir_l, vpu, max_steps=192):
        rec.append((tuple(sigma.shape), int(origin_l.shape[0]), int(max_steps)))
        return plain(sigma, albedo, origin_l, dir_l, vpu, max_steps)

    monkeypatch.setattr(diff_kernel, "render_density", record)
    return rec


G, N, MARCH = 8, 96, 24


def _problem():
    rng = np.random.RandomState(2)
    sigma = rng.uniform(0, 4.0, (G, G, G)).astype(np.float32)
    albedo = rng.uniform(0, 1, (G, G, G, 3)).astype(np.float32)
    o = np.tile(np.array([[0.5, 0.6, -0.3]], np.float32), (N, 1))
    d = (np.array([0.0, 0.0, 1.0]) + rng.randn(N, 3) * 0.3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    target = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    return sigma, albedo, o, d, target


def _leaves(sigma, albedo):
    return {"sigma": torch.tensor(sigma, requires_grad=True),
            "albedo": torch.tensor(albedo, requires_grad=True)}


def test_trainer_fit_and_render_reach_the_kernels(calls):
    _s, _a, o, d, target = _problem()
    cfg = TrainConfig(grid_size=(G, G, G), vpu=float(G), lr=1e-2, steps=2,
                      rays_per_batch=N, march_steps=MARCH)
    tr = Trainer(cfg, device="cpu")
    assert cfg.backend == "wavefront"
    losses = tr.fit(o, d, target, log_every=1, log_fn=lambda s: None)
    assert calls == [((G, G, G), N, MARCH)] * 2 and len(losses) == 2
    img = tr.render(Camera.create((0.5, 0.6, -1.5), (0.5, 0.5, 0.5), 1.0), 6, 4)
    assert img.shape == (4, 6, 3) and calls[2:] == [((G, G, G), 24, MARCH)]


@pytest.mark.parametrize("slabs", [1, 4])
def test_make_train_step_reaches_the_kernels(calls, slabs):
    sigma, albedo, o, d, target = _problem()
    step = make_train_step(pmesh.make_ray_mesh(device="cpu"), 1e-2, float(G), MARCH,
                           overlap_slabs=slabs)
    step(_leaves(sigma, albedo), None, *(torch.from_numpy(x) for x in (o, d, target)))
    assert calls == [((G // slabs, G, G), N, MARCH)] * slabs


def test_grid_sharded_step_reaches_the_kernels(calls):
    sigma, albedo, o, d, target = _problem()
    mesh = pmesh.make_ray_grid_mesh(1, 1, device="cpu")
    step = grid_train.make_grid_sharded_train_step(mesh, 1e-2, float(G), MARCH)
    params = grid_train.place_grid_params(mesh, {"sigma": sigma, "albedo": albedo})
    step(params, None, *(torch.from_numpy(x) for x in (o, d, target)))
    assert calls == [((G, G, G), N, MARCH)]


def test_worker_and_example_reach_the_kernels(calls):
    sigma, albedo, o, d, _ = _problem()
    c = worker.targets(sigma, albedo, o, d, float(G), MARCH, "cpu")
    assert c.shape == (N, 3) and calls == [((G, G, G), N, MARCH)]
    views, _ = inverse_render.make_target_views(G, 2, 4, float(G), "cpu")
    assert len(views) == 2 and calls[1:] == [((G, G, G), 16, 128)] * 2


def test_workload_4_frame_reaches_the_kernels_and_its_reference_does_not(calls):
    wl = workloads.diff_lambert_512_wavefront("cpu", 0, grid=16, size=16, frames=2,
                                              max_steps=32)
    state = wl.snapshot()
    out = wl.frame(0)
    assert calls == [((16, 16, 16), 256, 32)]
    assert wl.check(0, state, out)["correct"]
    sub = wl.subs["wavefront_fwd_rays_per_s"]
    fwd = sub.frame(0)
    assert sub.check(0, None, fwd)["correct"]
    assert len(calls) == 2              # the references ran the plain march


def test_plain_march_never_reaches_the_kernels(calls):
    sigma, albedo, o, d, target = _problem()
    p = _leaves(sigma, albedo)
    out = diff.render_density(p["sigma"], p["albedo"], torch.from_numpy(o),
                              torch.from_numpy(d), float(G), MARCH)
    _loss(out, torch.from_numpy(target)).backward()
    assert calls == []
    imports = [ln for ln in inspect.getsource(diff).splitlines()
               if ln.startswith(("import ", "from "))]
    assert not any("ops.cuda" in ln for ln in imports), imports
