"""The DDA's route to its kernel D1 (`ops/cuda/dda.py`), on the CPU.

`ops/cuda/dda.intersect_volume_local` launches D1 for CUDA tensors and
runs the plain DDA (`ops/dda.py`) for CPU tensors; D1 against the plain
DDA is tests/test_torch_cuda.py's (card only).  Here:

- the batch rule D1's second pass keeps: the JAX loop marks a ray that
  ran out of the step budget only if another ray of the same call is still
  walking, so the same medium rays traced in one call and in two give
  different results; each call equals the JAX function's bit for bit
  (t as bits; mat, axis, steps, step_sign and valid equal);
- routing, with the D1 wrapper replaced by a recorder that runs the plain
  DDA: composite's sites (one volume, `intersect_group` over stacked
  grids, `march_interior`, `is_occluded`), `MegaIntersector._dda_fallback`
  and integrate's `use_fallback` reach the wrapper; the plain selection
  (`composite.PLAIN`, ``dda_fn=dda.intersect_volume_local``) reaches
  `ops/dda.py` and never the wrapper, with equal results; integrate's
  fallback rays take the plain DDA's hits;
- the wavefront `Renderer` frame and the exact Whitted frame through that
  route against the JAX frame at 64x48, to tests/test_torch_renderer.py's
  pinned budgets (`compare_frames`).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from voxel_tracer_tpu.models.camera import Camera as JCamera
from voxel_tracer_tpu.models.camera import rays_for_image as jrays_for_image
from voxel_tracer_tpu.models.scene import Scene as JScene
from voxel_tracer_tpu.models.volume import VoxelVolume as JVolume
from voxel_tracer_tpu.ops import dda as jdda
from voxel_tracer_tpu.renderer import RenderConfig as JConfig
from voxel_tracer_tpu.renderer import render_rays as jrender_rays

from voxel_tracer_tpu_torch.convert import camera_from_jax, scene_from_jax, volume_from_jax
from voxel_tracer_tpu_torch.models.volume import VoxelVolume
from voxel_tracer_tpu_torch.ops import composite, dda
from voxel_tracer_tpu_torch.ops.cuda import coherent, integrate, mega
from voxel_tracer_tpu_torch.ops.cuda import dda as dda_kernel
from voxel_tracer_tpu_torch.ops.cuda.whitted import MegaIntersector, render_whitted_mega
from voxel_tracer_tpu_torch.ops.diff_surface import render_lambert_surface
from voxel_tracer_tpu_torch.renderer import RenderConfig, Renderer

from test_torch_renderer import compare_frames, material_scene

torch.set_num_threads(1)

W, H = 64, 48
FRAME = 7
FIELDS = ("t", "mat", "normal", "albedo", "steps", "obj")


# ---------------------------------------------------------------------------
# The batch rule
# ---------------------------------------------------------------------------

def _medium_batch(n=512, seed=3):
    """tests/test_torch_dda.py's medium budget batch: a 32^3 noise volume
    (one material, 16), rays from inside it, half of them in medium 16."""
    rng = np.random.RandomState(seed)
    vol = VoxelVolume.noise_filled((32, 32, 32))
    o = (rng.uniform(0.02, 0.98, (n, 3)) * vol.size).astype(np.float32)
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    k = n // 16
    d[:k] = 0.0
    d[np.arange(k), rng.randint(0, 3, k)] = np.where(rng.rand(k) < 0.5, -1.0, 1.0)
    medium = np.where(rng.rand(n) < 0.5, 16, 0).astype(np.int32)
    return vol, o, d, medium


def _both(vol, o, d, medium, max_steps):
    """The JAX function and the port's wrapper on the same rays."""
    ref = jdda.intersect_volume_local(
        jnp.asarray(vol.grid.astype(np.int32)), jnp.asarray(vol.brick_occ), jnp.asarray(o),
        jnp.asarray(d), vol.vpu, max_steps=max_steps, medium=jnp.asarray(medium))
    out = dda_kernel.intersect_volume_local(
        torch.from_numpy(vol.grid), torch.from_numpy(vol.brick_occ), torch.from_numpy(o),
        torch.from_numpy(d), vol.vpu, max_steps=max_steps, medium=torch.from_numpy(medium))
    ref = {k: np.asarray(v) for k, v in ref.items()}
    out = {k: v.numpy() for k, v in out.items()}
    np.testing.assert_array_equal(out["t"].view(np.int32), ref["t"].view(np.int32))
    for f in ("mat", "axis", "steps", "step_sign", "valid"):
        np.testing.assert_array_equal(out[f], ref[f], err_msg=f)
    return out


@pytest.mark.parametrize("max_steps", [6, 12])
def test_batch_rule_one_call_and_two_match_jax(max_steps):
    """The medium rays that one call marks exhausted (the exit at the slab
    tmax), traced in a call of their own, are not all marked: the rays that
    walked longest run out with the loop.  Each call equals JAX's."""
    vol, o, d, medium = _medium_batch()
    full = _both(vol, o, d, medium, max_steps)
    out_of_budget = (medium > 0) & ~full["resolved"]
    marked = out_of_budget & (full["t"] < 1e30)
    assert marked.sum() > 10
    np.testing.assert_array_equal(full["t"][marked], full["slab_tmax"][marked])
    split_t = np.empty_like(full["t"])
    for part in (marked, ~marked):
        split_t[part] = _both(vol, o[part], d[part], medium[part], max_steps)["t"]
    changed = split_t != full["t"]
    assert changed.any() and (changed <= marked).all()
    assert (split_t[changed] >= 1e30).all()


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------

@pytest.fixture
def d1_calls(monkeypatch):
    """The D1 wrapper replaced by a recorder that runs the plain DDA, and a
    spy on the plain DDA's cell set-up: (wrapper calls, plain set-ups)."""
    calls, setups = [], []
    plain, cell_setup = dda.intersect_volume_local, dda._cell_setup

    def record(*args, **kw):
        calls.append(sorted(k for k, v in kw.items() if v is not None and v is not False))
        return plain(*args, **kw)

    def spy(*args):
        setups.append(1)
        return cell_setup(*args)

    monkeypatch.setattr(dda_kernel, "intersect_volume_local", record)
    monkeypatch.setattr(dda, "_cell_setup", spy)
    return calls, setups


@pytest.fixture(scope="module")
def scenes():
    """The material scene (one volume) and a group of two volumes of one
    shape (the second turned and moved), as port SceneData on the CPU,
    with world rays that hit both."""
    jvol, jscene = material_scene()
    pair = JScene(volumes=[jvol, JVolume(np.asarray(jvol.grid), palette=np.asarray(jvol.palette),
                                         pos=(0.9, 0.2, 0.4), vpu=24.0)])
    rng = np.random.RandomState(11)
    n = 1024
    o = (np.array([0.8, 0.9, -1.2]) + rng.randn(n, 3) * 0.05).astype(np.float32)
    d = (np.array([0.0, -0.2, 1.0]) + rng.randn(n, 3) * 0.35).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    one = scene_from_jax(jscene.data(), device="cpu")
    two = scene_from_jax(pair.data(), device="cpu")
    assert two.groups[0].grid.shape[0] == 2
    return dict(one=one, two=two, o=torch.from_numpy(o), d=torch.from_numpy(d),
                jvol=jvol)


def _site(name, backend, sc):
    """One traversal of composite's interface on ``backend``; returns
    (HitResult, the keyword the site must pass the DDA)."""
    o, d = sc["o"], sc["d"]
    n = o.shape[0]
    if name == "trace_one":
        return backend.intersect_scene(sc["one"], o, d), None
    if name == "group":
        return backend.intersect_scene(sc["two"], o, d), "oid"
    if name == "march_interior":
        hit = backend.intersect_scene(sc["two"], o, d)
        medium = torch.where(hit.mat > 0, hit.mat, 3).to(torch.int32)
        p = o + d * torch.where(hit.t < 1e30, hit.t, 0.0)[:, None] + d * 1e-3
        return backend.march_interior(sc["two"], torch.clamp(hit.obj, min=0), p, d,
                                      medium), "medium"
    if name == "is_occluded":
        seed = torch.from_numpy(np.random.RandomState(2).randint(0, 2 ** 32, n,
                                                                 dtype=np.uint64)
                                .astype(np.int64))
        return backend.is_occluded(sc["two"], o, d, 1e30, shadow_seed=seed)[1], "shadow"
    raise ValueError(name)


SITES = ["trace_one", "group", "march_interior", "is_occluded"]


@pytest.mark.parametrize("site", SITES)
def test_composite_sites_reach_d1(d1_calls, scenes, site):
    calls, _ = d1_calls
    hit, key = _site(site, composite, scenes)
    assert calls, f"{site} did not reach the D1 wrapper"
    if key is not None:
        assert any(key in c for c in calls), (site, calls)
    assert bool((hit.t < 1e30).any())


@pytest.mark.parametrize("site", SITES)
def test_plain_backend_never_reaches_d1(d1_calls, scenes, site):
    calls, setups = d1_calls
    ref, _ = _site(site, composite, scenes)
    del calls[:], setups[:]
    out, _ = _site(site, composite.PLAIN, scenes)
    assert not calls and setups, "composite.PLAIN must run ops/dda.py alone"
    for f in FIELDS:
        assert torch.equal(getattr(out, f), getattr(ref, f)), f


@pytest.mark.parametrize("mode", ["medium", "shadow"])
def test_whitted_fallback_reaches_d1(d1_calls, scenes, mode):
    calls, setups = d1_calls
    mv = mega.MegaVolume(volume_from_jax(scenes["jvol"]), device="cpu")
    o_l = (scenes["o"] - mv.pos + mv.pivot).contiguous()     # rot is the identity
    d_l = scenes["d"]
    need = torch.arange(o_l.shape[0]) % 3 == 0
    kw = (dict(medium=3) if mode == "medium"
          else dict(shadow_seed=torch.arange(o_l.shape[0], dtype=torch.int64) * 2654435761))
    got = MegaIntersector(mv, exact_fallback=True)._dda_fallback(need, o_l, d_l, **kw)
    assert len(calls) == 1 and ("medium" if mode == "medium" else "shadow") in calls[0]
    del calls[:], setups[:]
    ref = MegaIntersector(mv, exact_fallback=True, dda_fn=dda.intersect_volume_local
                          )._dda_fallback(need, o_l, d_l, **kw)
    assert not calls and setups
    for f in ("ok", "t", "mat", "ax", "steps"):
        assert torch.equal(got[f], ref[f]), f
    assert bool(got["ok"].any()) and not bool(got["ok"][~need].any())


def test_integrate_fallback_reaches_d1(d1_calls, scenes):
    """B5's plain version with every third ray marked unresolved (a Pallas
    residue ray, as tests/test_torch_integrate.py makes them): the fallback
    traces those rays on the wrapper, and they take the plain DDA's hits."""
    calls, setups = d1_calls
    fv = integrate.FastVolume(volume_from_jax(scenes["jvol"]), device="cpu")
    o, d = scenes["o"], scenes["d"]
    drop = torch.arange(o.shape[0]) % 3 == 0

    def residue(*args):
        res = dict(coherent.trace_coherent_plain(*args))
        res["resolved"] = res["resolved"] & ~drop
        return res

    got = integrate._trace_fast(fv, o, d, use_fallback=True, trace_fn=residue)
    assert len(calls) == 1 and setups
    o_l, d_l = composite._to_local(fv.rot, fv.pos, fv.pivot, o, d)
    ref = dda.intersect_volume_local(fv.grid, fv.brick_occ, o_l[drop], d_l[drop], fv.vpu)
    hit = ref["t"] < 1e30
    assert torch.equal(got.t[drop], ref["t"])
    assert torch.equal(got.mat[drop], torch.where(hit, ref["mat"], 0))
    assert torch.equal(got.steps[drop], ref["steps"])
    assert bool(hit.any())


def test_surface_path_isect_argument(d1_calls, scenes):
    calls, setups = d1_calls
    pal = torch.rand(256, 3, generator=torch.Generator().manual_seed(4))
    got = render_lambert_surface(pal, scenes["one"], scenes["o"], scenes["d"])
    assert len(calls) == 2                     # the hits and the sun's shadow rays
    del calls[:], setups[:]
    ref = render_lambert_surface(pal, scenes["one"], scenes["o"], scenes["d"],
                                 isect=composite.PLAIN)
    assert not calls and setups
    for f in ("color", "hit", "mat"):
        assert torch.equal(got[f], ref[f]), f


# ---------------------------------------------------------------------------
# Frames through the route, against JAX
# ---------------------------------------------------------------------------

def _config(cls, **kw):
    return cls(width=W, height=H, shading="full", max_bounces=3, glass_reflections=2, **kw)


@pytest.fixture(scope="module")
def frames():
    """The material scene at 64x48: the JAX wavefront frame, and the
    port's scene, camera and volume."""
    jvol, scene = material_scene()
    jsd = scene.data()
    jcam = JCamera.create((1.1, 0.9, -1.5), (0.0, 0.3, 0.0), W / H)
    o, d = jrays_for_image(jcam, W, H)
    ref = jrender_rays(jsd, o, d, jnp.int32(FRAME), config=_config(JConfig))
    return dict(ref=ref, sd=scene_from_jax(jsd, device="cpu"), cam=camera_from_jax(jcam),
                vol=volume_from_jax(jvol))


def test_wavefront_frame_through_d1_matches_jax(d1_calls, frames):
    calls, _ = d1_calls
    out = Renderer(_config(RenderConfig), device="cpu").render(frames["sd"], frames["cam"],
                                                               frame=FRAME)
    assert len(calls) > 10
    compare_frames(frames["ref"], out, exact=False)
    del calls[:]
    plain = Renderer(_config(RenderConfig), device="cpu", isect=composite.PLAIN).render(
        frames["sd"], frames["cam"], frame=FRAME)
    assert not calls
    for k in out:
        assert torch.equal(plain[k], out[k]), k


def test_exact_whitted_frame_through_d1_matches_jax(d1_calls, frames):
    """exact_fallback with one shadow round: every shadow walk past its
    first solid voxel continues on the DDA's shadow mode, through the
    wrapper."""
    calls, _ = d1_calls
    mv = mega.MegaVolume(frames["vol"], device="cpu")
    isect = MegaIntersector(mv, shadow_rounds=1, exact_fallback=True)
    out = render_whitted_mega(isect, frames["sd"], frames["cam"], W, H, FRAME,
                              config=_config(RenderConfig))
    assert any("shadow" in c for c in calls)
    compare_frames(frames["ref"], out, exact=False)
