"""Parity: the port's kernel renderer (`ops/cuda/integrate.py`,
`ops/cuda/renderer_fast.py`), sky (`models/skydome.py`), hit record
(`ops/composite.HitResult`) and profiling scene (`utils/profiling.py`) vs
the JAX package, on CPU.

On CPU tensors the port traces with B5's plain PyTorch version.  The JAX
renderer calls its Pallas kernel without an `interpret` switch; a module
fixture runs it in interpret mode, as tests/test_coherent_kernel.py runs
that kernel, by wrapping `coherent.trace_coherent` for this module only.
Scenes are built in code and carried across with `convert`.

Tolerances, each against the JAX function named in the test:
- `sample_sky`: 1e-6 (XLA's and PyTorch's atan2/acos may differ in the
  last bit, which moves the bilinear weights by ~1e-7).
- `intersect_volume_fast`, `render_flat_fast`, `render_lambert_fast`
  with `use_fallback=True` (every JAX ray resolved, the Pallas residue by
  the XLA DDA): depth within 1e-5, material and normal equal, irradiance
  within 1e-5, image within 1 LSB (1/255), albedo within 1e-6, all up to a
  PINNED budget of pixels whose hit or shadow flips: 0 observed on every
  scene here (jax 0.9.0, torch 2.13); the headroom of 2 covers a ray that
  grazes a voxel corner, where the port's raygen (unfused) and the XLA
  DDA's crossings (another float32 program) can land on either side.
- With the JAX default `use_fallback=False`, the Pallas kernel's
  unresolved rays come back as sky: compared only on the rays it resolved.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from voxel_tracer_tpu.models.camera import Camera as JCamera
from voxel_tracer_tpu.models.camera import rays_for_image as j_rays
from voxel_tracer_tpu.models.skydome import SkyDome as JSky
from voxel_tracer_tpu.models.skydome import sample_sky as j_sample_sky
from voxel_tracer_tpu.models.volume import VoxelVolume as JVolume
from voxel_tracer_tpu.ops import composite as jcomposite
from voxel_tracer_tpu.ops.pallas import coherent as jcoh
from voxel_tracer_tpu.ops.pallas import integrate as jint
from voxel_tracer_tpu.ops.pallas import renderer_fast as jrf
from voxel_tracer_tpu.utils import profiling as jprof

from voxel_tracer_tpu_torch.convert import (camera_from_jax, skydome_from_jax,
                                            volume_from_jax)
from voxel_tracer_tpu_torch.models.skydome import SkyDome, sample_sky
from voxel_tracer_tpu_torch.ops.composite import HitResult
from voxel_tracer_tpu_torch.ops.cuda import integrate, renderer_fast
from voxel_tracer_tpu_torch.utils import profiling

torch.set_num_threads(1)

W, H = 64, 64
BUDGET = 2     # pinned, see the module docstring
LSB = 1.0 / 255


@pytest.fixture(scope="module", autouse=True)
def pallas_interpret():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcoh, "trace_coherent",
                   functools.partial(jcoh.trace_coherent, interpret=True))
        yield


def _two_mat_sphere(n=16, r=0.42):
    z, y, x = np.meshgrid(*[np.arange(n)] * 3, indexing="ij")
    c = (n - 1) / 2
    d = np.sqrt((x - c) ** 2 + (y - c) ** 2 + (z - c) ** 2)
    return np.where(d < r * n, np.where(y > c, 140, 23), 0).astype(np.uint8)


PALETTE = np.random.RandomState(3).rand(256, 3).astype(np.float32)
SCENES = {
    "sphere": (lambda: JVolume(_two_mat_sphere(), palette=PALETTE,
                               pos=(0.1, -0.05, 0.2), vpu=20.0),
               (1.2, 0.9, -1.4), (0.1, -0.05, 0.2)),
    "noise": (lambda: JVolume.noise_filled((32, 32, 32)),
              (-1.1, 1.2, -1.9), (0.0, 0.0, 0.0)),
}


def _np(d):
    return {k: np.asarray(v) for k, v in d.items()}


# ---------------------------------------------------------------------------
# Sky and hit record
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", [(256, 128), (64, 32)])
def test_procedural_sky_pixels_equal(size):
    np.testing.assert_array_equal(SkyDome.procedural(*size).pixels,
                                  JSky.procedural(*size).pixels)


def test_sample_sky_matches_jax():
    rng = np.random.RandomState(0)
    d = rng.randn(4096, 3)
    # poles, the +-x seam of the longitude wrap (z = +-0 at x < 0)
    d[:6] = [[0, 1, 0], [0, -1, 0], [-1, 0, 0.0], [-1, 0, -0.0],
             [-1, 0.1, 1e-7], [-1, -0.1, -1e-7]]
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    for jsky in (JSky.procedural(256, 128), JSky.constant((0.2, 0.3, 0.4))):
        ref = np.asarray(j_sample_sky(jsky.data(), jnp.asarray(d)))
        out = sample_sky(skydome_from_jax(jsky).data("cpu"), torch.from_numpy(d))
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-6, rtol=0)


def test_from_hdr_matches_jax(tmp_path):
    """A small Radiance file with one flat and one RLE scanline."""
    rng = np.random.RandomState(4)
    w = 12
    flat = rng.randint(1, 256, (w, 4)).astype(np.uint8)
    rle = rng.randint(1, 256, (4, w)).astype(np.uint8)
    rle[3] = 130                                  # exponent byte: one run
    row2 = b"\x02\x02" + bytes([w >> 8, w & 255])
    for c in range(3):
        row2 += bytes([w]) + rle[c].tobytes()     # literal
    row2 += bytes([128 + w, 130])                 # run
    path = tmp_path / "sky.hdr"
    path.write_bytes(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 2 +X %d\n" % w
                     + flat.tobytes() + row2)
    np.testing.assert_array_equal(SkyDome.from_hdr(str(path)).pixels,
                                  JSky.from_hdr(str(path)).pixels)
    assert SkyDome.from_hdr(str(path)).pixels.shape == (2, w, 3)


def test_hit_result_nearer_and_miss():
    n = 257

    def rec(seed):
        r = np.random.RandomState(seed)
        t = np.where(r.rand(n) < 0.3, 1e30, r.rand(n)).astype(np.float32)
        return (t, r.randint(0, 256, n).astype(np.int32),
                r.randn(n, 3).astype(np.float32), r.rand(n, 3).astype(np.float32),
                r.randint(0, 50, n).astype(np.int32), r.randint(-1, 3, n).astype(np.int32))

    a, b = rec(2), rec(3)
    b[0][:16] = a[0][:16]                       # ties keep self
    ref = jcomposite.HitResult(*map(jnp.asarray, a)).nearer(
        jcomposite.HitResult(*map(jnp.asarray, b)))
    out = HitResult(*map(torch.from_numpy, a)).nearer(
        HitResult(*map(torch.from_numpy, b)))
    for f, x in zip(HitResult._fields, out):
        np.testing.assert_array_equal(x.numpy(), np.asarray(getattr(ref, f)), f)
    for x, y in zip(HitResult.miss(5, "cpu"), jcomposite.HitResult.miss(5)):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


# ---------------------------------------------------------------------------
# Profiling scene
# ---------------------------------------------------------------------------

def test_bake_aligned_scene_matches_jax():
    """A 2x2x2 crate field of the profiling scene, baked."""
    ref = jrf.bake_aligned_scene(jprof.profiling_volumes(2))
    out = renderer_fast.bake_aligned_scene(profiling.profiling_volumes(2))
    np.testing.assert_array_equal(out.grid, ref.grid)
    np.testing.assert_array_equal(out.pos, ref.pos)
    np.testing.assert_array_equal(out.palette, ref.palette)
    assert out.grid.shape == (64, 64, 64) and out.vpu == ref.vpu
    np.testing.assert_array_equal(profiling.profiling_camera(16 / 9).pos.numpy(),
                                  np.asarray(jprof.profiling_camera(16 / 9).pos))


def test_profiling_volumes_procedural_without_asset_dir(monkeypatch, tmp_path):
    """Crates come from VOXEL_TRACER_ASSET_DIR only; unset, or naming a
    directory without them, the scene is the procedural one."""
    for asset_dir in (None, str(tmp_path)):
        monkeypatch.setattr(profiling, "ASSET_DIR", asset_dir)
        vols = profiling.profiling_volumes(2)
        assert len(vols) == 8
        for v in vols:
            np.testing.assert_array_equal(v.grid, profiling._procedural_crate())


def test_profiling_trace_and_annotate(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("frame"):
            torch.ones(4).sum()
    assert (tmp_path / "trace.json").exists()


# ---------------------------------------------------------------------------
# Kernel renderer
# ---------------------------------------------------------------------------

def test_intersect_volume_fast_matches_jax():
    """Random world rays through the sphere: most fight their Pallas
    tile's major axis and take the XLA DDA fallback there."""
    jv = SCENES["sphere"][0]()
    rng = np.random.RandomState(7)
    n = 2048
    o = (rng.rand(n, 3) * 2.0 - 1.0).astype(np.float32) + jv.pos
    tgt = (rng.rand(n, 3) * 0.6 - 0.3).astype(np.float32) + jv.pos
    d = tgt - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    ref = jint.intersect_volume_fast(jint.FastVolume(jv), jnp.asarray(o),
                                     jnp.asarray(d), use_fallback=True)
    fv = integrate.FastVolume(volume_from_jax(jv), device="cpu")
    out = integrate.intersect_volume_fast(fv, torch.from_numpy(o),
                                          torch.from_numpy(d), use_fallback=True)
    ref = {f: np.asarray(getattr(ref, f)) for f in HitResult._fields}
    out = {f: getattr(out, f).numpy() for f in HitResult._fields}
    hit = ref["t"] < 1e30
    assert hit.sum() > 500
    same = hit == (out["t"] < 1e30)
    assert (~same).sum() <= BUDGET
    both = same & hit
    np.testing.assert_allclose(out["t"][both], ref["t"][both], atol=1e-5, rtol=0)
    for f in ("mat", "normal", "obj"):
        np.testing.assert_array_equal(out[f][same], ref[f][same], f)
    np.testing.assert_allclose(out["albedo"][same], ref["albedo"][same], atol=1e-6, rtol=0)


def test_fallback_traces_only_unresolved_rays():
    """B5 resolves every ray, so the fallback branch runs only on a trace
    that leaves some unresolved: here B5's plain version with every third
    ray marked unresolved and its hit dropped, as a Pallas residue ray.
    With use_fallback those rays come back from `ops/dda.py` as the full
    trace has them; without it they are misses."""
    from voxel_tracer_tpu_torch.ops.cuda import coherent

    fv = integrate.FastVolume(volume_from_jax(SCENES["sphere"][0]()), device="cpu")
    rng = np.random.RandomState(8)
    n = 1024
    o = torch.from_numpy((rng.rand(n, 3) * 2.0 - 1.0).astype(np.float32)) + fv.pos
    d = torch.from_numpy(rng.rand(n, 3).astype(np.float32) * 0.6 - 0.3) + fv.pos - o
    d = d / d.norm(dim=1, keepdim=True)
    drop = torch.arange(n) % 3 == 0

    def residue(*args):
        res = dict(coherent.trace_coherent_plain(*args))
        res["resolved"] = res["resolved"] & ~drop
        res["t"] = torch.where(drop, torch.full_like(res["t"], coherent.BIG), res["t"])
        return res

    full = integrate._trace_fast(fv, o, d)
    fb = integrate._trace_fast(fv, o, d, use_fallback=True, trace_fn=residue)
    sky = integrate._trace_fast(fv, o, d, use_fallback=False, trace_fn=residue)
    hit = full.t < 1e30
    assert hit[drop].sum() > 100
    assert (sky.t[drop] >= 1e30).all() and (sky.mat[drop] == 0).all()
    assert torch.equal(sky.t[~drop], full.t[~drop])
    same = hit == (fb.t < 1e30)
    assert (~same).sum() <= BUDGET
    both = same & hit
    np.testing.assert_allclose(fb.t[both].numpy(), full.t[both].numpy(), atol=1e-5, rtol=0)
    for f in ("mat", "normal", "albedo", "obj"):
        np.testing.assert_array_equal(getattr(fb, f)[same].numpy(),
                                      getattr(full, f)[same].numpy(), f)
    assert torch.equal(fb.steps[~drop], full.steps[~drop])


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_render_flat_fast_matches_jax(scene):
    make, campos, target = SCENES[scene]
    jv = make()
    jcam = JCamera.create(campos, target, W / H)
    sky = JSky.procedural(64, 32)
    ref = _np(jint.render_flat_fast(jint.FastVolume(jv), jnp.asarray(sky.pixels),
                                    jcam, W, H, use_fallback=True))
    fv = integrate.FastVolume(volume_from_jax(jv), device="cpu")
    out = {k: v.numpy() for k, v in integrate.render_flat_fast(
        fv, torch.from_numpy(sky.pixels), camera_from_jax(jcam), W, H).items()}
    assert out["image"].shape == (H, W, 3)
    same = (ref["depth"] < 1e30) == (out["depth"] < 1e30)
    assert (~same).sum() <= BUDGET
    both = same & (ref["depth"] < 1e30)
    assert both.sum() > 300
    np.testing.assert_allclose(out["depth"][both], ref["depth"][both], atol=1e-5, rtol=0)
    assert np.abs(out["image"] - ref["image"])[same].max() <= LSB


def test_render_flat_fast_plain_equals_render_flat_fast_on_cpu():
    """`render_flat_fast_plain` (chip_smoke.py's plain-traced flat frame)
    is `render_flat_fast` with B5's plain version: on CPU tensors, where
    the wrapper runs that version too, the frames are equal."""
    make, campos, target = SCENES[sorted(SCENES)[0]]
    jv = make()
    jcam = JCamera.create(campos, target, W / H)
    fv = integrate.FastVolume(volume_from_jax(jv), device="cpu")
    sky = torch.from_numpy(JSky.procedural(64, 32).pixels)
    a = integrate.render_flat_fast(fv, sky, camera_from_jax(jcam), W, H)
    b = integrate.render_flat_fast_plain(fv, sky, camera_from_jax(jcam), W, H)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert bool((a["depth"] < 1e30).any())


def _compare_lit(ref, out, min_hits=300):
    hr, ho = ref["depth"] < 1e30, out["depth"] < 1e30
    irr_bad = np.abs(out["irradiance"] - ref["irradiance"]).max(-1) > 1e-5
    bad = (hr != ho) | irr_bad
    assert bad.sum() <= BUDGET, f"{bad.sum()} pixels flip hit or shadow"
    ok = ~bad
    both = ok & hr
    assert both.sum() > min_hits
    np.testing.assert_allclose(out["depth"][both], ref["depth"][both], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(out["material"][ok], ref["material"][ok])
    np.testing.assert_array_equal(out["normal"][ok], ref["normal"][ok])
    assert np.abs(out["image"] - ref["image"])[ok].max() <= LSB
    np.testing.assert_allclose(out["albedo"][ok], ref["albedo"][ok], atol=1e-6, rtol=0)


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_render_lambert_fast_carried_across_matches_jax(scene):
    """A JAX SkyDome and VoxelVolume carried across with `convert` render
    the same lit frame through both packages."""
    make, campos, target = SCENES[scene]
    jv = make()
    jcam = JCamera.create(campos, target, W / H)
    jsky = JSky.procedural(64, 32)
    ref = _np(jrf.render_lambert_fast(jrf.FastScene.build([jv], sky=jsky), jcam,
                                      W, H, use_fallback=True))
    scene_p = renderer_fast.FastScene.build(
        [volume_from_jax(jv)], sky=skydome_from_jax(jsky), device="cpu")
    out = {k: v.numpy() for k, v in renderer_fast.render_lambert_fast(
        scene_p, camera_from_jax(jcam), W, H).items()}
    assert set(out) == set(ref)
    for k in out:
        assert out[k].shape == ref[k].shape, k
    _compare_lit(ref, out)
    lit = out["irradiance"][..., 0] > 0.2 + 1e-6
    assert 0 < lit[out["depth"] < 1e30].mean() < 1


def test_two_volume_scene_min_combine():
    """Two unbaked volumes, one kernel launch per volume and pass, min-
    combined: the nearer hit wins and steps add."""
    jvs = [JVolume(_two_mat_sphere(), palette=PALETTE, pos=(0.1, -0.05, 0.2)),
           JVolume(_two_mat_sphere(), palette=PALETTE[::-1].copy(),
                   pos=(0.55, 0.1, 0.6))]
    jcam = JCamera.create((1.3, 0.9, -1.2), (0.3, 0.0, 0.4), W / H)
    ref = _np(jrf.render_lambert_fast(jrf.FastScene.build(jvs), jcam, W, H,
                                      use_fallback=True))
    scene_p = renderer_fast.FastScene.build([volume_from_jax(v) for v in jvs],
                                            device="cpu")
    out = {k: v.numpy() for k, v in renderer_fast.render_lambert_fast(
        scene_p, camera_from_jax(jcam), W, H).items()}
    _compare_lit(ref, out)
    # both volumes show up in the frame
    assert {23, 140} <= set(np.unique(out["material"]))
    assert len(np.unique(out["albedo"].reshape(-1, 3), axis=0)) >= 4


def test_fast_volume_refresh_after_set_voxel():
    jv = SCENES["sphere"][0]()
    vol = volume_from_jax(jv)
    fv = integrate.FastVolume(vol, device="cpu")
    o_l = torch.tensor([[-1.0, 0.41, 0.39]])
    o = o_l - torch.from_numpy(vol.pivot) + torch.from_numpy(vol.pos)
    d = torch.tensor([[1.0, 0.0, 0.0]])
    before = integrate.intersect_volume_fast(fv, o, d)
    vol.set_voxel(0, 8, 7, 77)              # a voxel in front of the sphere
    stale = integrate.intersect_volume_fast(fv, o, d)
    fv.refresh()
    after = integrate.intersect_volume_fast(fv, o, d)
    assert int(stale.mat[0]) == int(before.mat[0]) != 77
    assert int(after.mat[0]) == 77
    assert float(after.t[0]) < float(before.t[0])


def test_default_without_fallback_matches_on_resolved():
    """JAX's default leaves the Pallas residue as sky: a wide 120x30 frame
    in raster order (not tile order) leaves ~22 % of its rays fighting
    their tile's major axis.  The camera sits off the voxel planes: from a
    point on one, rays that graze it enter one voxel row or the next
    depending on the last bit of their direction, which the jitted JAX
    raygen rounds differently.  The port resolves them all."""
    jv = SCENES["noise"][0]()
    w, h = 120, 30
    jcam = JCamera.create((-0.213, 0.517, 0.219), (1.0, 0.5, 1.2), 4.0)
    sky = JSky.procedural(64, 32)
    ref = _np(jint.render_flat_fast(jint.FastVolume(jv), jnp.asarray(sky.pixels),
                                    jcam, w, h))
    ref_fb = _np(jint.render_flat_fast(jint.FastVolume(jv), jnp.asarray(sky.pixels),
                                       jcam, w, h, use_fallback=True))
    # which rays the Pallas kernel resolved (raster order, as the frame)
    o, d = j_rays(jcam, w, h)
    data = jv.data()
    o_l, d_l = jcomposite._to_local(data.rot, data.pos, data.pivot, o, d)
    pad = (-o_l.shape[0]) % jcoh.TILE
    o_l = jnp.concatenate([o_l, jnp.zeros((pad, 3))])
    d_l = jnp.concatenate([d_l, jnp.tile(jnp.float32([[0, 0, 1]]), (pad, 1))])
    pk = jcoh.pack_volume(jv.grid, jv.vpu)
    resolved = np.asarray(jcoh.trace_coherent(pk.occ, pk.words, o_l, d_l,
                                              pk.bsize, pk.vpu)["resolved"])
    resolved = resolved[:w * h].reshape(h, w)
    assert 0.5 < resolved.mean() < 0.95

    fv = integrate.FastVolume(volume_from_jax(jv), device="cpu")
    out = {k: v.numpy() for k, v in integrate.render_flat_fast(
        fv, torch.from_numpy(sky.pixels), camera_from_jax(jcam), w, h).items()}
    for r, mask in ((ref, resolved), (ref_fb, np.ones_like(resolved))):
        same = (r["depth"] < 1e30) == (out["depth"] < 1e30)
        assert (mask & ~same).sum() <= BUDGET
        ok = mask & same
        both = ok & (r["depth"] < 1e30)
        np.testing.assert_allclose(out["depth"][both], r["depth"][both], atol=1e-5, rtol=0)
        assert np.abs(out["image"] - r["image"])[ok].max() <= LSB
    # the residue is sky in the JAX default and traced in the port
    assert (out["depth"][~resolved] < 1e30).sum() > 100
    assert (ref["depth"][~resolved] >= 1e30).all()

