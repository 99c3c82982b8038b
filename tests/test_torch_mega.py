"""Parity: the port's frame (`voxel_tracer_tpu_torch.ops.cuda.mega`) vs the
JAX package, on CPU, at 64x32.

On CPU tensors the port runs the plain PyTorch versions of its kernel;
the JAX side runs its Pallas kernel in interpret mode, as tests/test_mega.py
does.  Scenes are built in code (the two-material sphere of
tests/test_mega.py:19-32 and the bench.py noise volume) and carried across
with `convert`.

Tolerances, each against the JAX function named in the test:
- Pallas frames (`render_mega`, `render_mega_tiles`), on pixels both
  hit or both miss and the JAX kernel resolved: image within 1 LSB, depth
  within 2e-3 (the oracle tolerance of tests/test_mega.py:63), mat equal.
  The hit mask may differ at a pinned number of silhouette pixels: the
  Pallas traversal computes its crossings with other float32 operations
  (span scans, slice windows) and its raygen with an approximate rsqrt,
  so a ray that grazes a voxel corner can land on either side.
- `trace_rays`: hit and mat equal and t within 2e-3 against the Pallas
  kernel where it resolved, and against `oracle.intersect_volume` on
  every ray up to the pinned budget of tests/test_dda_parity.py.
- `render_lambert_mega` against the XLA wavefront `Renderer`: hit mask
  equal, depth atol 1e-5, normals equal, irradiance atol 1e-5.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from voxel_tracer_tpu.models.camera import Camera as JCamera
from voxel_tracer_tpu.models.volume import VoxelVolume as JVolume
from voxel_tracer_tpu.ops import oracle
from voxel_tracer_tpu.ops.pallas import mega as jmega

from voxel_tracer_tpu_torch.convert import camera_from_jax, volume_from_jax
from voxel_tracer_tpu_torch.ops.cuda import mega

torch.set_num_threads(1)

W, H = 64, 32
# PINNED budgets of silhouette pixels whose hit flips between the port and
# the Pallas traversal: 0 observed on both scenes (jax 0.9.0, torch 2.13);
# the headroom covers float jitter across versions only
HIT_MISMATCH_SPHERE = 1
HIT_MISMATCH_BENCH = 2
ORACLE_MISMATCH = 2   # as tests/test_dda_parity.py


def _two_mat_sphere(n=16, r=0.42):
    z, y, x = np.meshgrid(*[np.arange(n)] * 3, indexing="ij")
    c = (n - 1) / 2
    d = np.sqrt((x - c) ** 2 + (y - c) ** 2 + (z - c) ** 2)
    grid = np.where(d < r * n, np.where(y > c, 140, 23), 0)
    return grid.astype(np.uint8)


@pytest.fixture(scope="module")
def jscene():
    palette = np.random.RandomState(3).rand(256, 3).astype(np.float32)
    return JVolume(_two_mat_sphere(), palette=palette, pos=(0.1, -0.05, 0.2),
                   vpu=20.0)


@pytest.fixture(scope="module")
def jcam():
    return JCamera.create((1.2, 0.9, -1.4), (0.1, -0.05, 0.2), W / H)


def _np(d):
    return {k: np.asarray(v) for k, v in d.items()}


def _compare_frames(ref, out, resolved, budget):
    """ref/out: image (H,W,3), depth (H,W), mat (H,W) dicts."""
    hit_r = ref["depth"] < 1e30
    hit_o = out["depth"] < 1e30
    assert (out["resolved"] == 1).all()
    flips = (hit_r != hit_o) & resolved
    assert flips.sum() <= budget, f"{flips.sum()} hit-mask flips"
    same = (hit_r == hit_o) & resolved
    both = same & hit_r
    assert both.sum() > 60
    diff = np.abs(ref["image"].astype(int) - out["image"].astype(int))
    assert diff[same].max() <= 1
    np.testing.assert_allclose(out["depth"][both], ref["depth"][both],
                               atol=2e-3, rtol=0)
    np.testing.assert_array_equal(out["mat"][both], ref["mat"][both])


@pytest.mark.parametrize("shading", ["flat", "lambert"])
def test_render_mega_matches_pallas(jscene, jcam, shading):
    ref = _np(jmega.render_mega(jmega.MegaVolume(jscene), jcam, W, H,
                                shading=shading, interpret=True))
    mv = mega.MegaVolume(volume_from_jax(jscene), device="cpu")
    out = _np(mega.render_mega(mv, camera_from_jax(jcam), W, H,
                               shading=shading))
    assert out["image"].shape == (H, W, 3) and out["image"].dtype == np.uint8
    _compare_frames(ref, out, ref["resolved"] == 1, HIT_MISMATCH_SPHERE)


def test_trace_rays_matches_pallas_and_oracle(jscene):
    rng = np.random.RandomState(7)
    n = 1024
    o = (rng.rand(n, 3) * 1.6 - 0.4).astype(np.float32)
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tb = jmega.MegaVolume(jscene).tables
    ref = _np(jmega.trace_rays(jnp.asarray(o), jnp.asarray(d), tb.occ,
                               tb.occw, tb.wsm, tb.matw, bsize=tb.bsize,
                               vpu=tb.vpu, fetch_mat=True, interpret=True))
    mv = mega.MegaVolume(volume_from_jax(jscene), device="cpu")
    out = {k: v.numpy() for k, v in mega.trace_rays(
        torch.from_numpy(o), torch.from_numpy(d), mv.tables,
        fetch_mat=True).items()}
    assert out["resolved"].all()
    hit = out["t"] < 1e30

    res = ref["resolved"]
    assert res.mean() > 0.3
    np.testing.assert_array_equal(hit[res], ref["t"][res] < 1e30)
    both = res & hit
    assert both.sum() > 20
    np.testing.assert_allclose(out["t"][both], ref["t"][both], atol=2e-3,
                               rtol=0)
    np.testing.assert_array_equal(out["mat"][both], ref["mat"][both])

    # local frame: the oracle volume's pos is the pivot
    ov = oracle.OracleVolume(grid=jscene.grid, vpu=jscene.vpu,
                             pos=np.asarray(jscene.pivot))
    n_bad = n_hit = 0
    for i in range(n):
        hh = oracle.intersect_volume(ov, o[i], d[i])
        if hh.no_hit != (not hit[i]) or (
                not hh.no_hit
                and not (np.isclose(out["t"][i], hh.depth, atol=2e-3, rtol=0)
                         and out["mat"][i] == hh.material)):
            n_bad += 1
        n_hit += not hh.no_hit
    assert n_hit > 50
    assert n_bad <= ORACLE_MISMATCH, f"{n_bad} rays disagree with the oracle"


def test_lambert_mega_matches_wavefront(jscene, jcam):
    from voxel_tracer_tpu.models.scene import Scene
    from voxel_tracer_tpu.models.skydome import SkyDome
    from voxel_tracer_tpu.renderer import RenderConfig, Renderer

    sc = Scene(volumes=[jscene], skydome=SkyDome.black())
    r = Renderer(RenderConfig(width=W, height=H, shading="lambert"))
    ref = _np(r.render(sc.data(), jcam))
    mv = mega.MegaVolume(volume_from_jax(jscene), device="cpu")
    out = {k: v.numpy() for k, v in mega.render_lambert_mega(
        mv, camera_from_jax(jcam), W, H).items()}

    hit = ref["depth"] < 1e30
    assert hit.sum() > 60
    np.testing.assert_array_equal(hit, out["depth"] < 1e30)
    np.testing.assert_allclose(out["depth"][hit], ref["depth"][hit],
                               atol=1e-5, rtol=0)
    np.testing.assert_array_equal(out["normal"][hit], ref["normal"][hit])
    np.testing.assert_allclose(out["irradiance"][hit], ref["irradiance"][hit],
                               atol=1e-5, rtol=0)
    assert out["image"].shape == (H, W, 3)


def test_bench_shaped_hier3_frame():
    """bench.py's frame (hier3 span scan, mat16, 16^3 super-bricks) at
    64x32, untiled to image order, vs the port's render_mega.

    32x32-pixel tiles: with one 64x32 tile (tile_rows=16, tile_w=64) the
    hier3 kernel misses 99 of this frame's hits and flags them resolved,
    where the oracle, the 8^3 brick traversal and the port agree."""
    jvol = JVolume.noise_filled((64, 64, 64), pos=(0, 0, 0), vpu=20.0)
    jmv = jmega.MegaVolume(jvol)
    sun = jnp.asarray([-0.619501, 0.465931, -0.631765], jnp.float32)
    # bench.py cam_params at theta = 0
    jcam = JCamera.create((2.0, 1.4, -2.4), (0.0, 0.0, 0.0), W / H)
    cam_p = jmega.mega_camera(jmv, jcam, sun, W, H)
    tile_rows, tile_w = 8, 32
    rgba, t, aux = jmega.render_mega_tiles(
        cam_p, jmv.occ16, jmv.ensure_axes(), jnp.zeros((1, 1), jnp.int32),
        jmv.matw16, jmv.pal, width=W, height=H, tile_rows=tile_rows,
        tile_w=tile_w, fine_unroll=4, fine_iters=48, track_steps=False,
        mat16=True, traversal="hier3", interpret=True, **jmv.brick16_kw())
    tile_h = tile_rows * 128 // tile_w
    rgba, t, aux = (np.asarray(jmega.untile(a.reshape(-1), H, W, tile_h,
                                            tile_w)).reshape(H, W)
                    for a in (rgba, t, aux))
    ref = dict(image=np.stack([(rgba >> s) & 255 for s in (0, 8, 16)], -1),
               depth=t, mat=aux & 255)
    resolved = ((aux >> jmega.AUX_RESOLVED_SHIFT) & 1) == 1

    mv = mega.MegaVolume(volume_from_jax(jvol), device="cpu")
    out = _np(mega.render_mega(mv, camera_from_jax(jcam), W, H,
                               sun_dir=np.asarray(sun)))
    _compare_frames(ref, out, resolved, HIT_MISMATCH_BENCH)


def test_port_imports_no_jax():
    """Every module of the port, the parallel and host layers included,
    imports without jax or the JAX package."""
    code = ("import pkgutil, sys, importlib\n"
            "import voxel_tracer_tpu_torch as pkg\n"
            "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
            "for name in names:\n"
            "    importlib.import_module(name)\n"
            "assert len(names) > 60, names\n"
            "need = ('parallel.mesh parallel.distributed parallel.sharding "
            "parallel.grid_shard parallel.grid_train parallel.worker engine.pool "
            "engine.gjk engine.sat engine.physics config ops.curves ops.denoise "
            "ops.oracle_native utils.aov utils.debug_draw examples.render_vox').split()\n"
            "missing = [m for m in need if pkg.__name__ + '.' + m not in names]\n"
            "assert not missing, missing\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'voxel_tracer_tpu')]\n"
            "assert not bad, bad\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
