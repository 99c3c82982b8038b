"""Parity: the port's remaining host layers against the JAX package's:
AOV display modes (tests/test_utils.py), the C++ oracle binding
(tests/test_native.py, with its skip when `native/liboracle.so` is not
built), the run-time configuration, and the `render_vox` example on a
.vox file written in tmp_path.

Display images and configs are equal; oracle hits as test_native.py
holds them (t within 2e-3, material equal); `render_vox`'s wavefront
frame on the CPU equals the JAX `Renderer`'s hit mask and materials,
depth within 1e-5 (the port's renderer parity, tests/test_torch_renderer.py).
"""

import argparse
import dataclasses
import json

import numpy as np
import pytest
import torch

from voxel_tracer_tpu import config as jconfig
from voxel_tracer_tpu.ops import oracle_native as joracle_native
from voxel_tracer_tpu.utils import aov as jaov
from voxel_tracer_tpu_torch import config as tconfig
from voxel_tracer_tpu_torch.models.vox import vox_bytes
from voxel_tracer_tpu_torch.ops import oracle, oracle_native
from voxel_tracer_tpu_torch.utils import aov


def _aovs(seed, h=8, w=8):
    rng = np.random.RandomState(seed)
    n = rng.randn(h, w, 3).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    return dict(
        image=rng.rand(h, w, 3).astype(np.float32),
        albedo=rng.rand(h, w, 3).astype(np.float32) * 1.2,
        irradiance=rng.rand(h, w, 3).astype(np.float32) * 1.5,
        normal=n,
        depth=np.where(rng.rand(h, w) > 0.5, rng.rand(h, w) * 4, 1e30).astype(np.float32),
        steps=rng.randint(0, 200, (h, w)).astype(np.int32),
        material=rng.randint(0, 255, (h, w)).astype(np.int32),
    )


@pytest.mark.parametrize("mode", aov.DISPLAY_MODES)
def test_display_matches_jax(mode):
    """Each display mode of tensors (the port's AOVs) equals the JAX mode
    of the same arrays, in [0, 1]."""
    arrays = _aovs(1)
    img = aov.display({k: torch.from_numpy(v) for k, v in arrays.items()}, mode)
    assert img.shape == (8, 8, 3) and np.isfinite(img).all()
    assert img.min() >= 0.0 and img.max() <= 1.0 + 1e-6
    np.testing.assert_array_equal(img, jaov.display(arrays, mode))
    assert aov.DISPLAY_MODES == jaov.DISPLAY_MODES
    with pytest.raises(ValueError):
        aov.display(arrays, "nope")


@pytest.mark.skipif(not oracle_native.available(),
                    reason="liboracle.so not built (native/build.sh)")
def test_native_oracle_matches_python_oracle_and_jax():
    """tests/test_native.py's sweep through the port's binding, held to the
    port's scalar oracle and to the JAX package's binding."""
    from voxel_tracer_tpu_torch.models.volume import VoxelVolume
    vol = VoxelVolume.noise_filled((24, 24, 24))
    rng = np.random.RandomState(11)
    n = 200
    o_l = (rng.rand(n, 3) * 2.4 - 1.2 + vol.pivot).astype(np.float32)
    d = rng.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    res = oracle_native.trace(vol.grid, vol.brick_occ, vol.vpu, o_l, d)
    ref = joracle_native.trace(vol.grid, vol.brick_occ, vol.vpu, o_l, d)
    for k in res:
        np.testing.assert_array_equal(res[k], ref[k], err_msg=k)
    ov = oracle.OracleVolume(grid=vol.grid, vpu=vol.vpu)
    bad = 0
    for i in range(n):
        h = oracle.intersect_volume(ov, o_l[i] - vol.pivot, d[i])
        if h.no_hit != (res["t"][i] >= 1e29):
            bad += 1
        elif not h.no_hit and (not np.isclose(res["t"][i], h.depth, atol=2e-3)
                               or res["mat"][i] != h.material):
            bad += 1
    assert bad == 0


def test_config_resolution_matches_jax(tmp_path, monkeypatch):
    """defaults < JSON file < VXT_ environment < overrides, in both
    packages, with the same result."""
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps({"render": {"width": 640, "shading": "lambert"},
                                "seed": 3, "profiling": True}))
    monkeypatch.setenv("VXT_HEIGHT", "360")
    monkeypatch.setenv("VXT_USE_KERNEL", "false")
    monkeypatch.setenv("VXT_AMBIENT", "0.35")
    over = {"render": {"max_bounces": 2}, "checkpoint_dir": "ck"}
    got, ref = tconfig.load_config(str(path), over), jconfig.load_config(str(path), over)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert (got.render.width, got.render.height, got.render.shading) == (640, 360, "lambert")
    assert got.render.ambient == 0.35 and got.use_kernel is False and got.seed == 3
    assert got.render.max_bounces == 2 and got.checkpoint_dir == "ck"
    assert tconfig.load_config(str(tmp_path / "missing.json")).render.width == 1280


def test_config_from_args_matches_jax(monkeypatch):
    for key in [k for k in __import__("os").environ if k.startswith("VXT_")]:
        monkeypatch.delenv(key)
    for argv in ([], ["--size", "320x200", "--shading", "full", "--no-kernel"]):
        cfgs = []
        for pkg in (tconfig, jconfig):
            ap = argparse.ArgumentParser()
            pkg.add_config_args(ap)
            cfgs.append(dataclasses.asdict(pkg.config_from_args(ap.parse_args(argv))))
        assert cfgs[0] == cfgs[1]
    assert cfgs[0]["render"]["width"] == 320 and cfgs[0]["use_kernel"] is False


def _write_vox(path):
    """A floor slab and a pillar on it, 16^3 (MagicaVoxel is z-up)."""
    vox = [(x, y, z, 30) for x in range(2, 14) for y in range(2, 14) for z in range(0, 4)]
    vox += [(x, y, z, 40) for x in range(7, 9) for y in range(7, 9) for z in range(4, 14)]
    path.write_bytes(vox_bytes((16, 16, 16), np.array(vox)))


@pytest.mark.parametrize("mode", ["flat", "lambert"])
def test_render_vox_wavefront_matches_jax(tmp_path, mode):
    """The example's default path on the CPU against the JAX `Renderer` on
    the same file and camera; then its command line writes a PNG."""
    from voxel_tracer_tpu import Renderer, RenderConfig, Scene, VoxelVolume
    from voxel_tracer_tpu.models.skydome import SkyDome
    from voxel_tracer_tpu_torch.examples import render_vox
    path = tmp_path / "scene.vox"
    _write_vox(path)
    w, h, cam = 48, 32, (0.9, 0.7, -1.0)
    got = render_vox.render(str(path), w, h, mode, cam_pos=cam, device="cpu")
    r = Renderer(RenderConfig(width=w, height=h, shading=mode))
    vol = VoxelVolume.from_vox(str(path), pos=(0, 0, 0))
    ref = r.render(Scene(volumes=[vol], skydome=SkyDome.procedural()).data(),
                   r.camera(cam, (0.0, 0.0, 0.0)))
    hit = np.asarray(ref["depth"]) < 1e29
    assert 0.1 < hit.mean() < 0.9
    np.testing.assert_array_equal(got["depth"].numpy() < 1e29, hit)
    np.testing.assert_array_equal(got["material"].numpy(), np.asarray(ref["material"]))
    np.testing.assert_allclose(got["depth"].numpy()[hit], np.asarray(ref["depth"])[hit],
                               atol=1e-5)
    out = tmp_path / "out.png"
    assert render_vox.main(["--vox", str(path), "--out", str(out), "--size", f"{w}x{h}",
                            "--mode", mode, "--cam", ",".join(map(str, cam)),
                            "--device", "cpu"]) == 0
    assert out.stat().st_size > 0


def test_render_vox_fast_paths_on_cpu(tmp_path):
    """--fast on CPU tensors runs the kernels' plain versions: each mode's
    hit mask equals the wavefront frame's, and ``plain=True`` (the frame
    chip_smoke holds the kernels against) gives the same fields."""
    from voxel_tracer_tpu_torch.examples import render_vox
    path = tmp_path / "scene.vox"
    _write_vox(path)
    w, h, cam = 48, 32, (0.9, 0.7, -1.0)
    ref = render_vox.render(str(path), w, h, "flat", cam_pos=cam, device="cpu")["depth"] < 1e29
    for mode in ("flat", "lambert", "full"):
        out = render_vox.render(str(path), w, h, mode, fast=True, cam_pos=cam, device="cpu")
        assert torch.isfinite(out["image"]).all()
        assert torch.equal(out["depth"] < 1e29, ref), mode
        plain = render_vox.render(str(path), w, h, mode, fast=True, cam_pos=cam,
                                  device="cpu", plain=True)
        assert out.keys() == plain.keys()
        for f in out:
            assert torch.equal(out[f], plain[f]), (mode, f)


def test_grid_vox_bytes_round_trips():
    """`grid_vox_bytes` writes the file whose parsed grid is the grid it
    was given, through the port's parser and the JAX package's; the
    palette comes back rounded to 8 bits."""
    from voxel_tracer_tpu.models import vox as jvox
    from voxel_tracer_tpu_torch.models import vox as tvox
    rng = np.random.RandomState(5)
    grid = (rng.randint(0, 6, (9, 6, 11)) * (rng.rand(9, 6, 11) < 0.4)).astype(np.uint8)
    pal = rng.rand(256, 3).astype(np.float32)
    data = tvox.grid_vox_bytes(grid, pal)
    for parse in (tvox.parse_vox, jvox.parse_vox):
        (m,) = parse(data)
        np.testing.assert_array_equal(m.grid, grid)
        np.testing.assert_allclose(m.palette_f32[1:], pal[1:], atol=0.5 / 255 + 1e-6)
