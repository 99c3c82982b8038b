"""Parity: the port's differentiable surface path (`ops/diff_surface.py`)
against the JAX package's, on the CPU.

The wavefront variant runs on tests/test_diff_surface.py's `_setup` (a
two-material 24^3 sphere, 24x24 rays) in both packages; `jax.grad` and
`torch.autograd.grad` differentiate the same loss.  The kernel-backed
variant runs the plain versions of B1 / B2 here and is held to the JAX
function in interpret mode with 32-wide tiles (ROADMAP C, hier3 caveat).
Tolerances: colour within 1e-5 (the same float32 shading on the same
hits); gradients within 1e-5 x max|g| (the palette gather's backward sums
the rays of one material in another order in each package).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from voxel_tracer_tpu.models.camera import Camera as JCamera
from voxel_tracer_tpu.models.camera import rays_for_image as jrays_for_image
from voxel_tracer_tpu.models.scene import Scene as JScene
from voxel_tracer_tpu.models.skydome import SkyDome as JSkyDome
from voxel_tracer_tpu.models.volume import VoxelVolume as JVolume
from voxel_tracer_tpu.ops import diff_surface as jds
from voxel_tracer_tpu.ops.pallas import mega as jmega

from voxel_tracer_tpu_torch.convert import camera_from_jax, scene_from_jax, volume_from_jax
from voxel_tracer_tpu_torch.ops import diff_surface as tds
from voxel_tracer_tpu_torch.ops.cuda import mega

torch.set_num_threads(1)

COLOR_ATOL = 1e-5
GRAD_RTOL = 1e-5     # x max|g|


def _setup():
    z, y, x = np.meshgrid(*[np.arange(24)] * 3, indexing="ij")
    c = 11.5
    d = np.sqrt((x - c) ** 2 + (y - c) ** 2 + (z - c) ** 2)
    grid = np.where(d < 10, np.where(y > c, 40, 41), 0).astype(np.uint8)
    jsd = JScene(volumes=[JVolume(grid, vpu=20.0)],
                 skydome=JSkyDome.constant((0.2, 0.3, 0.4))).data()
    o, d_ = jrays_for_image(JCamera.create((1.3, 1.0, -1.6), (0, 0, 0), 1.0), 24, 24)
    return jsd, o, d_


@pytest.fixture(scope="module")
def setup():
    jsd, o, d = _setup()
    rng = np.random.RandomState(0)
    pal = rng.rand(256, 3).astype(np.float32)
    tgt = rng.rand(o.shape[0], 3).astype(np.float32)
    return dict(jsd=jsd, jo=o, jd=d, sd=scene_from_jax(jsd, device="cpu"),
                o=torch.from_numpy(np.array(o)), d=torch.from_numpy(np.array(d)),
                pal=pal, tgt=tgt)


def _grad_close(g_port, g_jax):
    g_jax = np.asarray(g_jax)
    np.testing.assert_allclose(g_port.numpy(), g_jax, rtol=0,
                               atol=GRAD_RTOL * np.abs(g_jax).max())


def test_colour_and_palette_gradient_match_jax(setup):
    s = setup
    ref = jds.render_lambert_surface(jnp.asarray(s["pal"]), s["jsd"], s["jo"], s["jd"])
    pal = torch.tensor(s["pal"], requires_grad=True)
    out = tds.render_lambert_surface(pal, s["sd"], s["o"], s["d"])
    np.testing.assert_allclose(out["color"].detach().numpy(), np.asarray(ref["color"]),
                               rtol=0, atol=COLOR_ATOL)
    np.testing.assert_array_equal(out["hit"].numpy(), np.asarray(ref["hit"]))
    np.testing.assert_array_equal(out["mat"].numpy(), np.asarray(ref["mat"]))
    assert 0.1 < float(out["hit"].float().mean()) < 0.9

    tgt = torch.from_numpy(s["tgt"])
    g_jax = jax.grad(lambda p: jds.palette_fit_loss(p, s["jsd"], s["jo"], s["jd"],
                                                    jnp.asarray(s["tgt"])))(
        jnp.asarray(s["pal"]))
    (g,) = torch.autograd.grad(tds.palette_fit_loss(pal, s["sd"], s["o"], s["d"], tgt), pal)
    _grad_close(g, g_jax)
    nz = set(torch.nonzero(g.abs().sum(1)).reshape(-1).tolist())
    assert nz == {40, 41}                  # gradients land on hit materials only


def test_sun_light_gradient_matches_jax(setup):
    s = setup
    sl0 = np.array([0.9, 0.85, 0.8], np.float32)
    pal_t, tgt_t = torch.from_numpy(s["pal"]), torch.from_numpy(s["tgt"])

    def jloss(sl):
        out = jds.render_lambert_surface(jnp.asarray(s["pal"]), s["jsd"], s["jo"], s["jd"],
                                         sun_light=sl)
        return jnp.mean((out["color"] - jnp.asarray(s["tgt"])) ** 2)

    sl = torch.tensor(sl0, requires_grad=True)
    loss = torch.mean((tds.render_lambert_surface(pal_t, s["sd"], s["o"], s["d"],
                                                  sun_light=sl)["color"] - tgt_t) ** 2)
    (g,) = torch.autograd.grad(loss, sl)
    g_jax = jax.grad(jloss)(jnp.asarray(sl0))
    _grad_close(g, g_jax)
    assert float(g.abs().min()) > 0


def test_palette_fit_converges(setup):
    """Recover a palette from renders (test_diff_surface.py's inverse
    problem) with torch.optim.SGD on the port's loss: 25 steps at lr 15
    (the JAX test takes 250 at lr 4; the loss is quadratic in the palette
    and these steps stay below 2 / its largest curvature)."""
    s = setup
    pal_true = torch.from_numpy(np.random.RandomState(2).rand(256, 3).astype(np.float32))
    target = tds.render_lambert_surface(pal_true, s["sd"], s["o"], s["d"])
    pal = torch.full((256, 3), 0.5, requires_grad=True)
    opt = torch.optim.SGD([pal], lr=15.0)
    losses = []
    for _ in range(25):
        opt.zero_grad()
        loss = tds.palette_fit_loss(pal, s["sd"], s["o"], s["d"], target["color"].detach())
        loss.backward()
        opt.step()
        losses.append(loss.item())
    assert losses[-1] < losses[0] * 0.05, (losses[0], losses[-1])
    for m in (40, 41):
        np.testing.assert_allclose(pal.detach()[m].numpy(), pal_true[m].numpy(), atol=0.08)


def test_surface_mega_matches_jax_interpret():
    """The kernel-backed variant (plain B1 / B2 on the CPU) against the
    JAX kernel path in interpret mode: colour, hits and the palette
    gradient."""
    w, h = 64, 32
    jvol = JVolume.noise_filled((16, 16, 16), pos=(0, 0, 0), vpu=10.0)
    jcam = JCamera.create((2.2, 1.5, -2.0), (0.8, 0.8, 0.8), w / h)
    rng = np.random.RandomState(7)
    pal = rng.rand(256, 3).astype(np.float32)
    tgt = rng.rand(w * h, 3).astype(np.float32)
    kw = dict(tile_rows=8, tile_w=32, interpret=True)
    jmv = jmega.MegaVolume(jvol)
    ref = jds.render_lambert_surface_mega(jnp.asarray(pal), jmv, jcam, w, h, **kw)
    g_jax = jax.grad(lambda p: jds.palette_fit_loss_mega(p, jmv, jcam, w, h,
                                                         jnp.asarray(tgt), **kw))(
        jnp.asarray(pal))

    mv = mega.MegaVolume(volume_from_jax(jvol), device="cpu")
    cam = camera_from_jax(jcam)
    pal_t = torch.tensor(pal, requires_grad=True)
    out = tds.render_lambert_surface_mega(pal_t, mv, cam, w, h, **kw)
    np.testing.assert_array_equal(out["hit"].numpy(), np.asarray(ref["hit"]))
    np.testing.assert_array_equal(out["mat"].numpy(), np.asarray(ref["mat"]))
    np.testing.assert_allclose(out["color"].detach().numpy(), np.asarray(ref["color"]),
                               rtol=0, atol=COLOR_ATOL)
    assert 0.1 < float(out["hit"].float().mean()) < 0.9
    (g,) = torch.autograd.grad(
        tds.palette_fit_loss_mega(pal_t, mv, cam, w, h, torch.from_numpy(tgt)), pal_t)
    _grad_close(g, g_jax)
    # the plain launcher passed explicitly gives the same values
    plain = tds.render_lambert_surface_mega(pal_t, mv, cam, w, h,
                                            lambert_fn=mega.render_lambert_mega_plain)
    assert torch.equal(plain["color"], out["color"])
