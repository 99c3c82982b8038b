"""Render a MagicaVoxel scene to PNG: the end-to-end smoke example.

Counterpart of `examples/render_vox.py`.  The default path is the
wavefront `Renderer` (its DDA on the D1 kernel); ``--fast`` runs the
CUDA kernels: `render_mega` (B1) for flat, `render_lambert_mega` (B1 + B2) for lambert, and
`render_whitted_mega` on a `MegaIntersector` (B1 + B2) for full.

    python -m voxel_tracer_tpu_torch.examples.render_vox --vox model.vox \\
        [--out out.png] [--size WxH] [--mode flat|lambert|full] \\
        [--aov final|albedo|normals|depth|steps] [--fast] [--device cuda]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from voxel_tracer_tpu_torch.models.scene import Scene
from voxel_tracer_tpu_torch.models.skydome import SkyDome
from voxel_tracer_tpu_torch.models.volume import VoxelVolume
from voxel_tracer_tpu_torch.renderer import RenderConfig, Renderer
from voxel_tracer_tpu_torch.utils.aov import display
from voxel_tracer_tpu_torch.utils.framebuffer import write_png


def render(vox, width, height, mode="lambert", fast=False, cam_pos=(1.2, 1.0, -1.6),
           target=(0.0, 0.0, 0.0), device="cuda", plain=False):
    """One frame of the .vox file at ``vox``; returns the AOV dict (image
    as float in [0, 1]).  ``plain``: the same frame through the kernels'
    plain PyTorch versions, to hold the kernels against."""
    from voxel_tracer_tpu_torch.ops import composite, dda
    cfg = RenderConfig(width=width, height=height, shading=mode)
    renderer = Renderer(cfg, device=device, isect=composite.PLAIN if plain else composite)
    vol = VoxelVolume.from_vox(vox, pos=(0, 0, 0))
    camera = renderer.camera(cam_pos, target)
    if fast and mode == "full":
        from voxel_tracer_tpu_torch.ops.cuda import mega
        from voxel_tracer_tpu_torch.ops.cuda.whitted import (MegaIntersector,
                                                             render_whitted_mega)
        sdata = Scene(volumes=[vol], skydome=SkyDome.procedural()).data(device)
        fns = (dict(trace_fn=mega.trace_rays_plain, tiles_fn=mega.render_mega_tiles_plain,
                    dda_fn=dda.intersect_volume_local) if plain else {})
        isect = MegaIntersector(mega.MegaVolume(vol, device), shadow_rounds=2, **fns)
        return render_whitted_mega(isect, sdata, camera, width, height, 0, config=cfg)
    if fast:
        # the fused frames shade an analytic sky, not the texture sample
        from voxel_tracer_tpu_torch.ops.cuda import mega
        mv = mega.MegaVolume(vol, device)
        if mode == "flat":
            out = (mega.render_mega_plain if plain else mega.render_mega)(
                mv, camera, width, height)
            out["material"] = out.pop("mat")
        else:
            out = (mega.render_lambert_mega_plain if plain else mega.render_lambert_mega)(
                mv, camera, width, height)
        out["image"] = out["image"].float() / 255.0
        return out
    sdata = Scene(volumes=[vol], skydome=SkyDome.procedural()).data(device)
    return renderer.render(sdata, camera)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--vox", required=True, help="MagicaVoxel .vox file")
    ap.add_argument("--out", default="out.png")
    ap.add_argument("--size", default="320x240")
    ap.add_argument("--mode", default="lambert", choices=["flat", "lambert", "full"])
    ap.add_argument("--aov", default="final")
    ap.add_argument("--cam", default="1.2,1.0,-1.6", help="camera position")
    ap.add_argument("--target", default="0,0,0")
    ap.add_argument("--fast", action="store_true",
                    help="the CUDA kernels: render_mega / render_lambert_mega "
                         "for flat / lambert, render_whitted_mega for full")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    w, h = (int(v) for v in args.size.split("x"))
    t0 = time.perf_counter()
    aovs = render(args.vox, w, h, args.mode, args.fast,
                  tuple(float(v) for v in args.cam.split(",")),
                  tuple(float(v) for v in args.target.split(",")), args.device)
    img = aovs["image"].cpu().numpy()
    t1 = time.perf_counter()

    write_png(args.out, display(aovs, args.aov))
    hit_frac = float((aovs["depth"] < 1e29).float().mean())
    print(f"rendered {w}x{h} ({w * h} rays) in {t1 - t0:.2f}s "
          f"(incl. kernel build), hit fraction {hit_frac:.3f}")
    print(f"wrote {args.out}")
    if not np.isfinite(img).all():
        raise SystemExit("non-finite pixels")
    return 0


if __name__ == "__main__":
    sys.exit(main())
