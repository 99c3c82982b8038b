"""Inverse rendering (BASELINE.json config 5, scaled-down CLI demo) on the
PyTorch / CUDA port.

Counterpart of `examples/inverse_render.py`: optimizes a density + albedo
grid from posed renderings of a synthetic target volume, reports the
held-out view's PSNR and writes target | reconstruction side by side as a
PNG.  Runs on the card unless `--device cpu` is given; `--backend kernel`
trains on the integrate kernels (views in 32x32-pixel tile order, so
`--size` must be a multiple of 32 and `--grid` of 8).

Usage:
    python -m voxel_tracer_tpu_torch.examples.inverse_render [--grid 32]
        [--views 16] [--steps 150] [--size 64] [--rays 4096] [--lr 0.2]
        [--out recon.png] [--ckpt DIR] [--backend wavefront|kernel]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import struct
import sys
import time
import zlib

import numpy as np
import torch

from voxel_tracer_tpu_torch.models.camera import Camera, rays_for_image
from voxel_tracer_tpu_torch.ops.cuda import diff as diff_kernel
from voxel_tracer_tpu_torch.ops.cuda import diffint
from voxel_tracer_tpu_torch.trainer import BACKENDS, TrainConfig, Trainer


def target_field(grid_n):
    """The synthetic coloured ball: (sigma (Z, Y, X), albedo (Z, Y, X, 3))."""
    z, y, x = np.meshgrid(*[np.arange(grid_n)] * 3, indexing="ij")
    c = (grid_n - 1) / 2
    r = np.sqrt((x - c) ** 2 + (y - c) ** 2 + (z - c) ** 2)
    sigma = np.where(r < grid_n * 0.35, 8.0, 0.0).astype(np.float32)
    albedo = np.zeros((grid_n,) * 3 + (3,), np.float32)
    albedo[..., 0] = x / grid_n
    albedo[..., 1] = y / grid_n
    albedo[..., 2] = 1.0 - x / grid_n
    return sigma, albedo


def make_target_views(grid_n, n_views, img_size, vpu, device):
    """Render ground-truth views of the target volume; returns a list of
    (origins, dirs, colors) numpy arrays in raster order, and the field."""
    sigma, albedo = target_field(grid_n)
    sigma_t = torch.from_numpy(sigma).to(device)
    albedo_t = torch.from_numpy(albedo).to(device)
    pivot = torch.full((3,), grid_n / (2 * vpu), device=device)
    views = []
    for vi in range(n_views):
        ang = 2 * np.pi * vi / n_views
        el = 0.35 * np.sin(ang * 2 + 1.0)
        pos = 1.6 * np.array([np.cos(ang) * np.cos(el), np.sin(el),
                              np.sin(ang) * np.cos(el)])
        cam = Camera.create(pos, (0, 0, 0), 1.0)
        o, d = rays_for_image(cam, img_size, img_size, device=device)
        out = diff_kernel.render_density(sigma_t, albedo_t, o + pivot, d, vpu, 128)
        views.append(((o + pivot).cpu().numpy(), d.cpu().numpy(),
                      out["color"].cpu().numpy()))
    return views, (sigma_t, albedo_t)


def write_png(path: str, img: np.ndarray):
    """Minimal 8-bit RGB PNG writer; img (H, W, 3) floats in [0, 1]."""
    arr = np.clip(np.asarray(img) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    h, w = arr.shape[:2]
    raw = b"".join(b"\x00" + arr[y].tobytes() for y in range(h))

    def chunk(tag, payload):
        c = tag + payload
        return (struct.pack(">I", len(payload)) + c
                + struct.pack(">I", zlib.crc32(c) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--grid", type=int, default=32)
    ap.add_argument("--views", type=int, default=16)
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--rays", type=int, default=4096)
    ap.add_argument("--lr", type=float, default=0.2)
    ap.add_argument("--out", default="recon.png")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--backend", choices=BACKENDS, default="wavefront")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    vpu = float(args.grid)  # unit cube
    print(f"rendering {args.views} target views of a {args.grid}^3 volume...")
    views, (gt_sigma, gt_albedo) = make_target_views(
        args.grid, args.views, args.size, vpu, args.device)
    if args.backend == "kernel":
        views = [tuple(diffint.tile_raster(a, args.size, args.size) for a in v)
                 for v in views]
    origins, dirs, targets = (np.concatenate([v[i] for v in views])
                              for i in range(3))

    cfg = TrainConfig(grid_size=(args.grid,) * 3, vpu=vpu, lr=args.lr,
                      steps=args.steps, rays_per_batch=args.rays,
                      march_steps=3 * args.grid, checkpoint_dir=args.ckpt,
                      backend=args.backend)
    trainer = Trainer(cfg, device=args.device)
    if trainer.maybe_restore():
        print(f"resumed from step {trainer.step}")

    t0 = time.perf_counter()
    trainer.fit(origins, dirs, targets, log_every=max(args.steps // 10, 1))
    print(f"trained {trainer.step} steps in {time.perf_counter() - t0:.1f}s "
          f"on {trainer.device} ({args.backend} backend)")

    # held-out view PSNR
    cam = Camera.create((1.35, 0.55, 0.9), (0, 0, 0), 1.0)
    o, d = rays_for_image(cam, args.size, args.size, device=args.device)
    pivot = torch.full((3,), args.grid / (2 * vpu), device=args.device)
    with torch.no_grad():
        out = diff_kernel.render_density(gt_sigma, gt_albedo, o + pivot, d, vpu,
                                         cfg.march_steps)
    gt_img = out["color"].cpu().numpy().reshape(args.size, args.size, 3)
    recon = trainer.render(cam, args.size, args.size)
    mse = float(np.mean((recon - gt_img) ** 2))
    psnr = -10 * np.log10(max(mse, 1e-10))
    print(f"held-out view PSNR: {psnr:.2f} dB")

    write_png(args.out, np.clip(np.concatenate([gt_img, recon], axis=1), 0, 1))
    print(f"wrote {args.out} (left: target, right: reconstruction)")
    return 0 if psnr > 20 else 1


if __name__ == "__main__":
    sys.exit(main())
