"""Temporal reprojection + accumulation (renderer.cpp:273-329 analog).

Counterpart of `voxel_tracer_tpu/ops/reproject.py`: a function of
(current irradiance and depth, previous accumulator, previous view
pyramid) -> (blended irradiance, new accumulator); the caller carries the
accumulator (the reference's ping-pong buffers, renderer.cpp:240-244).

Per pixel: project the hit point into the previous frame's pyramid UV,
4-tap bilinear fetch of the previous irradiance, depth rejection with
camera forward-motion compensation, then a 95 % history blend.
"""

from __future__ import annotations

import torch

from voxel_tracer_tpu_torch.models.camera import pyramid_project


def reproject_accumulate(
    irradiance,      # (N, 3) current-frame irradiance
    depth,           # (N,) current hit depth
    hit_points,      # (N, 3) world hit positions (origin + dir * depth)
    prev_accu,       # (H, W, 4) previous accumulator (rgb irradiance + depth)
    prev_planes,     # (4, 4) previous frame pyramid planes
    width: int,
    height: int,
    depth_delta=0.0,  # camera forward motion since last frame
    reproject_mask=None,  # (N,) bool: False = sky / no-reproject pixels
    confidence: float = 0.95,
):
    """Returns (blended (N, 3), new_accu (H, W, 4))."""
    dev = irradiance.device
    uv = pyramid_project(prev_planes, hit_points)         # (N, 2) in [0, 1]

    max_u = 1.0 - 2.0 / width
    max_v = 1.0 - 2.0 / height
    in_bounds = ((uv[:, 0] > 0.0) & (uv[:, 0] < max_u)
                 & (uv[:, 1] > 0.0) & (uv[:, 1] < max_v))

    win = torch.tensor([width, height], dtype=torch.float32, device=dev)
    base = uv * win                                       # top-left sample pos
    center = base + 0.5
    center_p = torch.floor(center + 0.5)

    # sample weights (renderer.cpp:298-305): fractional-area bilinear
    tl = base
    tr = base + torch.tensor([1.0, 0.0], device=dev)
    bl = base + torch.tensor([0.0, 1.0], device=dev)
    w_tl = torch.abs((tl[:, 0] - center_p[:, 0]) * (tl[:, 1] - center_p[:, 1]))
    w_tr = torch.abs((tr[:, 0] - center_p[:, 0]) * (tr[:, 1] - center_p[:, 1]))
    w_bl = torch.abs((bl[:, 0] - center_p[:, 0]) * (bl[:, 1] - center_p[:, 1]))
    w_br = 1.0 - (w_tl + w_tr + w_bl)

    flat = prev_accu.reshape(-1, 4)

    def fetch(px, py):
        # float -> int truncates toward zero, as astype(int32) does
        xi = torch.clamp(px.to(torch.int64), 0, width - 1)
        yi = torch.clamp(py.to(torch.int64), 0, height - 1)
        return flat[yi * width + xi]

    s_tl = fetch(tl[:, 0], tl[:, 1])
    s_tr = fetch(tr[:, 0], tr[:, 1])
    s_bl = fetch(bl[:, 0], bl[:, 1])
    s_br = fetch(tr[:, 0], bl[:, 1])
    rgb_prev = (s_tl[:, :3] * w_tl[:, None] + s_tr[:, :3] * w_tr[:, None]
                + s_bl[:, :3] * w_bl[:, None] + s_br[:, :3] * w_br[:, None])
    # center-pixel depth (renderer.cpp:313-315)
    depth_prev = fetch(center[:, 0], center[:, 1])[:, 3]

    # depth rejection with forward-motion compensation (renderer.cpp:317-323)
    depth_diff = torch.abs(depth_prev - (depth + depth_delta))
    accept = in_bounds & (depth_diff < 0.1)
    conf = torch.where(accept, torch.clamp(confidence - depth_diff * 3.0, min=0.0),
                       0.0)
    acc_color = torch.where(accept[:, None], rgb_prev, irradiance)

    blended = irradiance * (1.0 - conf[:, None]) + acc_color * conf[:, None]
    if reproject_mask is not None:
        blended = torch.where(reproject_mask[:, None], blended, irradiance)

    new_accu = torch.cat([blended, depth[:, None]], dim=-1)
    return blended, new_accu.reshape(height, width, 4)
