"""Run-time configuration system.

Counterpart of `voxel_tracer_tpu/config.py`, over this package's
`RenderConfig`.

The reference configures everything with compile-time defines
(template/common.h:6-30: window size, VOXEL scale, USE_BVH, PROFILING,
PACKET_TRACE, ...).  Here the same knobs are a dataclass hierarchy with
dict/env/CLI overrides — per-run, no rebuilds.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Any, Optional

from voxel_tracer_tpu_torch.renderer import RenderConfig


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Top-level framework configuration."""

    render: RenderConfig = dataclasses.field(default_factory=RenderConfig)
    use_kernel: bool = True           # CUDA kernels vs the wavefront path
    kernel_tile_rows: int = 8
    profiling: bool = False           # deterministic profiling scene (dev/profile.h)
    seed: int = 0
    checkpoint_dir: Optional[str] = None


def _apply_overrides(obj, overrides: dict):
    kw: dict[str, Any] = {}
    for f in dataclasses.fields(obj):
        if f.name in overrides:
            v = overrides[f.name]
            if dataclasses.is_dataclass(getattr(obj, f.name)) and isinstance(v, dict):
                kw[f.name] = _apply_overrides(getattr(obj, f.name), v)
            else:
                kw[f.name] = v
    return dataclasses.replace(obj, **kw)


def load_config(path: Optional[str] = None, overrides: Optional[dict] = None,
                env_prefix: str = "VXT_") -> EngineConfig:
    """Config resolution order: defaults < json file < env < overrides.

    Env vars: VXT_WIDTH=1920 VXT_SHADING=full VXT_USE_KERNEL=0 ...
    """
    cfg = EngineConfig()
    if path and os.path.exists(path):
        with open(path) as f:
            cfg = _apply_overrides(cfg, json.load(f))

    env: dict[str, Any] = {}
    render_fields = {f.name for f in dataclasses.fields(RenderConfig)}
    for key, val in os.environ.items():
        if not key.startswith(env_prefix):
            continue
        name = key[len(env_prefix):].lower()
        parsed: Any = val
        if val.lower() in ("true", "false"):
            parsed = val.lower() == "true"
        elif val.lstrip("-").isdigit():
            parsed = int(val)
        else:
            try:
                parsed = float(val)
            except ValueError:
                pass
        if name in render_fields:
            env.setdefault("render", {})[name] = parsed
        else:
            env[name] = parsed
    cfg = _apply_overrides(cfg, env)

    if overrides:
        cfg = _apply_overrides(cfg, overrides)
    return cfg


def add_config_args(parser: argparse.ArgumentParser):
    parser.add_argument("--config", default=None, help="JSON config file")
    parser.add_argument("--size", default=None, help="WxH render size")
    parser.add_argument("--shading", default=None,
                        choices=["flat", "lambert", "full"])
    parser.add_argument("--no-kernel", action="store_true",
                        help="use the wavefront path instead of the CUDA kernels")


def config_from_args(args) -> EngineConfig:
    overrides: dict[str, Any] = {"render": {}}
    if args.size:
        w, h = (int(v) for v in args.size.split("x"))
        overrides["render"]["width"] = w
        overrides["render"]["height"] = h
    if args.shading:
        overrides["render"]["shading"] = args.shading
    if getattr(args, "no_kernel", False):
        overrides["use_kernel"] = False
    return load_config(args.config, overrides)
