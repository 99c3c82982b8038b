"""Shared sizes of the benchmark's CPU tests, and the card fixture."""

import pytest
import torch

# every cell's configuration and mix cut down so that a run takes seconds
# on the CPU, through the port's plain paths
RENDER = {"config": {"grid": 32, "render": {
    "width": 48, "height": 32, "shading": "full", "max_steps": 256, "max_candidates": 4,
    "max_bounces": 3, "glass_reflections": 2, "tonemapper": "aces", "ambient": 0.2,
    "accumulate": False, "compact": False}},
    "mix": {"orbit_positions": 4, "check_frames": 2, "check_laps": 1, "warmup_frames": 1,
            "trace_positions": 2, "trace_repeats": 1}}
SMALL = {"glass_box_720p.whitted_orbit": RENDER, "glass_box_720p.flat_orbit": RENDER}


@pytest.fixture
def card():
    """Skip unless a CUDA device is present (decided when the test runs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
