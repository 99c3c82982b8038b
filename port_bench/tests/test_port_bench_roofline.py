"""The roofline counters against counts worked by hand on tiny scenes."""

import numpy as np
import pytest
import torch

from port_bench import roofline
from port_bench.reference.render import Hit, RefScene, intersect


def _scene(grid, vpu):
    return RefScene.build([(grid, np.ones((256, 3), np.float32), (0.0, 0.0, 0.0), vpu)], [],
                          np.zeros((1, 1, 3), np.float32), (0.0, 1.0, 0.0), (1.0, 1.0, 1.0), "cpu")


def test_dda_counts_one_ray():
    """16^3 at vpu 1, centred on the origin, one solid voxel at x = 12 of
    brick (1, 0, 0); a ray along +x through its row walks one brick step
    (the empty brick 0) and four voxel steps (8 -> 12): 5 steps."""
    grid = np.zeros((16, 16, 16), np.uint8)
    grid[4, 4, 12] = 40
    scene = _scene(grid, 1.0)
    o = torch.tensor([[-9.0, -3.5, -3.5]])       # local (-1, 4.5, 4.5)
    d = torch.tensor([[1.0, 0.0, 0.0]])
    hit = intersect(scene, o, d, 4, 256)
    assert isinstance(hit, Hit) and int(hit.mat[0]) == 40 and float(hit.t[0]) == 13.0
    (call,) = scene.calls
    assert (call["rays"], call["steps"], call["modes"], call["per_ray_vpu"]) == (1, 5, [], False)
    assert call["table_bytes"] == 16 ** 3 * 4 + 2 ** 3 * 4
    nbytes, ops = roofline.dda_call(**call)
    assert (nbytes, ops) == (24 + 42 + 32 * 5, 80 + 8 * 5)
    assert roofline.dda_least_ms([call]) == pytest.approx(226 / 3.35e12 * 1e3)


def test_dda_mode_bytes_and_table_cap():
    nbytes, _ = roofline.dda_call(10, 10 ** 6, ["medium", "oid"], True, 1000)
    assert nbytes == 10 * (24 + 42 + 4 + 8 + 4) + 1000
    nbytes, _ = roofline.dda_call(1, 0, ["shadow", "shadow_seed"], False, 1000)
    assert nbytes == 24 + 42 + 8


def test_least_ms_takes_the_larger_bound():
    assert roofline.least_ms(3.35e9, 0) == pytest.approx(1.0)
    assert roofline.least_ms(0, 67e9) == pytest.approx(1.0)
    assert roofline.least_ms(3.35e9, 134e9) == pytest.approx(2.0)
