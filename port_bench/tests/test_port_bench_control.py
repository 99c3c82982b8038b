"""`correct` comes out false where it should: the bfloat16 control in the
program's place, and faults planted in the program under a whole run
(the look for a chip skipped, the rest of the run driven on the CPU)."""

import pytest
import torch

from port_bench import control, harness
from port_bench.tests.conftest import SMALL

SEED = 2 ** 31 + 29


def _limits(cell):
    return harness.cell_files(harness.benchmark(), cell)[3]


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_control_fails(cell):
    readings, _notes = control.control_numbers(cell, SEED, "cpu", SMALL[cell])
    limits = _limits(cell)
    for name, numbers in readings.items():
        assert any(numbers[k] > limits[k] for k in limits), (name, numbers)


def _run(cell):
    result, _ = harness.run_cell(cell, SEED, 0.1, False, "cpu", overrides=SMALL[cell])
    return result


@pytest.mark.parametrize("cell", ["glass_box_720p.whitted_orbit", "glass_box_720p.flat_orbit"])
def test_frame_altered_where_produced(cell, monkeypatch):
    """The renderer's image altered by two 8-bit steps where it is made."""
    import voxel_tracer_tpu_torch.renderer as renderer
    real = renderer.render_rays

    def altered(*args, **kw):
        out = real(*args, **kw)
        out["image"] = (out["image"] + 2.0 / 255.0).clamp(max=1.0)
        return out

    monkeypatch.setattr(renderer, "render_rays", altered)
    assert not _run(cell)["correct"]


@pytest.mark.parametrize("cell", ["glass_box_720p.whitted_orbit", "glass_box_720p.flat_orbit"])
def test_half_frame_left_out(cell, monkeypatch):
    """Half of each frame's rays left out: the lower half of every output
    is never rendered (left at zero)."""
    import voxel_tracer_tpu_torch.renderer as renderer
    real = renderer.render_rays

    def half(*args, **kw):
        out = real(*args, **kw)
        for v in out.values():
            v[v.shape[0] // 2:] = 0
        return out

    monkeypatch.setattr(renderer, "render_rays", half)
    assert not _run(cell)["correct"]


@pytest.mark.parametrize("cell", ["glass_box_720p.whitted_orbit", "glass_box_720p.flat_orbit"])
def test_traversal_altered_where_produced(cell, monkeypatch):
    """Every hit's distance from the traversal made 0.1 % longer."""
    from voxel_tracer_tpu_torch.ops import composite
    real = composite.intersect_scene

    def longer(*args, **kw):
        hit = real(*args, **kw)
        return hit._replace(t=torch.where(hit.t < 1e29, hit.t * 1.001, hit.t))

    monkeypatch.setattr(composite, "intersect_scene", longer)
    result = _run(cell)
    assert not result["correct"] and result["compared"]["depth_share"]["value"] > 0.01
