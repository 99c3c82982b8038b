"""The game scene on the wavefront path: five volumes in two groups, the
four drones moved and yawed between frames by `SceneData.with_transforms`.

On the CPU, at a small size (64x36, the box 32^3, drones 4^3, 2 bounces, 2
glass reflections), with palettes drawn from the seed and the drones at
yaws off the axes, two of them with overlapping boxes:

- the program's frame (`Renderer.render`, the plain D1 loop and glue)
  against the benchmark's plain reference of rigid volumes
  (`port_bench/reference/rigid.py`), every share of `correct` within the
  limits of the cell `drone_scene_720p.game`;
- `with_transforms` keeps every tensor but the transforms (`is`), equals
  `Scene.data` of the moved host scene field for field, uploads nothing
  else, and records one `scene.update` span;
- D1's tables are derived once for a grid and kept across moved frames
  (`ops/cuda/dda.tables_for`, the `dda_tables` counter).
"""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from port_bench import compare
from port_bench.reference import render as ref
from port_bench.reference import rigid
from port_bench.reference.geometry import camera_corners
from port_bench.scenes import drone_scene

from voxel_tracer_tpu_torch.models.camera import Camera
from voxel_tracer_tpu_torch.models.scene import Scene
from voxel_tracer_tpu_torch.models.skydome import SkyDome
from voxel_tracer_tpu_torch.models.volume import VoxelVolume
from voxel_tracer_tpu_torch.ops.cuda import dda as dda_kernel
from voxel_tracer_tpu_torch.renderer import RenderConfig, Renderer
from voxel_tracer_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
CELL = "drone_scene_720p.game"
LIMITS = json.loads((ROOT / "port_bench" / "limits" / f"{CELL}.json").read_text())
CELL_CONFIG = json.loads((ROOT / "port_bench" / "configs" / "drone_scene_720p.json").read_text())
CONFIG = {**CELL_CONFIG, "grid": 32, "drone_grid": 4}
RENDER = {**CONFIG["render"], "width": 64, "height": 36, "max_bounces": 2,
          "glass_reflections": 2}
DRONE_IDS = (17, 25, 33, 41)


def game_scene(seed, device="cpu", config=CONFIG):
    """(raw arrays, host Scene, its SceneData on ``device``, global object
    index of each drone) of the game scene (default: at the test's size)."""
    raw = drone_scene.build(config, seed)
    scene = Scene(volumes=[VoxelVolume(v["grid"], v["palette"], pos=v["pos"], rot=v["rot"],
                                       vpu=v["vpu"]) for v in raw["volumes"]],
                  skydome=SkyDome(raw["sky"]),
                  sun_dir=np.asarray(raw["sun_dir"], np.float32),
                  sun_light=np.asarray(raw["sun_light"], np.float32))
    for light in raw["lights"]:
        scene.add_light(*light)
    drones = rigid.order([(v["grid"],) for v in raw["volumes"]])[1:]
    return raw, scene, scene.data(device), drones


def moves(raw, j, overlap=True):
    """The drones' (rot, pos) at orbit position j of 63, yawed off the axes,
    flown lower and nearer the box than the cell flies them (y 1.0, radius
    1.3), where the orbit's camera sees all four; with ``overlap`` drone 1
    sits 0.37 from drone 0 (the one ahead of the camera), their boxes
    overlapping."""
    c = np.float32(drone_scene.BOX_POS)
    near = np.float32([1.3 / drone_scene.FLIGHT_RADIUS, 0.0, 1.3 / drone_scene.FLIGHT_RADIUS])
    out = [(rot, c + (pos - c) * near + np.float32([0.0, 1.0, 0.0]))
           for rot, pos in drone_scene.transforms(raw, j, 63)]
    if overlap:
        out[1] = (drone_scene.yaw_matrix(0.9 + j), out[0][1] + np.float32([0.05, 0.05, 0.37]))
    return out


def reference_frame(raw, tr, pos, target, frame):
    vols = [(v["grid"], v["palette"], v["pos"], v["rot"], v["vpu"]) for v in raw["volumes"]]
    for k, (rot, p) in enumerate(tr):
        vols[1 + k] = vols[1 + k][:2] + (p, rot, vols[1 + k][4])
    scene = rigid.build(vols, raw["lights"], raw["sky"], raw["sun_dir"], raw["sun_light"], "cpu")
    with torch.no_grad():
        return ref.render_frame(scene, camera_corners(pos, target, 64 / 36), RENDER, frame)


@pytest.mark.parametrize("seed,j", [(2 ** 31 + 17, 0), (11, 5)])
def test_frame_matches_the_rigid_reference(seed, j):
    raw, _host, sd, drones = game_scene(seed)
    tr = moves(raw, j)
    pos, target = drone_scene.pose(raw, j, 63, 3.2, 1.2)
    out = Renderer(RenderConfig(**RENDER), device="cpu").render(
        sd.with_transforms(dict(zip(drones, tr))), Camera.create(pos, target, 64 / 36),
        frame=j)
    numbers = compare.frame_numbers(out, reference_frame(raw, tr, pos, target, j))
    assert set(LIMITS) <= set(numbers)
    assert all(numbers[k] <= LIMITS[k] for k in LIMITS), numbers
    seen = set(out["material"].unique().tolist())
    assert {DRONE_IDS[0], DRONE_IDS[1]} <= seen      # the overlapping pair, in view


def _palette_of(sd, dst, src):
    """``sd`` with object ``dst``'s palette replaced by object ``src``'s
    (global object indices in one group)."""
    base, groups = 0, list(sd.groups)
    for gi, g in enumerate(groups):
        n = g.grid.shape[0]
        if base <= dst < base + n:
            pal = g.palette.clone()
            pal[dst - base] = g.palette[src - base]
            groups[gi] = g._replace(palette=pal)
        base += n
    return sd._replace(groups=tuple(groups))


@pytest.mark.parametrize("fault", ["palette", "yaw"])
def test_one_wrong_drone_breaks_the_cells_limits(fault):
    """One drone drawn with another's palette, or turned the wrong way, and
    the rest of the frame right: some share of `correct` passes its limit."""
    raw, _host, sd, drones = game_scene(2 ** 31 + 17)
    j = 5
    tr = moves(raw, j, overlap=False)
    pos, target = drone_scene.pose(raw, j, 63, 3.2, 1.2)
    given = list(tr)
    if fault == "palette":
        sd = _palette_of(sd, drones[0], drones[2])
    else:
        given[0] = (np.ascontiguousarray(tr[0][0].T), tr[0][1])
    out = Renderer(RenderConfig(**RENDER), device="cpu").render(
        sd.with_transforms(dict(zip(drones, given))), Camera.create(pos, target, 64 / 36),
        frame=j)
    numbers = compare.frame_numbers(out, reference_frame(raw, tr, pos, target, j))
    assert any(numbers[k] > LIMITS[k] for k in LIMITS), numbers


def test_the_drones_boxes_overlap_at_yaws_off_the_axes():
    raw = drone_scene.build(CONFIG, 3)
    tr = moves(raw, 5)
    yaws = [math.atan2(rot[0, 2], rot[0, 0]) for rot, _p in tr]
    assert all(abs(math.remainder(y, math.pi / 2)) > 0.1 for y in yaws)
    # drones are 0.8 wide: centres nearer than that put their boxes' inscribed spheres in touch
    assert np.linalg.norm(tr[0][1] - tr[1][1]) < 0.8


def _moved_host(host, drones, tr, device="cpu"):
    """The host scene with the drones moved, as a game loop would move it,
    uploaded anew (`Scene.data`)."""
    order = rigid.order([(v.grid,) for v in host.volumes])
    for i, vol in enumerate(host.volumes):
        if order[i] in drones:
            rot, pos = tr[drones.index(order[i])]
            vol.set_rotation(rot)
            vol.set_position(pos)
    return host.data(device)


@pytest.mark.parametrize("which", ["all", "one", "two_apart", "box_and_one"])
def test_with_transforms_equals_the_moved_host_scene(which):
    raw, host, sd, drones = game_scene(7)
    tr = moves(raw, 9)
    box_move = (drone_scene.yaw_matrix(0.3), np.float32([0.7, 0.1, -1.6]))
    pick = {"all": [0, 1, 2, 3], "one": [2], "two_apart": [0, 3], "box_and_one": [1]}[which]
    given = {drones[k]: tr[k] for k in pick}
    box = ({0, 1, 2, 3, 4} - set(drones)).pop()
    if which == "box_and_one":
        given[box] = box_move
        host.volumes[0].set_rotation(box_move[0])       # the box, volume 0 of the host scene
        host.volumes[0].set_position(box_move[1])
    moved = sd.with_transforms(given)
    want = _moved_host(host, drones, [tr[k] if k in pick else
                                      (raw["volumes"][1 + k]["rot"], raw["volumes"][1 + k]["pos"])
                                      for k in range(4)])
    got, exp = dict(_fields(moved)), dict(_fields(want))
    assert list(got) == list(exp)
    for name in got:
        assert got[name].dtype == exp[name].dtype and torch.equal(got[name], exp[name]), name


def _fields(x, name="scene"):
    """(path, tensor) of every tensor of a SceneData, field for field."""
    if isinstance(x, torch.Tensor):
        yield name, x
    else:
        for i, field in enumerate(x):
            yield from _fields(field, f"{name}.{getattr(x, '_fields', range(len(x)))[i]}")


def test_with_transforms_keeps_every_other_tensor():
    raw, _host, sd, drones = game_scene(7)
    moved = sd.with_transforms(dict(zip(drones, moves(raw, 3))))
    for g, h in zip(sd.groups, moved.groups):
        for name in ("grid", "brick_occ", "palette", "pivot", "vpu"):
            assert getattr(g, name) is getattr(h, name), name
    drone_group = next(i for i, g in enumerate(sd.groups) if g.grid.shape[0] == 4)
    assert moved.groups[drone_group].rot is not sd.groups[drone_group].rot
    box = 1 - drone_group
    assert moved.groups[box] is sd.groups[box]          # nothing of the box moved
    for name in ("sun_dir", "sun_light", "lights", "sky", "prims"):
        assert getattr(moved, name) is getattr(sd, name), name
    assert moved.groups[drone_group].rot.is_contiguous()
    assert moved.groups[drone_group].pos.is_contiguous()
    assert sd.with_transforms({}) is sd


@pytest.mark.parametrize("obj", [5, -1, 7])
def test_with_transforms_refuses_objects_outside_the_scene(obj):
    _raw, _host, sd, _drones = game_scene(7)
    with pytest.raises(ValueError):
        sd.with_transforms({0: (np.eye(3), np.zeros(3)), obj: (np.eye(3), np.zeros(3))})


def test_with_transforms_is_one_span():
    raw, _host, sd, drones = game_scene(7)
    given = dict(zip(drones, moves(raw, 3)))
    profiling.take_spans()
    sd.with_transforms(given)
    assert profiling.take_spans() == []
    with profiling.recording():
        sd.with_transforms(given)
    spans = profiling.take_spans()
    assert [s["name"] for s in spans] == ["scene.update"]
    assert spans[0]["attrs"] == {"objects": 4} and spans[0]["end_ns"] >= spans[0]["start_ns"]


def test_d1_tables_are_kept_across_moved_frames():
    """D1 derives its tables for a grid once (`tables_for`, as it does for
    every call on the card) and keeps them while the drones move; a scene
    uploaded anew each frame derives them again."""
    raw, host, sd, drones = game_scene(21)
    renderer = Renderer(RenderConfig(**{**RENDER, "shading": "flat"}), device="cpu")

    def frame(scene, j):
        pos, target = drone_scene.pose(raw, j, 63, 3.2, 1.2)
        renderer.render(scene, Camera.create(pos, target, 64 / 36), frame=j)
        for g in scene.groups:
            dda_kernel.tables_for(g.grid, g.brick_occ)
            dda_kernel.tables_for(g.grid[0], g.brick_occ[0])

    frame(sd, 0)
    before = dda_kernel.KERNEL_LAUNCHES["dda_tables"]
    for j in (1, 2, 3):
        frame(sd.with_transforms(dict(zip(drones, moves(raw, j)))), j)
    assert dda_kernel.KERNEL_LAUNCHES["dda_tables"] == before
    frame(_moved_host(host, drones, moves(raw, 4)), 4)
    assert dda_kernel.KERNEL_LAUNCHES["dda_tables"] == before + 2 * len(sd.groups)
