"""The wavefront composite's glue on the CPU (`ops/composite.py`).

The glue around each D1 call (`_local_rays`, `_record`) is the plain
version of the two kernels of `ops/cuda/composite.py`, which
tests/test_torch_composite_cuda.py holds against it on the card.  Here:

- every traversal site on the glue (`intersect_scene` primary, scan and
  shadow, `is_occluded`, `march_interior`, `intersect_group`) equals, bit
  for bit, the composition it replaced (`_parent_*` below: the miss record
  merged with each group's record, `_trace_one`, the candidate slots), on one volume,
  a stacked group of three beside a single volume in either order, and
  analytic primitives, with rays that miss and directions with zero and
  NaN components;
- the dispatch: CPU tensors and `composite.PLAIN` take the glue, and
  `KERNEL_LAUNCHES` counts each traversal call as `composite_glue`; the
  top-K prepass takes `kernels.topk` on every fused traversal, else the
  plain `_topk`, and says which in its `topk` span's ``fused``;
- the kernels' host side: its argument structures mirror
  csrc/composite.cu field for field, and it refuses CPU tensors, naming
  the plain version, and a K outside the prepass's 1..`TOPK_MAX`.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from voxel_tracer_tpu_torch.models.scene import Scene
from voxel_tracer_tpu_torch.models.volume import VolumeData, VoxelVolume
from voxel_tracer_tpu_torch.ops import composite, dda
from voxel_tracer_tpu_torch.ops.cuda import composite as kernels
from voxel_tracer_tpu_torch.ops.math3d import BIG_F32

N = 1500
GLASS, MIRROR = 3, 5


def _shell(shape, wall, core):
    """A shell of id ``wall`` two voxels thick around a solid core."""
    g = np.zeros(shape, np.uint8)
    g[1:-1, 1:-1, 1:-1] = wall
    g[3:-3, 3:-3, 3:-3] = 0
    z, y, x = (s // 2 for s in shape)
    g[z - 2:z + 2, 3:y + 3, x - 2:x + 2] = core
    return g


def _rot(axis, angle):
    axis = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return (np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * k @ k).astype(np.float32)


SCENES = ("one", "stacked_first", "single_first", "prims")


def scene_data(kind, device="cpu"):
    """A scene of ``kind`` (SCENES) on ``device``."""
    rng = np.random.RandomState(5)
    pal = (rng.rand(256, 3) * 0.8 + 0.1).astype(np.float32)
    cube = [VoxelVolume(_shell((16, 16, 16), GLASS, 40), pal, pos=(0.0, 0.0, 0.0),
                        rot=_rot((1, 2, 3), 0.7)),
            VoxelVolume(_shell((16, 16, 16), GLASS, 41), pal, pos=(0.5, 0.1, 0.3),
                        rot=_rot((0, 1, 0), 0.6435)),
            VoxelVolume(_shell((16, 16, 16), MIRROR, 42), pal, pos=(1.0, -0.1, 0.0))]
    if kind == "one":
        vols = cube[:1]
    elif kind == "single_first":       # groups sort by grid shape: (12, 12, 12) first
        vols = [VoxelVolume(_shell((12, 12, 12), MIRROR, 60), pal, pos=(0.4, -0.5, 0.9),
                            rot=_rot((3, -1, 2), 1.1))] + cube
    else:
        vols = cube + [VoxelVolume(_shell((20, 12, 28), GLASS, 60), pal, pos=(0.4, -0.5, 0.9),
                                   rot=_rot((3, -1, 2), 1.1))]
    sc = Scene(volumes=vols)
    if kind == "prims":
        sc.add_sphere((0.3, 0.5, -0.3), 0.12, mat=20, albedo=(0.2, 0.7, 0.3))
        sc.add_capsule((-0.3, -0.2, 0.0), (0.2, 0.4, 0.1), 0.04)
    return sc.data(device)


def rays(seed, n=N, device="cpu"):
    """Rays from a box around the scene toward points inside it; some miss,
    every 7th has a zero x component, every 11th zero y and z, every 13th
    a NaN component."""
    rng = np.random.RandomState(seed)
    o = rng.uniform(-1.5, 2.2, (n, 3)).astype(np.float32)
    d = rng.uniform(-0.4, 1.3, (n, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[::7, 0] = 0.0
    d[::11, 1:] = 0.0
    d[::13, rng.randint(0, 3)] = np.nan
    return (torch.from_numpy(o).to(device), torch.from_numpy(d.astype(np.float32)).to(device))


def site_args(site, sd, seed, n=N, device="cpu"):
    """(function, positional args, keyword args) of one traversal site."""
    o, d = rays(seed, n, device)
    rng = np.random.RandomState(seed + 100)

    def ints(values):
        return torch.from_numpy(rng.choice(values, n)).to(device)
    seeds = ints(np.array([0, 7, 2 ** 31 + 5, 2 ** 32 - 1], np.int64))
    if site == "primary":
        return composite.intersect_scene, (sd, o, d), {"max_candidates": 2}
    if site == "scan":
        return composite.intersect_scene, (sd, o, d), {
            "ignore": ints(np.array([0, GLASS, MIRROR], np.int32))}
    if site == "shadow":
        return composite.intersect_scene, (sd, o, d), {"shadow_seed": seeds, "shadow": True}
    if site == "occluded":
        return composite.is_occluded, (sd, o, d, 1.5), {"shadow_seed": seeds}
    if site == "group":
        return composite.intersect_group, (sd.groups[0], o, d), {"max_candidates": 2,
                                                                 "obj_base": 1}
    count = sum(g.grid.shape[0] for g in sd.groups)
    obj = ints(np.arange(-2, count + 1, dtype=np.int32))
    return composite.march_interior, (sd, obj, o * 0.2, d,
                                      ints(np.array([0, GLASS, MIRROR], np.int32))), {}


SITES = ("primary", "scan", "shadow", "occluded", "interior", "group")


# ---------------------------------------------------------------------------
# The composition the glue replaced (ops/composite.py before the kernels)
# ---------------------------------------------------------------------------

def _parent_trace_one(group, oid_static, origins, dirs, max_steps, obj_base=0, *, dda_fn,
                      **dda_kw):
    rot = group.rot[oid_static]
    o_l, d_l = composite._to_local(rot, group.pos[oid_static], group.pivot[oid_static],
                                   origins, dirs)
    res = dda_fn(group.grid[oid_static], group.brick_occ[oid_static], o_l, d_l,
                 group.vpu[oid_static], max_steps=max_steps, **dda_kw)
    hit = res["t"] < BIG_F32
    normal = dda.normal_from_axis(res["axis"], res["step_sign"], rot)
    albedo = group.palette[oid_static][torch.clamp(res["mat"], 0, 255).long()]
    return composite.HitResult(
        t=res["t"], mat=torch.where(hit, res["mat"], 0),
        normal=torch.where(hit[:, None], normal, 0.0),
        albedo=torch.where(hit[:, None], albedo, 0.0), steps=res["steps"],
        obj=torch.where(hit, obj_base + oid_static, -1).to(torch.int32))


def _parent_intersect_group(group, origins, dirs, max_candidates, max_steps, obj_base, *,
                            dda_fn, **dda_kw):
    n = origins.shape[0]
    o_count = group.grid.shape[0]
    if o_count == 1:
        return _parent_trace_one(group, 0, origins, dirs, max_steps, obj_base,
                                 dda_fn=dda_fn, **dda_kw)
    k = min(max_candidates, o_count)
    cand_t, cand_id = composite._topk(group, origins, dirs, k)
    best = composite.HitResult.miss(n, origins.device)
    pal_flat = group.palette.reshape(-1, 3)
    for slot in range(k):
        oid = cand_id[:, slot].long()
        live = cand_t[:, slot] < BIG_F32
        live = live & (cand_t[:, slot] < best.t)
        rot, pos, pivot, vpu = group.rot[oid], group.pos[oid], group.pivot[oid], group.vpu[oid]
        o_l, d_l = composite._to_local(rot, pos, pivot, origins, dirs)
        res = dda_fn(group.grid, group.brick_occ, o_l, d_l, vpu, oid=oid,
                     max_steps=max_steps, **dda_kw)
        hit = live & (res["t"] < BIG_F32)
        normal = dda.normal_from_axis(res["axis"], res["step_sign"], rot)
        albedo = pal_flat[oid * 256 + torch.clamp(res["mat"], 0, 255).long()]
        best = best.nearer(composite.HitResult(
            t=torch.where(hit, res["t"], BIG_F32), mat=torch.where(hit, res["mat"], 0),
            normal=torch.where(hit[:, None], normal, 0.0),
            albedo=torch.where(hit[:, None], albedo, 0.0),
            steps=torch.where(live, res["steps"], 0),
            obj=torch.where(hit, obj_base + oid.to(torch.int32), -1).to(torch.int32)))
    return best


def _parent_intersect_scene(scene, origins, dirs, max_candidates=4, max_steps=dda.MAX_STEPS,
                            ignore=None, shadow_seed=None, shadow=False, *, dda_fn):
    from voxel_tracer_tpu_torch.ops.prims import intersect_prims

    dda_kw = composite._dda_kw(ignore, shadow_seed, shadow)
    best = composite.HitResult.miss(origins.shape[0], origins.device)
    obj_base = 0
    for group in scene.groups:
        best = best.nearer(_parent_intersect_group(group, origins, dirs, max_candidates,
                                                   max_steps, obj_base, dda_fn=dda_fn,
                                                   **dda_kw))
        obj_base += group.grid.shape[0]
    prim = intersect_prims(scene.prims, origins, dirs)
    if prim is not None:
        t, mat, normal, albedo = prim
        best = best.nearer(composite.HitResult(
            t=t, mat=mat, normal=normal, albedo=albedo, steps=torch.zeros_like(mat),
            obj=torch.where(t < BIG_F32, -2, -1).to(torch.int32)))
    return best


def _parent_is_occluded(scene, origins, dirs, tmax, max_candidates=4,
                        max_steps=dda.MAX_STEPS, shadow_seed=None, *, dda_fn):
    hit = _parent_intersect_scene(scene, origins, dirs, max_candidates, max_steps, None,
                                  shadow_seed, shadow_seed is not None, dda_fn=dda_fn)
    return hit.t < tmax, hit


def _parent_march_interior(scene, obj, origins, dirs, medium, max_steps=dda.MAX_STEPS, *,
                           dda_fn):
    out = composite.HitResult.miss(origins.shape[0], origins.device)
    obj_base = 0
    for group in scene.groups:
        o_count = group.grid.shape[0]
        oid = torch.clamp(obj - obj_base, 0, o_count - 1).long()
        in_group = (obj >= obj_base) & (obj < obj_base + o_count)
        rot, pos, pivot, vpu = group.rot[oid], group.pos[oid], group.pivot[oid], group.vpu[oid]
        o_l, d_l = composite._to_local(rot, pos, pivot, origins, dirs)
        res = dda_fn(group.grid, group.brick_occ, o_l, d_l, vpu,
                     oid=oid if o_count > 1 else None, max_steps=max_steps, medium=medium)
        normal = dda.normal_from_axis(res["axis"], res["step_sign"], rot)
        albedo = group.palette.reshape(-1, 3)[oid * 256 + torch.clamp(res["mat"], 0, 255).long()]
        sel = in_group
        out = composite.HitResult(
            t=torch.where(sel, res["t"], out.t), mat=torch.where(sel, res["mat"], out.mat),
            normal=torch.where(sel[:, None], normal, out.normal),
            albedo=torch.where(sel[:, None], albedo, out.albedo),
            steps=torch.where(sel, res["steps"], out.steps),
            obj=torch.where(sel, obj.to(torch.int32), out.obj))
        obj_base += o_count
    return out


def _parent_first_group(group, origins, dirs, max_candidates=4, max_steps=dda.MAX_STEPS,
                        obj_base=0, *, dda_fn, **dda_kw):
    """`_parent_intersect_group` as a scene's first group took it: merged
    into the miss record."""
    return composite.HitResult.miss(origins.shape[0], origins.device).nearer(
        _parent_intersect_group(group, origins, dirs, max_candidates, max_steps, obj_base,
                                dda_fn=dda_fn, **dda_kw))


PARENT = {composite.intersect_scene: _parent_intersect_scene,
          composite.intersect_group: _parent_first_group,
          composite.is_occluded: _parent_is_occluded,
          composite.march_interior: _parent_march_interior}


def assert_same(a, b, what=""):
    """Two results (HitResult, tensor or tuple of them) equal bit for bit."""
    if isinstance(a, tuple):
        assert type(a) is type(b) and len(a) == len(b)
        names = getattr(a, "_fields", range(len(a)))
        for name, x, y in zip(names, a, b):
            assert_same(x, y, f"{what}.{name}")
        return
    assert a.dtype == b.dtype and a.shape == b.shape, what
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    assert torch.equal(a, b), f"{what}: {(a != b).sum().item()} entries differ"


@pytest.fixture(scope="module", params=SCENES)
def scene(request):
    return request.param, scene_data(request.param)


@pytest.mark.parametrize("site", SITES)
def test_glue_equals_the_composition_it_replaced(scene, site):
    kind, sd = scene
    fn, args, kw = site_args(site, sd, seed=SCENES.index(kind) * 10 + SITES.index(site))
    out = fn(*args, **kw)
    ref = PARENT[fn](*args, **kw, dda_fn=dda.intersect_volume_local)
    assert_same(out, ref, site)
    hit = (out[1] if site == "occluded" else out).t < BIG_F32
    assert 0 < hit.sum() < N        # the rays both hit and miss


@pytest.mark.parametrize("site", SITES)
@pytest.mark.parametrize("plain", [False, True], ids=["default", "PLAIN"])
def test_cpu_and_plain_traversals_take_the_glue(site, plain, monkeypatch):
    sd = scene_data("stacked_first")
    fn, args, kw = site_args(site, sd, seed=1, n=64)
    if plain:
        fn = getattr(composite.PLAIN, fn.__name__)
    for stage in ("to_local", "record", "topk"):
        monkeypatch.setattr(kernels, stage, _refused)
    kernels.reset_launch_counts()
    fn(*args, **kw)
    assert kernels.KERNEL_LAUNCHES == {"composite_fused": 0, "composite_glue": 1,
                                       "composite_local": 0, "composite_record": 0,
                                       "composite_topk": 0}


def _refused(*_a, **_k):
    raise AssertionError("a CPU traversal reached the kernels")


def test_stages_choose_kernels_or_glue():
    assert composite._stages(True) == (kernels.to_local, kernels.record)
    assert composite._stages(False) == (composite._local_rays, composite._record)


def _struct_fields(name):
    src = (Path(composite.__file__).resolve().parents[1] / "csrc" / "composite.cu").read_text()
    body = re.search(r"struct %s \{(.*?)\n\};" % name, src, re.S).group(1)
    return [m.group(1) for m in re.finditer(r"^\s*(?:const\s+)?\w+\s*\*?\s*(\w+);", body, re.M)]


@pytest.mark.parametrize("struct,args", [("LocalArgs", kernels._LocalArgs),
                                         ("RecordArgs", kernels._RecordArgs),
                                         ("TopkArgs", kernels._TopkArgs)])
def test_kernel_arguments_mirror_the_source(struct, args):
    assert [f for f, _t in args._fields_] == _struct_fields(struct)


def test_kernels_refuse_cpu_tensors():
    sd = scene_data("one")
    o, d = rays(0, n=8)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.to_local(sd.groups[0], o, d)
    res = {"t": torch.full((8,), BIG_F32), "mat": torch.zeros(8, dtype=torch.int32),
           "axis": torch.zeros(8, dtype=torch.int32), "step_sign": torch.ones(8, 3),
           "steps": torch.zeros(8, dtype=torch.int32)}
    with pytest.raises(ValueError, match="CUDA"):
        kernels.record(sd.groups[0], res)


def test_topk_refuses_cpu_tensors_and_names_the_plain_version():
    group = scene_data("stacked_first").groups[0]
    o, d = rays(0, n=8)
    with pytest.raises(ValueError, match="CUDA.*composite._topk"):
        kernels.topk(group, o, d, 2)


@pytest.mark.parametrize("k", [0, kernels.TOPK_MAX + 1])
def test_topk_refuses_k_outside_its_bound(k):
    """The prepass kernel holds K = 1..TOPK_MAX; any other K raises before
    a launch, on any device, naming the plain version."""
    group = scene_data("stacked_first").groups[0]
    o, d = rays(0, n=8)
    with pytest.raises(ValueError, match=f"k = {k} outside 1..{kernels.TOPK_MAX}.*_topk"):
        kernels.topk(group, o, d, k)


def _prepass_spans(fn):
    from voxel_tracer_tpu_torch.utils import profiling
    profiling.take_spans()
    with profiling.recording():
        out = fn()
    return out, [r["attrs"] for r in profiling.take_spans() if r["name"] == "topk"]


@pytest.mark.parametrize("site", ["primary", "group"])
@pytest.mark.parametrize("plain", [False, True], ids=["default", "PLAIN"])
def test_cpu_and_plain_prepasses_take_the_plain_topk(site, plain, monkeypatch):
    """A stacked group's prepass on CPU tensors, or under `composite.PLAIN`,
    is the plain `_topk`: the kernel is never called and the `topk` span
    says ``fused`` False."""
    sd = scene_data("stacked_first")
    fn, args, kw = site_args(site, sd, seed=3, n=64)
    if plain:
        fn = getattr(composite.PLAIN, fn.__name__)
    monkeypatch.setattr(kernels, "topk", _refused)
    calls = []
    real = composite._topk
    monkeypatch.setattr(composite, "_topk", lambda *a: calls.append(a[3]) or real(*a))
    kernels.reset_launch_counts()
    _out, spans = _prepass_spans(lambda: fn(*args, **kw))
    assert calls == [kw["max_candidates"]] and kernels.KERNEL_LAUNCHES["composite_topk"] == 0
    assert spans == [{"objects": 3, "k": kw["max_candidates"], "fused": False}]


@pytest.mark.parametrize("k", [1, 4, kernels.TOPK_MAX, kernels.TOPK_MAX + 1, 12])
def test_fused_prepass_takes_the_kernel_at_every_k(k, monkeypatch):
    """On a fused traversal the prepass goes to `kernels.topk` (stood in
    for here by the plain version) whatever K is: a K above `TOPK_MAX` is
    the kernel's to refuse, never a fall back to the plain `_topk`; the
    span says ``fused``."""
    group = scene_data("stacked_first").groups[0]
    o, d = rays(6, n=64)
    taken = []

    def fake(group, origins, dirs, k):
        taken.append(k)
        return composite._topk(group, origins, dirs, k)
    monkeypatch.setattr(kernels, "topk", fake)
    out, spans = _prepass_spans(lambda: composite._slab_prepass_topk(group, o, d, k, True))
    assert taken == [k]
    assert spans == [{"objects": 3, "k": k, "fused": True}]
    ref = composite._topk(group, o, d, k)
    assert_same(out, ref, "topk")
    assert out[0].shape == (64, k) and out[1].dtype == torch.int32
    # fewer objects than slots: the slots no object fills keep 1e30 and 0
    assert (out[0][:, 3:] == BIG_F32).all() and (out[1][:, 3:] == 0).all()
    _out, spans = _prepass_spans(lambda: composite._slab_prepass_topk(group, o, d, k, False))
    assert spans == [{"objects": 3, "k": k, "fused": False}] and taken == [k]


@pytest.mark.parametrize("kw", [{}, {"ignore": GLASS}], ids=["primary", "scan"])
def test_trace_one_equals_the_record_it_returned(kw):
    """A one-volume group's traversal (the grid-sharded trace's per-slab
    record) is the replaced `_trace_one`'s record merged into the miss
    record, as `intersect_scene` has always taken it.  The two differ only
    where D1 gives a miss a t above BIG_F32 (inf, on a zero direction):
    merged, that t reads BIG_F32."""
    sd = scene_data("stacked_first")
    group = sd.groups[0]
    slab = VolumeData(*(f[1:2] for f in group))
    o, d = rays(4)
    out = composite.intersect_group(slab, o, d, max_steps=dda.MAX_STEPS, obj_base=3, **kw)
    ref = _parent_trace_one(group, 1, o, d, dda.MAX_STEPS, 2,
                            dda_fn=dda.intersect_volume_local, **kw)
    assert_same(out, composite.HitResult.miss(N, "cpu").nearer(ref), "trace_one")
    assert 0 < (out.t < BIG_F32).sum() < N
    above = ref.t > BIG_F32
    assert above.any() and (d[above] == 0).all()
    assert_same(out._replace(t=torch.where(above, ref.t, out.t)), ref, "unmerged")
