"""Profiling scene and trace helpers (src/dev/profile.h analog).

Counterpart of `voxel_tracer_tpu/utils/profiling.py`.  The reference's
PROFILING build renders a deterministic 8x8x8 grid of 512 crate volumes
with a canned camera (profile.h:10-37, camera_profiling.bin).  Here the
same scene is built from the reference's crate assets when the
environment variable VOXEL_TRACER_ASSET_DIR names a directory that holds
them (`ASSET_DIR`) and from procedural crates otherwise, then baked
into one 256^3 grid for the coherent kernel (`profiling_scene_merged`).
The other benchmark scenes are built here too: the budget rays
(`budget_scene`), the coherent kernel's edge-case rays (`edge_rays`), the
glass-box stand-in (`glass_box_scene`, `glass_box_camera`) and
inverse_128_32views' blob and ring views (`blob_field`, `ring_views`).

`trace()` records a `torch.profiler` trace of a code block (host and
device timelines, exported as a Chrome trace).  `annotate()` is the
program's span: off by default, and with `spans(True)` (or inside
`recording()`) each span records its name, id, parent, frame and start
and end on the clock of the device trace, and stands in the trace as a
`record_function` range when a profiler window is open.  `take_spans()`
hands the records out.
"""

from __future__ import annotations

import contextlib
import functools
import math
import os
import tempfile
import time

import numpy as np
import torch

from voxel_tracer_tpu_torch.models.camera import Camera, rays_for_image
from voxel_tracer_tpu_torch.models.volume import VoxelVolume
from voxel_tracer_tpu_torch.models.vox import load_vox

VOXEL = 1.0 / 20.0  # reference VOXEL scale (common.h:18, vpu 20)
# the reference's .vox assets: read only from the directory the caller
# names, so that a checkout renders the same scene wherever it lies
ASSET_DIR = os.environ.get("VOXEL_TRACER_ASSET_DIR")


@contextlib.contextmanager
def trace(logdir: str = None, host_tracer_level: int = 2):
    """Record a `torch.profiler` trace (CPU and, where present, CUDA
    activity) around a code block; the Chrome trace is written to
    ``logdir``/trace.json.  ``host_tracer_level`` is JAX's argument,
    accepted and ignored: `torch.profiler` records every host op at one
    level of detail and has no such setting (``with_stack`` adds Python
    stacks, not a level).  Usage:

        with profiling.trace(d):
            out = render(...); torch.cuda.synchronize()
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    logdir = logdir or os.path.join(tempfile.gettempdir(), "voxel_tracer_trace")
    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------

MAX_SPANS = 1 << 18     # records kept between two `take_spans`; later ones are dropped

_on = False
_records = []           # spans in the order they opened
_open = []              # the open spans, innermost last
_next_id = 0
_dropped = 0


def spans(on: bool = True) -> bool:
    """Turn span recording on or off; returns the previous setting."""
    global _on
    prev, _on = _on, bool(on)
    return prev


@contextlib.contextmanager
def recording():
    """Record spans inside the block, then restore the previous setting."""
    prev = spans(True)
    try:
        yield
    finally:
        spans(prev)


def annotate(name: str, **attrs):
    """The program's span: a context manager, and a decorator when given no
    attributes.  Off (the default) it returns a shared no-op.  On, it
    records {name, id, parent, frame, start_ns, end_ns, attrs}: times in
    ns on CLOCK_REALTIME (`time.time_ns`), the clock the profiler stamps
    host events on; ``frame`` is the ``frame_id`` attribute of the
    innermost span that has one.  Inside a profiler window the span also
    enters `record_function(name)`.  ``keep`` (an (N,) bool tensor) names
    the rows of a stage's traversals whose result the stage keeps
    (`count_kept`); it is held while the span is open, not recorded."""
    if not _on:
        return _NOOP if attrs else _noop(name)
    return _Span(name, attrs)


class _Noop:
    """The span when recording is off: enters and leaves, records nothing."""

    __slots__ = ("name",)

    def __init__(self, name=None):
        self.name = name

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False

    def __call__(self, fn):
        if self.name is None:
            raise TypeError("a span with attributes does not decorate")
        return _decorate(self.name, fn)


_NOOP = _Noop()


@functools.cache
def _noop(name):
    return _Noop(name)


def _decorate(name, fn):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with annotate(name):
            return fn(*args, **kwargs)
    return wrapper


class _Span:
    __slots__ = ("record", "keep", "_rf")

    def __init__(self, name, attrs):
        self.keep = attrs.pop("keep", None)
        self.record = {"name": name, "id": None, "parent": None,
                       "frame": attrs.pop("frame_id", None),
                       "start_ns": None, "end_ns": None, "attrs": attrs}
        self._rf = None

    def __enter__(self):
        global _next_id, _dropped
        rec = self.record
        rec["id"], _next_id = _next_id, _next_id + 1
        if _open:
            parent = _open[-1].record
            rec["parent"] = parent["id"]
            if rec["frame"] is None:
                rec["frame"] = parent["frame"]
        rec["start_ns"] = time.time_ns()
        if torch._C._autograd._profiler_enabled():
            rf = torch.autograd.profiler.record_function(rec["name"])
            rf.__enter__()
            self._rf = rf
        if len(_records) < MAX_SPANS:
            _records.append(rec)
        else:
            _dropped += 1
        _open.append(self)
        return rec

    def __exit__(self, *exc):
        if self._rf is not None:
            self._rf.__exit__(*exc)
        self.record["end_ns"] = time.time_ns()
        _open.remove(self)
        return False

    def __call__(self, fn):
        if self.record["attrs"] or self.keep is not None:
            raise TypeError("a span with attributes does not decorate")
        return _decorate(self.record["name"], fn)


def count_kept(n: int, walked=None):
    """With spans on, note on the innermost open span how many of its call's
    ``n`` rays the enclosing stages keep: the rows set in every open
    span's ``keep`` of n rows (a device count, no host sync), all n where
    no such mask is open.  A mask of another length belongs to a stage
    whose rows were gathered before the call, so every row there is kept.
    ``walked`` (an (n,) integer tensor: the walks a call made of each row,
    as D1's candidate race counts them) counts each kept row that many
    times.  Off, it does nothing."""
    if not _on or not _open:
        return
    masks = [s.keep for s in _open if s.keep is not None and s.keep.shape[0] == n]
    m = None
    for other in masks:
        m = other if m is None else m & other
    if walked is None:
        kept = n if m is None else m.sum()
    else:
        kept = (walked if m is None else torch.where(m, walked, 0)).sum()
    _open[-1].record["attrs"]["kept"] = kept


def current_span():
    """The innermost open span's record, or None."""
    return _open[-1].record if _open else None


class _SpanList(list):
    dropped = 0


def take_spans():
    """Hand out the recorded spans, in the order they opened, and clear the
    buffer.  Each ``kept`` count is read from its device here, in one copy
    a device; a span still open has ``end_ns`` None.  The number of spans
    dropped past MAX_SPANS since the last take is the ``dropped``
    attribute of the returned list."""
    global _records, _dropped
    out = _SpanList(_records)
    out.dropped = _dropped
    _records, _dropped = [], 0
    pending = {}
    for rec in out:
        kept = rec["attrs"].get("kept")
        if isinstance(kept, torch.Tensor):
            pending.setdefault(kept.device, []).append(rec)
    for recs in pending.values():
        for rec, v in zip(recs, torch.stack([r["attrs"]["kept"] for r in recs]).tolist()):
            rec["attrs"]["kept"] = v
    return out


def _procedural_crate(n: int = 32, mat: int = 30) -> np.ndarray:
    """Crate-ish hollow box with edge beams (stand-in for crate-16.vox)."""
    g = np.zeros((n, n, n), np.uint8)
    g[:2], g[-2:] = mat, mat
    g[:, :2], g[:, -2:] = mat, mat
    g[:, :, :2], g[:, :, -2:] = mat, mat
    g[2:-2, 2:-2, 2:-2] = 0
    # face planks
    g[2, 2:-2, 2:-2] = mat + 1
    g[-3, 2:-2, 2:-2] = mat + 1
    return g


def profiling_volumes(count_per_axis: int = 8):
    """The 512-crate scene (profile.h:23-36): crate models alternating by
    z layer, spaced VOXEL * 32 apart."""
    models = []
    for name in ("crate-16.vox", "crate-10.vox"):
        path = os.path.join(ASSET_DIR, name) if ASSET_DIR else None
        if path and os.path.exists(path):
            m = load_vox(path)
            models.append((m.grid, m.palette_f32))
        else:
            models.append((_procedural_crate(), None))

    vols = []
    spacing = VOXEL * 32.0
    n = count_per_axis
    for z in range(n):
        grid, pal = models[z % 2]
        for y in range(n):
            for x in range(n):
                vols.append(VoxelVolume(
                    grid, pal, pos=(spacing * x, spacing * y, spacing * z),
                    vpu=20.0))
    return vols


def profiling_camera(aspect: float) -> Camera:
    """Fixed profiling pose (camera_profiling.bin analog): outside the
    crate field, looking into its center."""
    n = 8
    span = VOXEL * 32.0 * n
    center = np.array([span, span, span]) * 0.5
    pos = center + np.array([-span * 0.7, span * 0.45, -span * 0.8])
    return Camera.create(pos, center, aspect)


def profiling_scene_merged():
    """The 512-crate scene baked into one grid for the coherent kernel."""
    from voxel_tracer_tpu_torch.ops.cuda.renderer_fast import bake_aligned_scene

    return bake_aligned_scene(profiling_volumes())


def budget_scene(length: int = 4096, n_rays: int = 65536, seed: int = 0):
    """A long sparse volume whose rays run out of the DDA's 256-step budget.

    Grid (Z, Y, X) = (16, 16, length) at vpu 8: a random fill of about one
    voxel in 10,000, and every third brick along x holding one voxel in an
    outer corner, so that rays near the centre line (y = z = 8 voxels) walk
    it without hitting.  ``n_rays`` local rays start before x = 0 and head
    along +x: half within a voxel of the centre line with y/z slopes under
    0.004 (they cross from brick to brick near corners, and most spend the
    budget), a quarter anywhere with the same slopes, a quarter anywhere
    with slopes under 0.03 (most leave through a side).  Returns (grid,
    origins (N, 3) float32, directions (N, 3) float32, vpu), made with
    numpy from ``seed``.
    """
    vpu = 8.0
    rng = np.random.RandomState(seed)
    g = np.zeros((16, 16, length), np.uint8)
    fill = rng.rand(*g.shape) < 1e-4
    g[fill] = rng.randint(1, 256, int(fill.sum()))
    bx = np.arange(0, length // 8, 3)
    zs, ys = (np.where(rng.rand(bx.size) < 0.5, 0, 15) for _ in range(2))
    xs = bx * 8 + np.where(rng.rand(bx.size) < 0.5, 0, 7)
    g[zs, ys, xs] = rng.randint(1, 256, bx.size)

    n = n_rays
    yz = rng.uniform(0.25, 15.75, (n, 2))
    yz[: n // 2] = 8.0 + rng.uniform(-1.0, 1.0, (n // 2, 2))
    slope = rng.uniform(-0.004, 0.004, (n, 2))
    slope[3 * n // 4:] *= 7.5
    o = np.stack([np.full(n, -0.5), yz[:, 0], yz[:, 1]], axis=1) / vpu
    d = np.stack([np.ones(n), slope[:, 0], slope[:, 1]], axis=1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return g, o.astype(np.float32), d.astype(np.float32), vpu


# edge_rays' groups, in order: name -> slice of its rays
EDGE_RAY_GROUPS = dict(zip(
    ("axis", "zero", "corner", "edge", "solid", "solid_corner", "face", "far_away",
     "far_toward", "random"),
    (slice(a, b) for a, b in ((0, 288), (288, 384), (384, 512), (512, 576), (576, 640),
                              (640, 704), (704, 768), (768, 800), (800, 832),
                              (832, 1024)))))


def edge_rays(grid: np.ndarray, vpu: float):
    """Local rays at the edge cases of a brick walk through ``grid`` ((Z,
    Y, X), padded to whole 8^3 bricks) at ``vpu``, made with numpy from
    seed 0: 1024 rays in the groups of `EDGE_RAY_GROUPS`, in order:

    - axis: 288 axis-parallel rays, 48 in each of the six directions,
      entering through a face; their other two coordinates on brick
      planes, on voxel planes, at voxel centres or anywhere; their zero
      direction components +0 or -0;
    - zero: 96 rays with one zero direction component (+0 or -0);
    - corner: 128 rays through brick corners along the diagonal of a face
      or of the cube;
    - edge: 64 rays along a brick's edge line at slopes under 1e-3;
    - solid, solid_corner: 64 rays each starting at the centre, or the low
      corner, of a solid voxel, in random directions;
    - face: 64 rays starting on brick faces inside the volume;
    - far_away, far_toward: 32 rays each starting near 1e30, away from
      the volume along their direction (a missed pixel's shadow ray) and
      toward its centre;
    - random: 192 rays starting in and around the volume.

    Returns (origins (N, 3), directions (N, 3)) float32."""
    rng = np.random.RandomState(0)
    f32 = np.float32
    nbv = np.array([(n + 7) // 8 for n in grid.shape[::-1]])      # bricks (x, y, z)
    rbpu, rvpu = f32(8.0 / vpu), f32(1.0 / vpu)
    size = (nbv * 8 / vpu).astype(np.float32)

    def plane_coords(k):
        """k points whose coordinates lie on brick planes, on voxel planes,
        at voxel centres or anywhere inside the extent."""
        b = rng.randint(0, nbv + 1, (k, 3)).astype(np.float32) * rbpu
        v = rng.randint(0, nbv * 8 + 1, (k, 3)).astype(np.float32) * rvpu
        c = (rng.randint(0, nbv * 8, (k, 3)) + f32(0.5)).astype(np.float32) * rvpu
        r = rng.uniform(0.0, 1.0, (k, 3)).astype(np.float32) * size
        return np.choose(rng.randint(0, 4, (k, 1)), [b, v, c, r]).astype(np.float32)

    def signed_zeros(k):
        return np.where(rng.rand(k, 3) < 0.5, -0.0, 0.0).astype(np.float32)

    def unit(d):
        return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)

    def random_dirs(k):
        return unit(rng.randn(k, 3).astype(np.float32))

    groups = []
    axis = []                                   # axis-parallel through each face
    for a in range(3):
        for sign in (1.0, -1.0):
            o = plane_coords(48)
            o[:, a] = -0.25 * size[a] if sign > 0 else 1.25 * size[a]
            d = signed_zeros(48)
            d[:, a] = sign
            axis.append((o, d))
    groups.append(tuple(np.concatenate(x) for x in zip(*axis)))
    o = plane_coords(96)                        # one zero component
    d = rng.randn(96, 3).astype(np.float32)
    d[np.arange(96), rng.randint(0, 3, 96)] = signed_zeros(96)[:, 0]
    d = unit(d)
    groups.append((o - d * f32(0.75) * size.max(), d))
    corner = rng.randint(0, nbv + 1, (128, 3)).astype(np.float32) * rbpu
    d = np.where(rng.rand(128, 3) < 0.5, -1.0, 1.0).astype(np.float32)
    face = rng.rand(128) < 0.5                  # face diagonals: one component 0
    d[face, rng.randint(0, 3, int(face.sum()))] = 0.0
    d = unit(d)
    groups.append((corner - d * f32(2.0) * size.max(), d))
    o = rng.randint(0, nbv + 1, (64, 3)).astype(np.float32) * rbpu
    a = rng.randint(0, 3, 64)                   # along brick edge lines
    d = rng.uniform(-1e-3, 1e-3, (64, 3)).astype(np.float32)
    d[np.arange(64), a] = np.where(rng.rand(64) < 0.5, -1.0, 1.0)
    o[np.arange(64), a] = np.where(d[np.arange(64), a] > 0, -0.25, 1.25) * size[a]
    groups.append((o, unit(d)))
    zyx = np.argwhere(grid != 0)                # inside solid voxels
    for off in (0.5, 0.0):
        pick = zyx[rng.randint(0, len(zyx), 64)] if len(zyx) else np.zeros((64, 3), int)
        groups.append(((pick[:, ::-1] + f32(off)).astype(np.float32) * rvpu, random_dirs(64)))
    o = rng.uniform(0.0, 1.0, (64, 3)).astype(np.float32) * size
    a = rng.randint(0, 3, 64)                   # on brick faces
    o[np.arange(64), a] = rng.randint(0, nbv[a] + 1).astype(np.float32) * rbpu
    groups.append((o, random_dirs(64)))
    d = random_dirs(32)                         # near 1e30
    groups.append((d * f32(1e30), d))
    d = random_dirs(32)
    groups.append((size * f32(0.5) - d * f32(1e30), d))
    o = rng.uniform(-0.25, 1.25, (192, 3)).astype(np.float32) * size
    groups.append((o, random_dirs(192)))
    o, d = (np.concatenate(x).astype(np.float32) for x in zip(*groups))
    return o, d


def glass_box_scene(n: int = 128):
    """A procedural stand-in for bench_suite.py:381-437's glass-box and
    drones scene, every length scaled by n / 128 (vpu too, so the world
    extent stays): an n^3 grid (a diffuse floor, id 30; a hollow glass box
    with 2-voxel walls, id 4, around a diffuse pillar, id 40; a mirror
    plate, id 12) and four drone-sized diffuse ellipsoids at pos
    (i, 2.0, 0), baked into one volume; a procedural sky and one sphere
    light.  Returns (merged volume, host Scene)."""
    from voxel_tracer_tpu_torch.models.scene import Scene
    from voxel_tracer_tpu_torch.models.skydome import SkyDome
    from voxel_tracer_tpu_torch.ops.cuda.renderer_fast import bake_aligned_scene

    def s(v):
        return v * n // 128

    vpu = 20.0 * n / 128
    g = np.zeros((n, n, n), np.uint8)                          # (z, y, x), y up
    g[:, s(48):s(56), :] = 30                                  # floor slab
    g[s(30):s(70), s(56):s(96), s(30):s(70)] = 4               # glass box
    g[s(32):s(68), s(56):s(94), s(32):s(68)] = 0               # hollow, open below
    g[s(44):s(56), s(56):s(84), s(44):s(56)] = 40              # pillar inside
    g[s(20):s(70), s(56):s(110), s(90):s(94)] = 12             # mirror plate
    rng = np.random.RandomState(0)
    pal = (rng.rand(256, 3) * 0.8 + 0.1).astype(np.float32)
    # grid corner at (-2.4, -3.2, -4.9): the drones land at grid y 96..112
    base = VoxelVolume(g, palette=pal, pos=(0.8, 0.0, -1.7), vpu=vpu)
    m = s(16)
    c = (m - 1) / 2
    z, y, x = np.meshgrid(*[np.arange(m)] * 3, indexing="ij")
    body = ((x - c) ** 2 / (m / 2) ** 2 + (y - c) ** 2 / (m / 4) ** 2
            + (z - c) ** 2 / (m / 2) ** 2) <= 1.0
    drones = [VoxelVolume(np.where(body, 17 + 8 * i, 0).astype(np.uint8), palette=pal,
                          pos=(float(i), 2.0, 0.0), vpu=vpu) for i in range(4)]
    merged = bake_aligned_scene([base] + drones)
    scene = Scene(volumes=[merged], skydome=SkyDome.procedural(64, 32))
    scene.add_light((2.0, 3.5, -1.5), 0.15, (1.0, 0.9, 0.8), 40.0)
    return merged, scene


def glass_box_camera(merged, theta: float, width: int, height: int) -> Camera:
    """bench_suite.py:452-457's orbit camera around `glass_box_scene`."""
    c0 = np.asarray(merged.pos) + np.asarray(merged.size) * 0.5
    pos = (c0[0] + 3.2 * math.cos(theta * 10.0), c0[1] + 1.2,
           c0[2] + 3.2 * math.sin(theta * 10.0))
    return Camera.create(pos, tuple(c0), width / height)


def blob_field(g, seed, peak=40.0, scale=0.25):
    """bench_suite.py's sparse blob: a Gaussian with exact zeros outside
    (~15 % of voxels occupied), random density inside, random albedo."""
    rng = np.random.RandomState(seed)
    zz, yy, xx = np.meshgrid(*[np.linspace(0, 1, g)] * 3, indexing="ij")
    r2 = (xx - 0.5) ** 2 + (yy - 0.5) ** 2 + (zz - 0.5) ** 2
    blob = peak * np.exp(-r2 * 60.0)
    sigma = np.where(blob > 0.05, rng.rand(g, g, g) * blob * scale, 0.0)
    return sigma.astype(np.float32), rng.rand(g, g, g, 3).astype(np.float32)


def ring_views(g=128, views=32, px=64, vpu=20.0):
    """inverse_128_32views (bench_suite.py:480-506): ``views`` ring views
    of px x px pixels around the g^3 grid, grid-local rays in 32x32 tile
    order, numpy."""
    from voxel_tracer_tpu_torch.ops.cuda import diffint
    center = g / (2 * vpu)
    os_, ds_ = [], []
    for v in range(views):
        th = 2 * np.pi * v / views
        r = 2.2 * g / vpu / 4
        pos = (center + r * np.cos(th), center * 1.35, center + r * np.sin(th))
        cam = Camera.create(pos, (center,) * 3, 1.0)
        o, d = rays_for_image(cam, px, px, device="cpu")
        os_.append(diffint.tile_raster(o.numpy(), px, px))
        ds_.append(diffint.tile_raster(d.numpy(), px, px))
    return (np.ascontiguousarray(np.concatenate(os_)),
            np.ascontiguousarray(np.concatenate(ds_)))
