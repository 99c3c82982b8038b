"""The tables that D1 (`csrc/dda.cu`) reads in place of the int32 grid
and brick counts, on the CPU: `ops/cuda/dda.dda_tables` derives a brick
bitmap, 16 occupancy words and 512 material bytes a brick and a flag for
ids outside [0, 255]; `tables_for` keeps them on the grid's base tensor
and derives them anew after an in-place edit.

- the tables decode back to the grid and the brick counts they came
  from: a seeded random grid, a stacked (O, Z, Y, X) grid, a grid that is
  not a whole number of bricks, and grids with ids outside [0, 255];
- the cache: the same tables while nothing changes, new ones after
  `mega.set_voxel_tables` edits the tables in place (its edit of
  `tb.grid` and `tb.brick_occ`), after `MegaIntersector.set_voxel`, and
  after an edit of the brick counts alone; one entry a slice of stacked
  grids, each equal to the slice's own tables.
"""

import numpy as np
import pytest
import torch

from voxel_tracer_tpu_torch.models.volume import compute_brick_occ
from voxel_tracer_tpu_torch.ops.cuda import dda as d1
from voxel_tracer_tpu_torch.ops.cuda import mega


def _grid(shape, seed, fill=0.3, hi=256):
    rng = np.random.RandomState(seed)
    g = rng.randint(1, hi, shape)
    g[rng.rand(*shape) > fill] = 0
    return g.astype(np.int32)


def _bricks_of(grid):
    """(O, Z, Y, X) -> (O * NB, 512) brick-major ids, zero-padded."""
    o, gz, gy, gx = grid.shape
    bz, by, bx = (-(-s // 8) for s in (gz, gy, gx))
    pad = np.zeros((o, bz * 8, by * 8, bx * 8), grid.dtype)
    pad[:, :gz, :gy, :gx] = grid
    return pad.reshape(o, bz, 8, by, 8, bx, 8).transpose(0, 1, 3, 5, 2, 4, 6).reshape(-1, 512)


def _bits(words, n):
    """The first n bits of int32 words (uint32 bits), bit k of word k // 32."""
    w = np.asarray(words, np.int32).view(np.uint32).reshape(-1)
    return ((w[:, None] >> np.arange(32, dtype=np.uint32)) & 1).reshape(-1)[:n].astype(bool)


def _decode(tb, grid, bocc):
    """Assert that tables ``tb`` decode to ``grid`` (O, Z, Y, X) and its brick
    counts ``bocc`` (O, BZ, BY, BX)."""
    bricks = _bricks_of(grid)
    nb_all = bricks.shape[0]
    assert tuple(tb.bits.shape) == (-(-nb_all // 32),)
    np.testing.assert_array_equal(_bits(tb.bits.numpy(), nb_all), bocc.reshape(-1) > 0)
    occ = _bits(tb.occw.numpy(), nb_all * 512).reshape(nb_all, 512)
    np.testing.assert_array_equal(occ, bricks != 0)
    assert tb.matb.dtype == torch.uint8 and tuple(tb.matb.shape) == (nb_all, 512)
    np.testing.assert_array_equal(tb.matb.numpy()[occ], bricks[occ].astype(np.uint8))
    wide = int(((grid < 0) | (grid > 255)).any())
    assert tb.wide.tolist() == [wide]
    if not wide:
        np.testing.assert_array_equal(tb.matb.numpy(), bricks)


CASES = {
    "random 32^3": (_grid((32, 32, 32), 1),),
    "stacked (3, 24, 16, 40)": (_grid((3, 24, 16, 40), 2),),
    "partial bricks 20x13x27": (_grid((20, 13, 27), 3),),
    "stacked partial (2, 9, 17, 5)": (_grid((2, 9, 17, 5), 4),),
    "ids past 255": (_grid((16, 24, 8), 5, hi=1000),),
    "negative ids": (-_grid((12, 12, 12), 6),),
    "sparse 64^3": (_grid((64, 64, 64), 7, fill=0.002),),
}


@pytest.mark.parametrize("case", list(CASES))
def test_tables_decode_to_grid_and_brick_counts(case):
    (grid,) = CASES[case]
    stacked = grid if grid.ndim == 4 else grid[None]
    bocc = np.stack([compute_brick_occ(g) for g in stacked])
    tb = d1.dda_tables(torch.from_numpy(grid), torch.from_numpy(bocc.reshape(
        bocc.shape if grid.ndim == 4 else bocc.shape[1:])))
    _decode(tb, stacked, bocc)


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int32, torch.int64])
def test_tables_take_any_integer_grid(dtype):
    grid = _grid((16, 16, 24), 8)
    bocc = compute_brick_occ(grid)
    tb = d1.dda_tables(torch.from_numpy(grid).to(dtype), torch.from_numpy(bocc))
    ref = d1.dda_tables(torch.from_numpy(grid), torch.from_numpy(bocc))
    for a, b in zip(tb, ref):
        assert torch.equal(a, b)


def test_bitmap_follows_brick_counts_not_the_grid():
    """The bitmap is the brick counts' (the plain DDA enters a brick by its
    count), even where a count disagrees with the grid."""
    grid = _grid((16, 16, 16), 9)
    bocc = compute_brick_occ(grid)
    bocc[0, 0, 0] = 0
    bocc[1, 1, 1] = 7
    grid[8:, 8:, 8:] = 0
    tb = d1.dda_tables(torch.from_numpy(grid), torch.from_numpy(bocc))
    _decode(tb, grid[None], bocc[None])


def _packed(seed=10):
    grid = _grid((24, 16, 32), seed).astype(np.uint8)
    pal = np.random.RandomState(seed).rand(256, 3).astype(np.float32)
    return mega.pack_tables(grid, pal, 16.0, device="cpu")


def test_cache_keeps_tables_until_an_edit():
    tb = _packed()
    first = d1.tables_for(tb.grid, tb.brick_occ)
    assert d1.tables_for(tb.grid, tb.brick_occ) is first
    assert d1.tables_for(tb.grid, tb.brick_occ) is first      # not rebuilt without an edit
    mega.set_voxel_tables(tb, 5, 3, 17, 200)
    mega.set_voxel_tables(tb, 9, 9, 9, 0)
    edited = d1.tables_for(tb.grid, tb.brick_occ)
    assert edited is not first
    grid = tb.grid.numpy()
    _decode(edited, grid[None].astype(np.int32), tb.brick_occ.numpy()[None])
    assert d1.tables_for(tb.grid, tb.brick_occ) is edited


def test_cache_sees_an_edit_of_the_brick_counts_alone():
    tb = _packed(11)
    first = d1.tables_for(tb.grid, tb.brick_occ)
    tb.brick_occ[0, 0, 0] = 0
    second = d1.tables_for(tb.grid, tb.brick_occ)
    assert second is not first
    assert not _bits(second.bits.numpy(), 1)[0]


def test_cache_sees_megaintersector_set_voxel():
    from voxel_tracer_tpu_torch.models.volume import VoxelVolume
    from voxel_tracer_tpu_torch.ops.cuda.whitted import MegaIntersector
    vol = VoxelVolume.noise_filled((16, 16, 16))
    ix = MegaIntersector(mega.MegaVolume(vol, "cpu"))
    first = d1.tables_for(ix.grid_dda, ix.brick_occ)
    x, y, z = 3, 4, 5
    val = 0 if int(ix.grid_dda[z, y, x]) else 30
    ix.set_voxel(x, y, z, val)
    edited = d1.tables_for(ix.grid_dda, ix.brick_occ)
    assert edited is not first
    _decode(edited, ix.grid_dda.numpy()[None], ix.brick_occ.numpy()[None])


def test_cache_one_entry_a_slice_of_stacked_grids():
    grids = _grid((3, 16, 16, 16), 12)
    bocc = torch.from_numpy(np.stack([compute_brick_occ(g) for g in grids]))
    stacked = torch.from_numpy(grids)
    tables = [d1.tables_for(stacked[k], bocc[k]) for k in range(3)]
    assert len({id(t) for t in tables}) == 3
    assert [d1.tables_for(stacked[k], bocc[k]) for k in range(3)] == tables
    for k in range(3):
        _decode(tables[k], grids[k][None], bocc[k].numpy()[None])
    whole = d1.tables_for(stacked, bocc)
    _decode(whole, grids, bocc.numpy())
    stacked[1, 2, 3, 4] = 99                # an edit through the base
    assert d1.tables_for(stacked[0], bocc[0]) is not tables[0]
