"""The two-level (brickmap) Amanatides-Woo DDA, lock-step over rays.

A frozen plain copy of the traversal the port's D1 kernel computes (the
JAX package's `ops/dda.py` semantics: the shared 256-step budget, the
glass medium and scan modes, the stochastic shadow roll, the XLA-style
fused multiply-adds at the entry points), in plain PyTorch.  Every
traversal of the reference frame runs here.
"""

from __future__ import annotations

import torch

from port_bench.reference.geometry import BIG as BIG_F32, sign_dir

MAX_STEPS = 256
BRICK = 8

# Ray state machine modes
_MISS = 0      # terminated without a hit
_BRICK = 1     # about to test the brick at bcell
_FINE = 2      # about to test the voxel at fcell inside bcell
_HIT = 3       # terminated with a hit

# rays test for termination every this many lock-step iterations (one host
# sync each); extra iterations leave finished rays unchanged
_SYNC_EVERY = 8


def slab_test(origin_l, dir_l, size):
    """Batched slab entry test vs the local AABB [0, size].

    Vectorized analog of OBB::intersect (obb.cpp:48-80): tmin clamped >= 0,
    hit iff tmax - 1e-4 >= tmin.  Returns (tmin, tmax, entry_axis, hitmask).
    """
    rcp = torch.reciprocal(dir_l)                       # +-inf where dir == 0
    t1 = (0.0 - origin_l) * rcp
    t2 = (size - origin_l) * rcp
    tn = torch.minimum(t1, t2)
    tf = torch.maximum(t1, t2)
    # NaN guard: 0 * inf when the origin sits exactly on a slab plane.
    tn = torch.where(torch.isnan(tn), -BIG_F32, tn)
    tf = torch.where(torch.isnan(tf), BIG_F32, tf)
    tn = torch.cat([torch.zeros_like(tn[..., :1]), tn], dim=-1)  # clamp >= 0
    entry_axis = torch.argmax(tn, dim=-1)               # 0 => clamped at origin
    tmin = torch.amax(tn, dim=-1)
    tmax = torch.amin(tf, dim=-1)
    hit = tmax - 1e-4 >= tmin
    entry_axis = torch.clamp(entry_axis - 1, min=0)     # fold origin-clamp into axis 0
    return tmin, tmax, entry_axis.to(torch.int32), hit


def _fma(a, b, c):
    """a * b + c rounded once to float32, like CUDA's fmaf.

    The float64 product of two float32 values is exact, and the float64 sum
    rounds once before the cast; that differs from a true fused
    multiply-add only where the float64 sum lands exactly on a float32
    rounding tie."""
    return (a.double() * b.double() + c.double()).float()


def _aw_step(cell, tmax3, step, delta, size3):
    """One Amanatides-Woo step in the reference comparison order
    (vv.cpp:176-202).  Returns (cell, tmax3, t, axis, oob)."""
    tx, ty, tz = tmax3.unbind(-1)
    use_x = (tx < ty) & (tx < tz)
    use_y = ~(tx < ty) & (ty < tz)
    axis = torch.where(use_x, 0, torch.where(use_y, 1, 2))
    onehot = torch.nn.functional.one_hot(axis, 3).bool()
    cell = cell + torch.where(onehot, step, 0)
    t = torch.gather(tmax3, -1, axis[:, None])[:, 0]
    tmax3 = tmax3 + torch.where(onehot, delta, 0.0)
    moved = torch.gather(cell, -1, axis[:, None])[:, 0]
    oob = (moved < 0) | (moved >= size3[axis])
    return cell, tmax3, t, axis.to(torch.int32), oob


_U32 = 0xFFFFFFFF


def _mul32(h, c: int):
    """(h * c) mod 2**32 for int64 tensors h in [0, 2**32): the constant
    is split into 16-bit halves so no product leaves int64."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def hash_shadow(seed, cell_xyz):
    """Counting hash -> uniform [0, 1) per (ray seed, voxel cell).

    The deterministic stand-in for the reference's RandomFloat() in the
    shadow-ray stochastic absorption (vv.cpp:322), bit for bit the JAX
    function's lowbias32-style avalanche: uint32 arithmetic carried in
    int64 and masked to 32 bits, then uint32 -> float32 x 2**-32.
    seed: (N,) integer tensor of uint32 values; cell_xyz: (N, 3) integer."""
    c = cell_xyz.long() & _U32
    h = (seed.long() & _U32) ^ _mul32(c[..., 0], 0x9E3779B1) \
        ^ _mul32(c[..., 1], 0x85EBCA77) ^ _mul32(c[..., 2], 0xC2B2AE3D)
    h = h ^ (h >> 16)
    h = _mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x846CA68B)
    h = h ^ (h >> 16)
    return h.to(torch.float32) * (1.0 / 4294967296.0)


def _ladder_axis(tmax3):
    """Axis the next A&W step would take: the reference tmax comparison
    ladder (vv.cpp:208-219), the medium grid-exit normal."""
    tx, ty, tz = tmax3.unbind(-1)
    use_x = (tx < ty) & (tx < tz)
    use_y = ~(tx < ty) & (ty < tz)
    return torch.where(use_x, 0, torch.where(use_y, 1, 2)).to(torch.int32)


def _gather3(grid_zyx, cell_xyz, oid=None):
    """grid[(o,) z, y, x] as int32 with 0 outside the grid.

    grid_zyx: (Z, Y, X) or, with per-ray object indices ``oid``,
    (O, Z, Y, X) stacked grids."""
    gz, gy, gx = grid_zyx.shape[-3:]
    x, y, z = cell_xyz.unbind(-1)
    inb = (x >= 0) & (x < gx) & (y >= 0) & (y < gy) & (z >= 0) & (z < gz)
    flat = (torch.clamp(z, 0, gz - 1).long() * (gy * gx)
            + torch.clamp(y, 0, gy - 1).long() * gx
            + torch.clamp(x, 0, gx - 1).long())
    if oid is not None:
        flat = flat + oid.long() * (gz * gy * gx)
    vals = grid_zyx.reshape(-1)[flat].to(torch.int32)
    return torch.where(inb, vals, 0)


def _cell_setup(entry, stepf, rdir, hi):
    """First cell and crossing t's of a DDA level entered at ``entry``
    (in that level's cell units)."""
    cell = torch.minimum(torch.clamp(torch.floor(entry).to(torch.int32), min=0), hi)
    tmax3 = ((cell.to(torch.float32) - entry) + torch.clamp(stepf, min=0.0)) * rdir
    tmax3 = torch.where(torch.isnan(tmax3), BIG_F32, tmax3)
    return cell, torch.clamp(tmax3, max=BIG_F32)


def intersect_volume_local(grid, brick_occ, origin_l, dir_l, vpu,
                           oid=None, max_steps: int = MAX_STEPS,
                           medium=None, ignore=None, shadow_seed=None,
                           shadow: bool = False):
    """Two-level DDA of N local-space rays through one voxel volume.

    Args:
      grid:      (Z, Y, X) integer material ids, 0 = air, or (O, Z, Y, X)
                 stacked grids with per-ray indices ``oid``.
      brick_occ: (BZ, BY, BX) or (O, BZ, BY, BX) integer per-brick solid
                 count.
      origin_l:  (N, 3) float32 ray origins in volume-local space.
      dir_l:     (N, 3) float32 unit ray directions in local space.
      vpu:       voxels per world unit: a float, or a scalar or per-ray
                 (N,) tensor.
      oid:       optional (N,) integer object index per ray.
      medium:    optional (N,) integer medium id; nonzero = interior exit
                 march (vv.cpp:166-175, 206-232, 297-310).
      ignore:    optional (N,) integer material to pass until air is seen
                 (vv.cpp:328-335; 0 = off).
      shadow_seed: (N,) integer tensor of uint32 seeds; with ``shadow=True``
                 ids <= 16 occlude stochastically (vv.cpp:314-327).

    Returns a dict of (N,) tensors: t (BIG_F32 = miss), mat, axis (last
    step axis), step_sign (N, 3), steps, valid (slab hit mask), slab_tmin,
    slab_tmax, entry_axis (slab entry axis), and resolved (False where the
    step budget ran out; such a ray is a miss, or with a medium an exit at
    the slab tmax).
    """
    dev = origin_l.device
    n = origin_l.shape[0]
    gz, gy, gx = grid.shape[-3:]
    bz, by, bx = brick_occ.shape[-3:]
    vsize3 = torch.tensor([gx, gy, gz], dtype=torch.int32, device=dev)
    bsize3 = torch.tensor([bx, by, bz], dtype=torch.int32, device=dev)
    fsize3 = torch.full((3,), BRICK, dtype=torch.int32, device=dev)
    vpu_t = torch.as_tensor(vpu, dtype=torch.float32).to(dev)
    per_ray = vpu_t.ndim == 1
    vpu_c = vpu_t[:, None] if per_ray else vpu_t       # broadcasts over (N, 3)
    size_l = vsize3.to(torch.float32) / vpu_c

    tmin, tmax, entry_axis, slab_hit = slab_test(origin_l, dir_l, size_l)

    bpu = vpu_t / torch.tensor(float(BRICK), device=dev)
    rbpu = torch.reciprocal(bpu)
    bpu_c = bpu[:, None] if per_ray else bpu
    rbpu_c = rbpu[:, None] if per_ray else rbpu
    stepf = sign_dir(dir_l)
    stepi = stepf.to(torch.int32)
    rdir = torch.reciprocal(dir_l)
    # clamp inf (axis-parallel rays) so tmax += delta never meets 0*inf
    delta = torch.clamp(torch.abs(rdir), max=BIG_F32)

    entry = _fma(dir_l, tmin[:, None], origin_l) * bpu_c
    bcell, btmax = _cell_setup(entry, stepf, rdir, bsize3 - 1)

    zeros_f = torch.zeros((n,), dtype=torch.float32, device=dev)
    zeros_i = torch.zeros((n,), dtype=torch.int32, device=dev)
    medium_on = None if medium is None else medium > 0
    mode = torch.where(slab_hit, _BRICK, _MISS).to(torch.int32)
    hit_t = torch.full((n,), BIG_F32, dtype=torch.float32, device=dev)
    if medium is not None:
        # a slab miss inside a medium exits at once at t = 0 with material
        # air (vv.cpp:228-232)
        miss_med = ~slab_hit & medium_on
        mode = torch.where(miss_med, _HIT, mode).to(torch.int32)
        hit_t = torch.where(miss_med, 0.0, hit_t)
    if shadow:
        shadow_seed = torch.broadcast_to(torch.as_tensor(shadow_seed).to(dev), (n,))
    bt = zeros_f
    fcell = torch.zeros((n, 3), dtype=torch.int32, device=dev)
    ftmax = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    ft = zeros_f
    b_entry = zeros_f
    axis = entry_axis
    steps = zeros_i
    hit_mat = zeros_i
    hit_entry = torch.zeros((n,), dtype=torch.bool, device=dev)
    exited = torch.zeros((n,), dtype=torch.bool, device=dev)
    exhausted_any = torch.zeros((n,), dtype=torch.bool, device=dev)

    def active(m):
        return (m == _BRICK) | (m == _FINE)

    for it in range(2 * max_steps):
        if it % _SYNC_EVERY == 0 and not bool(
                (active(mode) & (steps < max_steps)).any()):
            break
        in_budget = steps < max_steps
        is_brick = (mode == _BRICK) & in_budget
        is_fine = (mode == _FINE) & in_budget
        # the JAX loop stops once no ray is active within the budget; the
        # iterations run past that point between syncs change nothing
        go = (is_brick | is_fine).any()
        # budget exhausted -> miss (vv.cpp loop bound); interior rays exit
        # at the slab tmax instead (vv.cpp:206-225: the post-loop medium
        # branch fires on exhaustion too, axis from the brick tmax)
        exhausted = active(mode) & ~in_budget & go
        exhausted_any = exhausted_any | exhausted
        mode = torch.where(exhausted, _MISS, mode)
        if medium is not None:
            exh_med = exhausted & medium_on
            mode = torch.where(exh_med, _HIT, mode)
            hit_t = torch.where(exh_med, tmax, hit_t)
            hit_mat = torch.where(exh_med, 0, hit_mat)

        # ---- brick phase: test occupancy ----------------------------------
        occ = _gather3(brick_occ, bcell, oid) > 0
        enter_fine = is_brick & occ
        brick_step = is_brick & ~occ
        if medium is not None:
            # an empty brick inside a medium exits at its entry plane
            # (vv.cpp:166-175)
            med_brick_exit = brick_step & medium_on
            brick_step = brick_step & ~medium_on

        # fine setup for rays entering an occupied brick (vv.cpp:237-251)
        brick_entry_t = _fma(bt, rbpu, tmin)
        p = _fma(dir_l, brick_entry_t[:, None], origin_l)
        fentry = _fma(-bcell.to(torch.float32), rbpu_c, p) * vpu_c
        fcell_new, ftmax_new = _cell_setup(fentry, stepf, rdir, fsize3 - 1)

        # ---- fine phase: test voxel ---------------------------------------
        vc = bcell * BRICK + fcell
        voxel = _gather3(grid, vc, oid)
        solid = voxel != 0
        if shadow:
            # ids > 16 occlude; glass/mirror rows occlude with p = 0.15 per
            # voxel (vv.cpp:314-327)
            hit_vox = solid & ((voxel > 16) | (hash_shadow(shadow_seed, vc) > 0.85))
        elif ignore is not None:
            # scan-ray pass-through until air is seen (vv.cpp:328-335)
            hit_vox = solid & (exited | (voxel != ignore))
        else:
            hit_vox = solid
        if medium is not None:
            # interior exit: the first voxel that differs from the medium,
            # air included (vv.cpp:297-310)
            hit_vox = torch.where(medium_on, voxel != medium, hit_vox)
        fine_hit = is_fine & hit_vox

        nfcell, nftmax, nft, nfaxis, f_oob = _aw_step(
            fcell, ftmax, stepi, delta, fsize3)
        fine_step = is_fine & ~fine_hit
        fine_exit = fine_step & f_oob       # leave brick -> brick step (same iter)
        fine_move = fine_step & ~fine_exit

        # brick step for: empty-brick rays and fine-exit rays (shared unit)
        do_bstep = brick_step | fine_exit
        nbcell, nbtmax, nbt, nbaxis, b_oob = _aw_step(
            bcell, btmax, stepi, delta, bsize3)

        # ---- merge ---------------------------------------------------------
        hit_t = torch.where(fine_hit, b_entry + ft / vpu_t, hit_t)
        hit_mat = torch.where(fine_hit, voxel, hit_mat)
        hit_entry = torch.where(fine_hit, steps == 0, hit_entry)

        mode = torch.where(fine_hit, _HIT, mode)
        mode = torch.where(do_bstep & b_oob, _MISS, mode)
        mode = torch.where(enter_fine, _FINE, mode)
        mode = torch.where(fine_exit & ~b_oob, _BRICK, mode)
        if medium is not None:
            # interior grid exit at the slab tmax (vv.cpp:206-225); its
            # axis is the attempted brick step's, merged below
            med_grid_exit = do_bstep & b_oob & medium_on
            mode = torch.where(med_brick_exit | med_grid_exit, _HIT, mode)
            hit_t = torch.where(med_brick_exit, brick_entry_t, hit_t)
            hit_t = torch.where(med_grid_exit, tmax, hit_t)
            hit_mat = torch.where(med_brick_exit | med_grid_exit, 0, hit_mat)
            hit_entry = torch.where(med_brick_exit, steps == 0, hit_entry)
        mode = mode.to(torch.int32)

        bs = do_bstep[:, None]
        bcell = torch.where(bs, nbcell, bcell)
        btmax_prev = btmax
        btmax = torch.where(bs, nbtmax, btmax)
        bt = torch.where(do_bstep, nbt, bt)

        ef, fm = enter_fine[:, None], fine_move[:, None]
        fcell = torch.where(ef, fcell_new, torch.where(fm, nfcell, fcell))
        ftmax = torch.where(ef, ftmax_new, torch.where(fm, nftmax, ftmax))
        ft = torch.where(enter_fine, 0.0, torch.where(fine_move, nft, ft))
        b_entry = torch.where(enter_fine, brick_entry_t, b_entry)

        axis = torch.where(do_bstep, nbaxis, torch.where(fine_move, nfaxis, axis))
        steps = steps + (do_bstep | fine_move).to(torch.int32)
        if ignore is not None:
            saw_air = (is_fine & ~solid) | brick_step
            exited = exited | (saw_air & (ignore > 0))
        if medium is not None:
            axis = torch.where(exh_med, _ladder_axis(btmax_prev), axis)

    hit = mode == _HIT
    # Entry-voxel hits keep the slab entry axis/normal (vv.cpp:159)
    final_axis = torch.where(hit_entry, entry_axis, axis)
    return dict(
        t=torch.where(hit, hit_t, BIG_F32),
        mat=torch.where(hit, hit_mat, 0),
        axis=final_axis,
        step_sign=stepf,
        steps=steps,
        valid=slab_hit,
        entry_axis=entry_axis,
        slab_tmin=tmin,
        slab_tmax=tmax,
        resolved=~(exhausted_any | active(mode)),
    )


def normal_from_axis(axis, step_sign, rot3):
    """World-space hit normal from the last DDA step axis (vv.cpp:161-163).

    axis: (N,) int in [0, 3); step_sign: (N, 3) float +-1; rot3: (3, 3)
    or per-ray (N, 3, 3) local -> world.  The local normal is
    -sign * e_axis, so the world normal is the negated, sign-flipped
    `axis` column of the rotation, normalised."""
    axis = axis.long()
    sign_k = torch.gather(step_sign, -1, axis[..., None])[..., 0]
    if rot3.ndim == 2:
        cols = rot3.T[axis]
    else:
        cols = torch.gather(rot3.transpose(-1, -2), 1,
                            axis[:, None, None].expand(-1, 1, 3))[:, 0, :]
    n_w = -sign_k[..., None] * cols
    n_len = torch.sqrt(torch.sum(n_w * n_w, dim=-1, keepdim=True))
    return n_w / torch.clamp(n_len, min=1e-20)
