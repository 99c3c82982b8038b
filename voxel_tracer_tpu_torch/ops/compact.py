"""Live-ray compaction: run a wavefront stage on only its live subset.

Counterpart of `voxel_tracer_tpu/ops/compact.py`.  The reference's
recursive `eval_material` (materials.cpp:15-48) does no work for
terminated rays; a wavefront pays the full list size at every stage
unless the live set is gathered into a dense short list first.
`masked_apply` is that gather / scatter harness with the JAX function's
signature, so callers carry over line for line.

The JAX version needs static shapes, so it picks a capacity from a bucket
ladder under `lax.switch`.  Eager PyTorch has no such constraint:
`masked_apply` gathers exactly the live rows (`torch.nonzero`, one host
sync for the count), runs the stage at that size, and scatters back; the
``caps`` ladder is accepted and ignored, and a stage with no live row is
not run at all.  Each row's math is unchanged and the stage function
receives each row's original index, so results are bit-equal to the
uncompacted call.
"""

from __future__ import annotations

import torch


def _round_up(n, m):
    return -(-n // m) * m


def bucket_caps(n, fracs=(1 / 16, 1 / 4), multiple=1024):
    """Ascending capacity ladder ending in the full size n (the JAX
    function's; `masked_apply` here ignores it)."""
    caps = sorted({min(_round_up(int(n * f), multiple), n) for f in fracs})
    if not caps or caps[-1] != n:
        caps.append(n)
    return tuple(caps)


def live_indices(mask, cap):
    """Indices of True rows, compacted to ``cap`` slots, padded with n
    (rows past the cap are dropped, as in the JAX function)."""
    n = mask.shape[0]
    idx = torch.nonzero(mask).reshape(-1)[:cap].to(torch.int32)
    out = torch.full((cap,), n, dtype=torch.int32, device=mask.device)
    out[:idx.shape[0]] = idx
    return out


def _map(fn, *trees):
    if isinstance(trees[0], (tuple, list)):
        return type(trees[0])(_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def masked_apply(mask, fn, args, out_fill, caps=None, fill=None):
    """Run ``fn`` on the mask-compacted rows of ``args``.

    mask:     (n,) bool: rows to process.
    fn:       (live_mask, idx, *gathered_args) -> tuple (or tensor) of
              outputs with the gathered row count.  `live_mask` is all
              True here; `idx` (int64) is each row's original index so fn
              can compute per-ray values (noise samples, seeds) directly.
    args:     sequence of (n, ...) tensors gathered per row.
    out_fill: tuple (or tensor) of (n, ...) tensors giving each output's
              value where mask is False.
    caps, fill: accepted for the JAX signature; unused.

    Returns out_fill's structure with fn's outputs scattered into the
    masked rows.
    """
    n = mask.shape[0]
    idx = torch.nonzero(mask).reshape(-1)
    if idx.shape[0] == 0:
        return out_fill
    live = torch.ones(idx.shape[0], dtype=torch.bool, device=mask.device)
    if idx.shape[0] == n:
        return _map(lambda o, r: r.to(o.dtype), out_fill, fn(live, idx, *args))
    res = fn(live, idx, *(a[idx] for a in args))

    def scatter(o, r):
        o = o.clone()
        o[idx] = r.to(o.dtype)
        return o
    return _map(scatter, out_fill, res)
