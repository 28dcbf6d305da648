"""Frozen copy of ``nerf_slam_tpu_torch/ops/segment.py``, the benchmark's plain
reference: later changes to the port do not reach it.

Segment sums in a fixed order (PyTorch).

The JAX package pools per-edge blocks by segment id with
``jax.ops.segment_sum`` (the GRU's per-keyframe mean, the assembly of the
reduced camera system), which XLA computes in a fixed order.
``Tensor.index_add_`` adds with atomics on CUDA, in an order that changes
from run to run, and the tracker's discrete decisions (proximity edges,
keyframe rejection) magnify those last-bit differences into different
trajectories.  These sums use no atomics and no process-global switch:
the same inputs give the same bits on every call.

How: one f32 matrix product of the (n_seg, E) one-hot of the ids with the
(E, F) blocks, each element a fixed sequence of f32 additions.  The
products are exact (a block times 1 or 0), so the only rounding is the
f32 accumulation, and the result is rounded once to the input's dtype.
The work is n_seg x E x F, a few GEMMs per tracker iteration; the host
launches about fifteen kernels a call, which matters more to the eager
tracker.  The product runs in full f32 under PyTorch's default (TF32 off
for f32 matmuls; bf16 blocks are exact in TF32 either way).

Non-finite values follow ``jax.ops.segment_sum``.  A row whose id lies
outside [0, n_seg) contributes nothing, NaN and inf included; a
non-finite value in a kept row stays in its own segment and column, with
IEEE addition's result (NaN stays NaN, +inf plus -inf is NaN).  In the
product a non-finite block would meet the other segments' zero weights
(inf * 0 = NaN) and reach every segment, so the product runs on the
blocks with their non-finite entries replaced by 0 (``torch.where``; on
finite blocks these are the same values, so the same bits as a plain
product), and a second product of the same one-hot counts, exactly in
f32, the NaN, +inf and -inf entries of each (segment, column); only the
columns with a non-zero count are overwritten.
"""
from __future__ import annotations

from typing import Tuple

import torch


def _sums(x: torch.Tensor, ids: torch.Tensor, n_seg: int
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 sums (n_seg, F) and the one-hot (n_seg, E) of the rows of x (E,
    ...) by id in [0, n_seg); ids < 0 (or >= n_seg) match no segment."""
    hit = ids[None, :] == torch.arange(n_seg, device=ids.device)[:, None]
    flat = x.reshape(x.shape[0], -1).to(torch.float32)
    onehot = hit.to(torch.float32)
    sums = onehot @ torch.where(torch.isfinite(flat), flat, 0.0)
    inf = float("inf")
    counts = onehot @ torch.cat([torch.isnan(flat), flat == inf,
                                 flat == -inf], dim=1).to(torch.float32)
    n_nan, n_pos, n_neg = (c > 0 for c in counts.split(flat.shape[1], 1))
    sums = torch.where(n_pos, inf, torch.where(n_neg, -inf, sums))
    sums = torch.where(n_nan | (n_pos & n_neg), float("nan"), sums)
    return sums, hit


def segment_sum(x: torch.Tensor, ids: torch.Tensor,
                n_seg: int) -> torch.Tensor:
    """Sum the (E, ...) blocks of ``x`` by segment id in [0, n_seg); ids
    outside it are dropped, empty segments are 0.  Accumulates in f32 and
    rounds once to x's dtype.  Returns (n_seg, ...)."""
    sums, _ = _sums(x, ids, n_seg)
    return sums.to(x.dtype).reshape((n_seg,) + tuple(x.shape[1:]))


def segment_sum_count(x: torch.Tensor, ids: torch.Tensor, n_seg: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two halves of :func:`segment_mean` that add across edge shards:
    the f32 sums (n_seg, F) and the int64 counts (n_seg, 1)."""
    sums, hit = _sums(x, ids, n_seg)
    return sums, hit.sum(1, keepdim=True)


def mean_from_sums(sums: torch.Tensor, count: torch.Tensor,
                   like: torch.Tensor) -> torch.Tensor:
    """sums / count (empty segments 0), rounded once to ``like``'s dtype
    and shaped as its blocks: (n_seg,) + like.shape[1:]."""
    return (sums / torch.clamp(count, min=1)).to(like.dtype).reshape(
        (count.shape[0],) + tuple(like.shape[1:]))


def segment_mean(x, ids, n_seg: int) -> torch.Tensor:
    """Mean of the (E, ...) blocks of ``x`` per segment id in [0, n_seg);
    ids outside it are dropped, empty segments are 0.  The sum and the
    division by the count are f32, rounded once to x's dtype.  ``x`` and
    ``ids`` may be lists, one an edge shard: the shards' sums and counts
    are then reduced (:func:`reduce_in_order`, on the first shard's
    device) before the one division."""
    if isinstance(x, torch.Tensor):
        return mean_from_sums(*segment_sum_count(x, ids, n_seg), x)
    sums, count = reduce_in_order(
        [segment_sum_count(a, i, n_seg) for a, i in zip(x, ids)],
        x[0].device)
    return mean_from_sums(sums, count, x[0])


def reduce_in_order(parts, device) -> tuple:
    """Sum equal-shaped tuples of tensors, one a shard, on ``device``: the
    first shard's values plus each next shard's, in shard order, so a
    given shard count always gives the same bits."""
    out = [t.to(device) for t in parts[0]]
    for part in parts[1:]:
        out = [a + b.to(device) for a, b in zip(out, part)]
    return tuple(out)
