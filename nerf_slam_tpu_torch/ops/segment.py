"""Segment sums in a fixed order (PyTorch).

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
launches five kernels a call, which matters more to the eager tracker.

The product runs in full f32 under PyTorch's default (TF32 off for f32
matmuls; bf16 blocks are exact in TF32 either way).  Blocks must be
finite: a non-finite block meets the other segments' zero weights and
makes every sum non-finite, where a scatter would keep it in its own
segment.  The tracker's blocks are finite, padded edges included.
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
    return hit.to(torch.float32) @ flat, hit


def segment_sum(x: torch.Tensor, ids: torch.Tensor,
                n_seg: int) -> torch.Tensor:
    """Sum the (E, ...) blocks of ``x`` by segment id in [0, n_seg); ids <
    0 are dropped, empty segments are 0.  Accumulates in f32 and rounds
    once to x's dtype.  Returns (n_seg, ...)."""
    sums, _ = _sums(x, ids, n_seg)
    return sums.to(x.dtype).reshape((n_seg,) + tuple(x.shape[1:]))


def segment_mean(x: torch.Tensor, ids: torch.Tensor,
                 n_seg: int) -> torch.Tensor:
    """Mean of the (E, ...) blocks of ``x`` per segment id in [0, n_seg);
    ids < 0 are dropped, empty segments are 0.  The sum and the division
    by the count are f32, rounded once to x's dtype."""
    sums, hit = _sums(x, ids, n_seg)
    count = torch.clamp(hit.sum(1, keepdim=True), min=1)
    return (sums / count).to(x.dtype).reshape((n_seg,) + tuple(x.shape[1:]))
