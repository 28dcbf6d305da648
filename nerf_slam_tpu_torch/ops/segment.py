"""Segment sums in a fixed order (CUDA kernel + plain PyTorch).

The JAX package pools per-edge blocks by segment id with
``jax.ops.segment_sum`` (the GRU's per-keyframe mean, the assembly of the
reduced camera system), which XLA computes in a fixed order.
``Tensor.index_add_`` adds with atomics on CUDA, in an order that changes
from run to run, and the tracker's discrete decisions (proximity edges,
keyframe rejection) magnify those last-bit differences into different
trajectories.  These sums use no atomics and no process-global switch:
the same inputs give the same bits on every call.

On the card every sum is one launch of ``csrc/segment_sum.cu``: a block
per (segment, column tile) compacts the rows of its segment in ascending
order and adds them in f32 from +0.0 with plain IEEE additions, then
rounds once to the output type (a mean divides once by the count first).
It replaces no TPU kernel; it replaces the plain version's two one-hot
products, whose n_seg x E x F multiply-adds (36 GFLOP a call at the dense
BA's coupling sum) were the tracker's largest device cost.  A wrapper
launches the kernel for CUDA tensors or raises on what the kernel does
not take (device, dtype, shape, contiguity); ``launches`` counts the
launches.  A call with grad goes through :class:`_SegmentSum`, whose
backward is :func:`segment_sum_grad`.

The plain version (:func:`sums_plain`, run for CPU tensors): one f32
matrix product of the (n_seg, E) one-hot of the ids with the (E, F)
blocks.  The products are exact (a block times 1 or 0), so the only
rounding is the f32 accumulation, c += 1 * x or c += 0 * x from +0 in
ascending row order, which on finite blocks is the kernel's chain with
zero terms that change no bits; the result is rounded once.  Full f32
under PyTorch's default (TF32 off for f32 matmuls; bf16 blocks are exact
in TF32 either way).

Non-finite values follow ``jax.ops.segment_sum`` in both.  A row whose
id lies outside [0, n_seg) contributes nothing, NaN and inf included; a
non-finite value in a kept row stays in its own segment and column, with
IEEE addition's result (NaN stays NaN, +inf plus -inf is NaN).  The
kernel gets this from its additions.  In the product a non-finite block
would meet the other segments' zero weights (inf * 0 = NaN) and reach
every segment, so the plain version multiplies the blocks with their
non-finite entries replaced by 0, and a second product of the same
one-hot counts, exactly in f32, the NaN, +inf and -inf entries of each
(segment, column); only the columns with a non-zero count are
overwritten.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import build

launches = {"segment_sum": 0}

# csrc/segment_sum.cu's type codes
_TYPES = {torch.float32: 0, torch.bfloat16: 1}
_VOID, _INT = ctypes.c_void_p, ctypes.c_int
# without argtypes ctypes would pass each pointer as a 32-bit int
_ARGTYPES = [_VOID] * 4 + [_INT, ctypes.c_longlong] + [_INT] * 5 + [_VOID]


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def sums_plain(x: torch.Tensor, ids: torch.Tensor, n_seg: int,
               dtype: torch.dtype, mean: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel: the sums (n_seg, F) of the rows of x
    (E, ...) by id in [0, n_seg) (ids outside it match no segment),
    accumulated in f32, divided by max(count, 1) if ``mean``, rounded once
    to ``dtype``; and the int64 counts (n_seg, 1)."""
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
    count = hit.sum(1, keepdim=True)
    if mean:
        sums = sums / torch.clamp(count, min=1)
    return sums.to(dtype), count


def segment_sum_grad(g: torch.Tensor, x: torch.Tensor, ids: torch.Tensor,
                     n_seg: int, count: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """The gradient w.r.t. x of :func:`sums_plain` (a mean's when its
    ``count`` is given), for the gradient ``g`` (n_seg, ...) of its sums:
    g of the row's segment (over the count) for a kept row, 0 for a
    dropped row, at a non-finite entry of x, and in every (segment,
    column) that holds one (the plain version overwrites those sums).
    Gathers: no atomics.  Shaped and typed as x."""
    flat = x.reshape(x.shape[0], -1)
    g = g.reshape(n_seg, -1).to(torch.float32)
    if count is not None:
        g = g / torch.clamp(count, min=1)
    finite = torch.isfinite(flat)
    poisoned = segment_sum((~finite).to(torch.float32), ids, n_seg) > 0
    g = torch.where(poisoned, 0.0, g)
    kept = ((ids >= 0) & (ids < n_seg))[:, None]
    rows = g[ids.clamp(0, n_seg - 1)]
    return torch.where(kept & finite, rows, 0.0).to(x.dtype).reshape(x.shape)


def _launch(x: torch.Tensor, ids: torch.Tensor, n_seg: int,
            dtype: torch.dtype, mean: bool
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's (n_seg, F) sums in ``dtype`` and int64 counts (n_seg,
    1), on x's device and current stream."""
    if x.device.type != "cuda" or ids.device != x.device:
        raise ValueError("segment sums on the card take x and ids on one "
                         "CUDA device")
    if x.dtype not in _TYPES or dtype not in (x.dtype, torch.float32):
        raise ValueError(f"segment sum kernel takes f32 -> f32, bf16 -> "
                         f"bf16 or bf16 -> f32, not {x.dtype} -> {dtype}")
    if ids.dtype != torch.int64 or ids.dim() != 1 or x.dim() < 1 \
            or ids.shape[0] != x.shape[0]:
        raise ValueError(f"ids must be int64 (E,) for x of shape "
                         f"{tuple(x.shape)}, got {ids.dtype} "
                         f"{tuple(ids.shape)}")
    if not (x.is_contiguous() and ids.is_contiguous()):
        raise ValueError("segment sum kernel takes contiguous x and ids")
    E, F = x.shape[0], math.prod(x.shape[1:])
    if not (0 <= n_seg < 2 ** 31 and E < 2 ** 31):
        raise ValueError(f"n_seg {n_seg} or E {E} out of the kernel's range")
    out = torch.empty((n_seg, F), dtype=dtype, device=x.device)
    count = torch.empty((n_seg, 1), dtype=torch.int64, device=x.device)
    vec = 16 // x.element_size()
    if F % vec or x.data_ptr() % 16:
        vec = 1
    fn = build.load("segment_sum").segment_sum_launch
    fn.argtypes, fn.restype = _ARGTYPES, _INT
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), ids.data_ptr(), out.data_ptr(),
                 count.data_ptr(), E, F, n_seg, _TYPES[x.dtype],
                 _TYPES[dtype], vec, int(mean),
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"segment_sum kernel launch failed: CUDA error "
                           f"{err}")
    launches["segment_sum"] += 1
    return out, count


class _SegmentSum(torch.autograd.Function):
    """The kernel's sums, differentiable in x (:func:`segment_sum_grad`)."""

    @staticmethod
    def forward(ctx, x, ids, n_seg, dtype, mean):
        out, count = _launch(x, ids, n_seg, dtype, mean)
        ctx.save_for_backward(x, ids, count)
        ctx.n_seg, ctx.mean = n_seg, mean
        ctx.mark_non_differentiable(count)
        return out, count

    @staticmethod
    def backward(ctx, g, _):
        x, ids, count = ctx.saved_tensors
        return (segment_sum_grad(g, x, ids, ctx.n_seg,
                                 count if ctx.mean else None),
                None, None, None, None)


def _sums(x: torch.Tensor, ids: torch.Tensor, n_seg: int,
          dtype: torch.dtype, mean: bool
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    if x.device.type == "cpu":
        return sums_plain(x, ids, n_seg, dtype, mean)
    return _SegmentSum.apply(x, ids, n_seg, dtype, mean)


def segment_sum(x: torch.Tensor, ids: torch.Tensor,
                n_seg: int) -> torch.Tensor:
    """Sum the (E, ...) blocks of ``x`` by segment id in [0, n_seg); ids
    outside it are dropped, empty segments are 0.  Accumulates in f32 and
    rounds once to x's dtype.  Returns (n_seg, ...)."""
    sums, _ = _sums(x, ids, n_seg, x.dtype, False)
    return sums.reshape((n_seg,) + tuple(x.shape[1:]))


def segment_sum_count(x: torch.Tensor, ids: torch.Tensor, n_seg: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two halves of :func:`segment_mean` that add across edge shards:
    the f32 sums (n_seg, F) and the int64 counts (n_seg, 1)."""
    return _sums(x, ids, n_seg, torch.float32, False)


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
        sums, _ = _sums(x, ids, n_seg, x.dtype, True)
        return sums.reshape((n_seg,) + tuple(x.shape[1:]))
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
