"""The benchmark's fixed arithmetic: the card's data-sheet peaks, the
percentile, the union of device intervals, and the least bytes a
correlation lookup needs.

The peaks are NVIDIA's data sheet for the H100 SXM (the 80GB HBM3 card),
dense rates without sparsity, at its full 700 W; a run states the card's
name and power limit beside every share.  The union is the device
busy-time arithmetic of ``scripts/profile_torch_main_path.py``; the tap
count is ``chip_smoke.py``'s ``support_window`` / ``support_taps``.
"""
from __future__ import annotations

import math
from typing import Iterable, Optional, Sequence, Tuple

import torch

# name -> peaks: FLOP/s by compute dtype, bytes/s of HBM
PEAKS = {"H100 80GB HBM3": {"bf16": 989e12, "fp16": 989e12,
                            "tf32": 495e12, "f32": 67e12,
                            "hbm_bytes_s": 3.35e12}}


def peaks(device_name: str) -> Optional[dict]:
    """The data-sheet peaks of the card named ``device_name`` (a
    substring match, so "NVIDIA H100 80GB HBM3" finds its entry), or None
    for a card the table lacks."""
    for key, p in PEAKS.items():
        if key in device_name:
            return p
    return None


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile: the smallest value with at least q% of the
    values at or below it."""
    if not values:
        raise ValueError("percentile of no values")
    s = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(s)))
    return s[rank - 1]


def union_length(intervals: Iterable[Tuple[float, float]]) -> float:
    """Total length covered by the (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def gaps(intervals: Iterable[Tuple[float, float]], lo: float, hi: float):
    """The uncovered (start, end) stretches of [lo, hi]."""
    out, cur = [], lo
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(s, e) for s, e in out if e > s]


# ---------------------------------------------------------------------------
# correlation lookups: the bytes these inputs need
# ---------------------------------------------------------------------------

NSUP = 8          # support taps a window axis (radius 3, plus one)
RADIUS = 3


def support_window(c: torch.Tensor, real: Tuple[int, int],
                   slab: Tuple[int, int], scale: float):
    """The in-bounds part [x_lo, x_hi) x [y_lo, y_hi) of each pixel's 8x8
    tap support at one level: coords ``c`` (..., 2) in level-0 units, the
    level's real (h, w) and its stored (rows, cols)."""
    h_real, w_real = real
    cl = c / scale
    fx = torch.floor(cl[..., 0]) - RADIUS
    fy = torch.floor(cl[..., 1]) - RADIUS
    x_lo = torch.clamp(fx, min=0)
    x_hi = torch.clamp(fx + NSUP, max=min(w_real, slab[1]))
    y_lo = torch.clamp(fy, min=0)
    y_hi = torch.clamp(fy + NSUP, max=min(h_real, slab[0]))
    return x_lo, x_hi, y_lo, y_hi


def support_taps(c: torch.Tensor, real_dims, slab_dims,
                 scales=(1.0, 2.0, 4.0, 8.0)) -> float:
    """In-bounds taps of the 8x8 supports around coords ``c`` (double),
    summed over pixels and levels."""
    total = 0.0
    for real, slab, s in zip(real_dims, slab_dims, scales):
        x_lo, x_hi, y_lo, y_hi = support_window(c, real, slab, s)
        nx = torch.clamp(x_hi - x_lo, min=0)
        ny = torch.clamp(y_hi - y_lo, min=0)
        total += float((nx * ny).sum())
    return total


def lookup_bytes(coords: torch.Tensor, n_act: int, real_dims, slab_dims,
                 out_bytes_per_value: int, tap_bytes: int = 2) -> float:
    """Least bytes of one four-level lookup: each active (edge, pixel,
    level) reads the in-bounds part of its 8x8 tap support once, each
    active pixel its 8-byte coords, and the output (196 values a pixel of
    every slot, zeros included) is written once."""
    c = coords[:n_act].double()
    n_pix = c.shape[0] * c.shape[1] * c.shape[2]
    taps = support_taps(c, real_dims, slab_dims)
    out = coords.shape[0] * coords.shape[1] * coords.shape[2] * 196
    return taps * tap_bytes + n_pix * 8 + out * out_bytes_per_value


def conv_flops(cin: int, cout: int, k: int, h_out: int, w_out: int) -> float:
    """Multiply-adds of a dense 2-D convolution, counted as 2 FLOPs."""
    return 2.0 * cin * cout * k * k * h_out * w_out
