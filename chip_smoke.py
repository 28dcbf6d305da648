"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``nerf_slam_tpu_torch/ops/csrc``,
checks each against its plain PyTorch version at the tracking shapes of
the 336x640 production cell, times it beside its bound (counted in
elements and in 32-byte sectors) and, for the two one-level kernels,
beside one ``F.grid_sample`` call that computes the same function, then
drives the main path end to end: synthetic frames -> DataModule ->
SlamModule (RaftVisualFrontend, trained weights, motion filter 2.4 px,
keyframe rejection 4.0) -> FusionModule (PE-NeRF) -> EvalSink, as
``bench.py`` configures it.  One sequential run gives the quality numbers
(ATE-RMSE, PSNR after 2000 NGP iterations, as QUALITY.md measures them);
one threaded run, with the launch counters zeroed just before it, gives
keyframes/s and shows that the main path went through its kernels.  The
tracker is bit-reproducible: it then runs the same frames once more,
alone and sequentially on fresh state, and the keyframe list, every pose
and every depth map must equal the sequential run's to the bit.

Then the tracker's other lookup configurations, tracking without mapping
(DataModule -> SlamModule -> EvalSink), same weights and thresholds, the
counters zeroed before each: (a) ``corr_impl="pallas"`` with the sparse
Schur solve and global BA at the end, (b) ``corr_impl="pallas_grouped"``,
(c) the same on 336x600 frames, whose feature width 75 is no multiple of
16, where the lookup goes to the single-level kernel.

Output, in order: the card's name and power limit, the kernel build time,
one line per kernel check, the pipeline and path lines, the ``kernels``
JSON line, and last ``{"ok": true, "device": {...}}``.  Any failure exits non-zero
without the ``ok`` line.  Needs a CUDA device; imports no JAX.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# bench.py:36-41, 89-96 -- the 336x640 production cell
H, W, N_FRAMES, BUFFER = 336, 640, 30, 24
E_ACTIVE = 48
N_ACT = 36                  # active edge slots in the gated kernel check
W_ODD = 600                 # path (c): feature width 75, not a multiple of 16
NGP_HORIZON = 2000          # QUALITY.md: NGP iterations before PSNR
ATE_LIMIT_M = 0.25          # QUALITY.md 0.1835 m; random weights ~0.79 m
SEED = 0

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 (non-tensor) flop/s
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12
SLEEP_CYCLES = 40_000_000   # about 20 ms of device sleep ahead of a timing

# kernel vs plain version: both evaluate the same f32 operations in the
# same order with round-to-nearest and no fused multiply-add, so they
# should agree bit for bit; the limits allow one ulp of the output type at
# the volumes' magnitude (|v| < 4): bf16 1.6e-2, f32 1e-5
TOL_BF16, TOL_F32 = 1.6e-2, 1e-5
# the library yardstick of the one-level kernels, F.grid_sample, takes its
# grid in the volume's type: in bf16 the sampling positions themselves are
# rounded (to 2^-8 of the half width, up to 0.08 px at width 80, on volumes
# whose neighbouring taps differ by several units) and so are its weights,
# hence the loose limit; on an f32 copy of the volume with an f32 grid
# only the position arithmetic's f32 rounding (about 1e-5 px) is left
TOL_LIB_BF16, TOL_LIB_F32 = 1.0, 2e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 30, warmup: int = 5) -> float:
    """Mean device time of one call.  ``reps`` calls are queued back to
    back behind a device-side sleep and timed as one span with CUDA events,
    so the host's cost per launch (tens of microseconds, more than some of
    these kernels take) stays out of the span while the device is busy."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def support_window(c, real, slab, s):
    """In-bounds part [x_lo, x_hi) x [y_lo, y_hi) of the 8x8 support around
    coords ``c`` (double) at a level of scale ``s``, in that level's taps
    (empty where hi <= lo)."""
    (hr, wr), (hs, ws) = real, slab
    h_ok = torch.tensor(float(min(hr, hs)), device=c.device)
    w_ok = torch.tensor(float(min(wr, ws)), device=c.device)
    xi = torch.clamp(torch.floor(c[..., 0] / s) - 3, -8, wr + 8)
    yi = torch.clamp(torch.floor(c[..., 1] / s) - 3, -8, hr + 8)
    return (torch.clamp(xi, min=0), torch.minimum(xi + 8, w_ok),
            torch.clamp(yi, min=0), torch.minimum(yi + 8, h_ok))


def support_taps(c, real_dims, slab_dims, scales, block=False):
    """In-bounds taps of the 8x8 supports around coords ``c`` (double),
    summed over pixels and levels.  ``block``: each level-l tap stands for
    its 2^l x 2^l level-0 block and the levels share one plane, so a pixel
    needs the largest of its levels' regions, in level-0 elements."""
    total, per_pixel = 0.0, None
    for real, slab, s in zip(real_dims, slab_dims, scales):
        x_lo, x_hi, y_lo, y_hi = support_window(c, real, slab, s)
        nx = torch.clamp(x_hi - x_lo, min=0)
        ny = torch.clamp(y_hi - y_lo, min=0)
        if block:
            n = nx * ny * s * s
            per_pixel = n if per_pixel is None else torch.maximum(per_pixel,
                                                                  n)
        else:
            total += float((nx * ny).sum())
    return float(per_pixel.sum()) if block else total


def rect_sectors(slab, x_lo, x_hi, y_lo, y_hi, max_rows):
    """32-byte sectors under the rows [y_lo, y_hi) x columns [x_lo, x_hi)
    of each pixel's bf16 (hs, ws) plane (int64 tensors over the pixels, a
    32-byte aligned base), summed over the pixels: rows lie at rising
    addresses, so a sector shared by two rows counts once."""
    hs, ws = slab
    pix = torch.arange(x_lo.numel(), device=x_lo.device).reshape(x_lo.shape)
    total = torch.zeros_like(pix)
    prev_last = torch.full_like(pix, -1)
    for r in range(max_rows):
        y = y_lo + r
        ok = (y < y_hi) & (x_hi > x_lo)
        row = (pix * hs + y) * ws
        first = torch.maximum((row + x_lo) * 2 // 32, prev_last + 1)
        last = ((row + x_hi) * 2 - 1) // 32
        total += torch.where(ok, torch.clamp(last - first + 1, min=0), 0)
        prev_last = torch.where(ok, last, prev_last)
    return int(total.sum())


def support_sectors(c, real_dims, slab_dims, scales, block=False):
    """:func:`support_taps` counted as DRAM moves it, in 32-byte sectors.
    ``block``: the sectors under the largest of the pixel's level regions
    of the level-0 plane (the same region whose elements support_taps
    counts)."""
    wins = [[t.long() for t in support_window(c, real, slab, s)]
            for real, slab, s in zip(real_dims, slab_dims, scales)]
    if not block:
        return sum(rect_sectors(slab, *w, 8)
                   for slab, w in zip(slab_dims, wins))
    rects = torch.stack([torch.stack(w) * int(s)
                         for w, s in zip(wins, scales)])    # (L, 4, pixels..)
    area = (torch.clamp(rects[:, 1] - rects[:, 0], min=0)
            * torch.clamp(rects[:, 3] - rects[:, 2], min=0))
    best = area.argmax(dim=0)
    x_lo, x_hi, y_lo, y_hi = (torch.gather(rects[:, i], 0, best[None])[0]
                              for i in range(4))
    return rect_sectors(slab_dims[0], x_lo, x_hi, y_lo, y_hi,
                        8 * int(max(scales)))


def lookup_traffic(coords, real_dims, slab_dims, out, n_act,
                   flops_per_tap_row, scales=(1.0, 2.0, 4.0, 8.0),
                   block=False):
    """Least bytes and flops of one lookup call on these inputs.

    Bytes: each active (edge, pixel, level) reads the in-bounds part of
    its 8x8 bf16 tap support once (``block``: the level-0 region its
    levels share), plus its 8-byte coords; the whole output is written
    once.  Flops: the interpolation arithmetic per (active pixel-edge,
    level, window row), plus one add per element of a block sum.  The
    third value counts the same reads in whole 32-byte sectors."""
    c = coords[:n_act].double()
    taps = support_taps(c, real_dims, slab_dims, scales, block)
    n_pix = c.shape[0] * c.shape[1] * c.shape[2]
    fixed = n_pix * 8 + out.numel() * out.element_size()
    flops = n_pix * len(scales) * 7 * flops_per_tap_row
    if block:
        flops += taps
    sectors = support_sectors(c, real_dims, slab_dims, scales, block)
    return taps * 2 + fixed, flops, sectors * 32 + fixed


def bound(nbytes: float, flops: float):
    t_b, t_f = nbytes / PEAK_BYTES_S, flops / PEAK_F32_FLOPS
    return 1e3 * max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")


def library_level(vol, cl, want):
    """One ``F.grid_sample`` call computing the one-level lookup (bilinear,
    zeros outside, align_corners): the volume viewed as (E*H1*W1, 1, H2,
    W2), a (E*H1*W1, 7, 7, 2) grid of the window's positions, built outside
    the timed span.  Timed on the bf16 volume as stored; checked against
    the plain version's result there and on an f32 copy.  The port never
    calls it.  Returns (ms, max |err| bf16, max |err| f32)."""
    import torch.nn.functional as F
    E, H1, W1, H2, W2 = vol.shape
    n = E * H1 * W1
    offs = torch.arange(-3, 4, device=vol.device, dtype=torch.float32)
    c = cl.reshape(n, 1, 1, 2)
    # grid[n, a, b] = (x + a - 3, y + b - 3): output [a, b], channel a*7 + b
    gx = (c[..., 0] + offs[None, :, None]).expand(n, 7, 7)
    gy = (c[..., 1] + offs[None, None, :]).expand(n, 7, 7)
    grid = torch.stack([2 * gx / (W2 - 1) - 1, 2 * gy / (H2 - 1) - 1], -1)
    vol4 = vol.reshape(n, 1, H2, W2)

    def call(v, g):
        return F.grid_sample(v, g, mode="bilinear", padding_mode="zeros",
                             align_corners=True)

    errs = []
    for v, g in ((vol4, grid.to(torch.bfloat16)), (vol4.float(), grid)):
        got = call(v, g).reshape(E, H1, W1, 49).float()
        errs.append(float((got - want).abs().max()))
        del got, v
    for err, tol in zip(errs, (TOL_LIB_BF16, TOL_LIB_F32)):
        if not math.isfinite(err) or err > tol:
            raise RuntimeError(f"grid_sample differs from the plain lookup: "
                               f"max |err| {err} > {tol}")
    g16 = grid.to(torch.bfloat16)
    return time_ms(lambda: call(vol4, g16), reps=10, warmup=2), *errs


def kernel_phase(dev):
    """Each kernel against its plain version at the main path's shapes,
    timed beside its bound.  Returns the ``kernels`` entries."""
    from nerf_slam_tpu_torch.geometry import camera
    from nerf_slam_tpu_torch.ops import corr, corr_lookup

    g = torch.Generator(device=dev).manual_seed(SEED)
    h, w = H // 8, W // 8
    grid = camera.coords_grid(h, w, device=dev)

    def feats(e):
        return torch.randn((e, 128, h, w), generator=g, device=dev)

    def flowed(e, sigma):
        return (grid[None] + sigma * torch.randn((e, h, w, 2), generator=g,
                                                 device=dev)).contiguous()

    entries = []
    # kernel #1: the update loop's lookup from pooled, row-padded slabs
    slabs = corr.build_pyramid_bf16(feats(E_ACTIVE), feats(E_ACTIVE), 4,
                                    pad_rows_to=8)
    coords = flowed(E_ACTIVE, 3.0)
    dims = corr_lookup.pyramid_dims(h, w)
    slab_dims = [tuple(s.shape[-2:]) for s in slabs]
    n_act = torch.tensor([N_ACT], dtype=torch.int32, device=dev)
    res = {}
    for gated in (True, False):
        na = n_act if gated else None
        got = corr_lookup.lookup_pyramid_grouped4(slabs, coords, dims, na)
        want = corr_lookup.lookup_pyramid_grouped4_plain(slabs, coords, dims,
                                                         na)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        tol = TOL_BF16 if gated else TOL_F32
        if gated and not bool((got[N_ACT:] == 0).all()):
            raise RuntimeError("gated lookup: padded slots are not zero")
        if not math.isfinite(err) or err > tol:
            raise RuntimeError(f"grouped4 (gated={gated}) differs from its "
                               f"plain version: max |err| {err} > {tol}")
        ms = time_ms(lambda: corr_lookup.lookup_pyramid_grouped4(
            slabs, coords, dims, na))
        plain_ms = time_ms(lambda: corr_lookup.lookup_pyramid_grouped4_plain(
            slabs, coords, dims, na), reps=20, warmup=2)
        nb, fl, nb_sec = lookup_traffic(coords, dims, slab_dims, got,
                                        N_ACT if gated else E_ACTIVE, 45)
        b_ms, b_by = bound(nb, fl)
        bs_ms = bound(nb_sec, fl)[0]
        res[gated] = dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                          bound_by=b_by, bytes=nb, bound_sector_ms=bs_ms)
        log(f"kernel corr_lookup_grouped4 gated={gated} E={E_ACTIVE} "
            f"n_act={N_ACT if gated else E_ACTIVE} {h}x{w}: max|err| {err:.3g}"
            f" (tol {tol}) {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}, {nb / 1e6:.1f} MB), in 32-byte sectors "
            f"{bs_ms:.4f} ms ({nb_sec / 1e6:.1f} MB)")
    del slabs
    r = res[True]
    entries.append({
        "name": "corr_lookup_grouped4", "route": "cuda",
        "source": "nerf_slam_tpu_torch/ops/csrc/corr_lookup.cu",
        "replaces": "nerf_slam_tpu/ops/corr_pallas.py:500",
        "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "library_ms": None, "bound_sector_ms": r["bound_sector_ms"],
        "ungated": {k: res[False][k] for k in
                    ("err", "ms", "plain_ms", "bound_ms",
                     "bound_sector_ms")}})

    # kernel #2: the motion filter's lookup from unpadded levels (E = 1)
    levels = [lv.to(torch.bfloat16).contiguous() for lv in
              corr.build_pyramid(corr.build_volume(feats(1), feats(1)))]
    coords = flowed(1, 3.0)
    got = corr_lookup.lookup_pyramid(levels, coords)
    want = corr_lookup.lookup_pyramid_plain(levels, coords)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not math.isfinite(err) or err > TOL_F32:
        raise RuntimeError(f"pyramid lookup differs from its plain version: "
                           f"max |err| {err} > {TOL_F32}")
    ms = time_ms(lambda: corr_lookup.lookup_pyramid(levels, coords))
    plain_ms = time_ms(lambda: corr_lookup.lookup_pyramid_plain(
        levels, coords), reps=20, warmup=2)
    lv_dims = [tuple(v.shape[-2:]) for v in levels]
    nb, fl, nb_sec = lookup_traffic(coords, lv_dims, lv_dims, got, 1, 49)
    b_ms, b_by = bound(nb, fl)
    bs_ms = bound(nb_sec, fl)[0]
    log(f"kernel corr_lookup_pyramid E=1 {h}x{w}: max|err| {err:.3g} (tol "
        f"{TOL_F32}) {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} "
        f"ms ({b_by}, {nb / 1e6:.2f} MB), in 32-byte sectors {bs_ms:.4f} ms "
        f"({nb_sec / 1e6:.2f} MB)")
    entries.append({
        "name": "corr_lookup_pyramid", "route": "cuda",
        "source": "nerf_slam_tpu_torch/ops/csrc/corr_lookup.cu",
        "replaces": "nerf_slam_tpu/ops/corr_pallas.py:165",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "bound_sector_ms": bs_ms})
    del levels

    # kernels #3 and #5: one stored level per launch, coords in level
    # units, once per level shape of their paths: #5 on the row-padded
    # slabs of the 336x640 tracker, #3 on those of the 336x600 tracker
    # (where corr_impl="pallas_grouped" sends the lookup to it)
    for name, fn, plain, wf, line in (
            ("corr_lookup_level", corr_lookup.lookup_level,
             corr_lookup.lookup_level_plain, W_ODD // 8, 767),
            ("corr_lookup_level_grouped", corr_lookup.lookup_level_grouped,
             corr_lookup.lookup_level_grouped_plain, w, 699)):
        f1 = torch.randn((E_ACTIVE, 128, h, wf), generator=g, device=dev)
        f2 = torch.randn((E_ACTIVE, 128, h, wf), generator=g, device=dev)
        slabs = corr.build_pyramid_bf16(f1, f2, 4, pad_rows_to=8)
        del f1, f2
        coords = (camera.coords_grid(h, wf, device=dev)[None] + 3.0
                  * torch.randn((E_ACTIVE, h, wf, 2), generator=g,
                                device=dev))
        per = []
        for lvl, vol in enumerate(slabs):
            cl = (coords / 2 ** lvl).contiguous()
            got, want = fn(vol, cl), plain(vol, cl)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if not math.isfinite(err) or err > TOL_F32:
                raise RuntimeError(f"{name} level {lvl} differs from its "
                                   f"plain version: max |err| {err} > "
                                   f"{TOL_F32}")
            ms = time_ms(lambda: fn(vol, cl))
            plain_ms = time_ms(lambda: plain(vol, cl), reps=20, warmup=2)
            lib_ms, lib_err, lib_err_f32 = library_level(vol, cl, want)
            sd = [tuple(vol.shape[-2:])]
            nb, fl, nb_sec = lookup_traffic(cl, sd, sd, got, E_ACTIVE, 49,
                                            scales=(1.0,))
            b_ms, b_by = bound(nb, fl)
            bs_ms = bound(nb_sec, fl)[0]
            per.append(dict(shape=list(sd[0]), err=err, ms=ms,
                            plain_ms=plain_ms, bound_ms=b_ms, bytes=nb,
                            flops=fl, sector_bytes=nb_sec,
                            bound_sector_ms=bs_ms, library_ms=lib_ms))
            log(f"kernel {name} E={E_ACTIVE} {h}x{wf} level {lvl} "
                f"{sd[0][0]}x{sd[0][1]}: max|err| {err:.3g} (tol {TOL_F32}) "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
                f"({b_by}, {nb / 1e6:.1f} MB), in 32-byte sectors "
                f"{bs_ms:.4f} ms ({nb_sec / 1e6:.1f} MB), library "
                f"(grid_sample, bf16) {lib_ms:.4f} ms, its max|err| "
                f"{lib_err:.3g} (tol {TOL_LIB_BF16}), on the f32 volume "
                f"{lib_err_f32:.3g} (tol {TOL_LIB_F32})")
        del slabs
        # per launch: the mean over the four level shapes of one lookup
        fl_mean = sum(p["flops"] for p in per) / 4
        b_ms, b_by = bound(sum(p["bytes"] for p in per) / 4, fl_mean)
        bs_ms = bound(sum(p["sector_bytes"] for p in per) / 4, fl_mean)[0]
        entries.append({
            "name": name, "route": "cuda",
            "source": "nerf_slam_tpu_torch/ops/csrc/corr_lookup.cu",
            "replaces": f"nerf_slam_tpu/ops/corr_pallas.py:{line}",
            "max_abs_err": max(p["err"] for p in per),
            "ms": sum(p["ms"] for p in per) / 4,
            "plain_ms": sum(p["plain_ms"] for p in per) / 4,
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": sum(p["library_ms"] for p in per) / 4,
            "bound_sector_ms": bs_ms,
            "per_level": [{k: p[k] for k in ("shape", "ms", "plain_ms",
                                             "bound_ms", "bound_sector_ms",
                                             "library_ms")}
                          for p in per]})

    # kernel #4: four levels from the row-padded level-0 slab alone
    vol0 = corr.build_pyramid_bf16(feats(E_ACTIVE), feats(E_ACTIVE), 1,
                                   pad_rows_to=8)[0]
    coords = flowed(E_ACTIVE, 3.0)
    got = corr_lookup.lookup_pyramid_l0(vol0, coords, dims)
    want = corr_lookup.lookup_pyramid_l0_plain(vol0, coords, dims)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    del want
    if not math.isfinite(err) or err > TOL_F32:
        raise RuntimeError(f"level-0 lookup differs from its plain version: "
                           f"max |err| {err} > {TOL_F32}")
    ms = time_ms(lambda: corr_lookup.lookup_pyramid_l0(vol0, coords, dims),
                 reps=10, warmup=2)
    plain_ms = time_ms(lambda: corr_lookup.lookup_pyramid_l0_plain(
        vol0, coords, dims), reps=3, warmup=1)
    sd0 = [tuple(vol0.shape[-2:])] * 4
    nb, fl, nb_sec = lookup_traffic(coords, dims, sd0, got, E_ACTIVE, 49,
                                    block=True)
    b_ms, b_by = bound(nb, fl)
    bs_ms = bound(nb_sec, fl)[0]
    log(f"kernel corr_lookup_l0 E={E_ACTIVE} {h}x{w} slab "
        f"{sd0[0][0]}x{sd0[0][1]}: max|err| {err:.3g} (tol {TOL_F32}) "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
        f"{nb / 1e6:.1f} MB), in 32-byte sectors {bs_ms:.4f} ms "
        f"({nb_sec / 1e6:.1f} MB)")
    entries.append({
        "name": "corr_lookup_l0", "route": "cuda",
        "source": "nerf_slam_tpu_torch/ops/csrc/corr_lookup.cu",
        "replaces": "nerf_slam_tpu/ops/corr_pallas.py:282",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "bound_sector_ms": bs_ms})
    return entries


def build_frontend(dev, width: int = W, **extra):
    """The tracker as bench.py configures its production cell; ``extra``
    overrides ``FrontendConfig`` fields."""
    from nerf_slam_tpu_torch.models import DroidNet, load_flax_weights
    from nerf_slam_tpu_torch.tracking import (FrontendConfig,
                                              RaftVisualFrontend)
    from nerf_slam_tpu_torch.utils.checkpoint import load_arrays

    flat, meta = load_arrays(os.path.join(ROOT, "weights_synthetic.npz"))
    net = load_flax_weights(DroidNet(dtype=torch.bfloat16), flat)
    cfg = FrontendConfig(**{**dict(
        buffer=BUFFER, e_active=E_ACTIVE, e_inactive=E_ACTIVE,
        p_window=BUFFER, k_depth=BUFFER + 4, motion_filter_thresh=2.4,
        keyframe_thresh=4.0, damping_scale=float(meta["damping_scale"]),
        damping_offset=float(meta["damping_offset"])), **extra})
    return RaftVisualFrontend(net, cfg, (H, width), device=dev)


def build_main_path(dev):
    """Frontend and fusion as bench.py builds its production cell."""
    from nerf_slam_tpu_torch.fusion import NerfFusion, NerfFusionConfig

    fusion = NerfFusion(NerfFusionConfig(buffer=BUFFER, height=H, width=W,
                                         batch_rays=4096, iters_per_spin=10),
                        seed=SEED, device=dev)
    return build_frontend(dev), fusion


def run_pipeline(frames, frontend, fusion, parallel: bool):
    """One pass over ``frames`` on fresh state; returns (wall s, sink)."""
    from nerf_slam_tpu_torch.pipeline import (DataModule, EvalSink,
                                              FusionModule, SlamModule,
                                              connect, run_parallel,
                                              run_sequential)
    frontend.reset()
    fusion.reset()
    data, slam = DataModule(frames), SlamModule(frontend)
    fuse, sink = FusionModule(fusion, extra_spins_after_done=5), EvalSink()
    connect(data, slam, "data")
    connect(slam, sink, "slam")
    connect(slam, fuse, "slam")
    modules = [data, slam, fuse, sink]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if parallel:
        run_parallel(modules, timeout_s=600.0)
    else:
        run_sequential(modules)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not (frontend.stop and fuse.done):
        raise RuntimeError("the pipeline did not run to its end")
    if sink.last_full is None:
        raise RuntimeError("the pipeline produced no keyframe packet")
    return wall, sink


def trajectory_error(sink) -> float:
    from nerf_slam_tpu_torch.utils.evaluation import (ate_rmse,
                                                      trajectory_from_packet)
    est, gt = trajectory_from_packet(sink.last_full)
    if est.shape[0] < 3 or not np.isfinite(est).all():
        raise RuntimeError(f"bad trajectory: {est.shape[0]} poses, finite="
                           f"{bool(np.isfinite(est).all())}")
    return ate_rmse(est, gt)


def tracker_result(frontend):
    """What a tracking run decided and estimated: the keyframes' frame
    timestamps, their poses and inverse depths (host copies)."""
    n, st = frontend.kf_idx + 1, frontend.state
    return (st.timestamps[:n].cpu(), st.cam_T_world[:n].cpu(),
            st.idepths[:n].cpu())


def same_bits(a, b) -> bool:
    return all(x.shape == y.shape and torch.equal(x, y) for x, y in zip(a, b))


def pipeline_phase(dev):
    from nerf_slam_tpu_torch.ops import corr_lookup

    frames = synthetic_frames(W)
    frontend, fusion = build_main_path(dev)

    # quality: the sequential run QUALITY.md's protocol uses
    wall, sink = run_pipeline(frames, frontend, fusion, parallel=False)
    ate_seq = trajectory_error(sink)
    n_kf_seq = frontend.kf_idx + 1
    first = tracker_result(frontend)
    t0 = time.perf_counter()
    fusion.fit_volume(max(0, NGP_HORIZON - fusion.iteration))
    row = fusion.evaluate_training_views(max_views=8)
    fit_s = time.perf_counter() - t0
    if row is None or not math.isfinite(row["psnr"]):
        raise RuntimeError(f"bad evaluation row {row}")
    log(f"pipeline sequential (untimed): {n_kf_seq} keyframes of "
        f"{N_FRAMES} frames in {wall:.2f} s, ATE-RMSE {ate_seq:.4f} m")
    log(f"quality: PSNR {row['psnr']:.2f} dB, depth L1 "
        f"{row['depth_l1_cm']:.2f} cm (scale-aligned "
        f"{row['depth_l1_aligned_cm']:.2f} cm) after {fusion.iteration} NGP "
        f"iterations, 8 training views (fit+eval {fit_s:.1f} s)")

    # speed: the threaded run bench.py times; counters zeroed just before
    corr_lookup.reset_launches()
    wall, sink = run_pipeline(frames, frontend, fusion, parallel=True)
    launches = dict(corr_lookup.launches)
    ate = trajectory_error(sink)
    n_kf = frontend.kf_idx + 1
    log(f"pipeline threaded (timed): {n_kf / wall:.4f} keyframes/s, {n_kf} "
        f"keyframes of {N_FRAMES} frames in {wall:.3f} s, ATE-RMSE "
        f"{ate:.4f} m, {fusion.iteration} NGP iterations")
    log(f"launches on the main path: {launches}")
    threaded_same = same_bits(first, tracker_result(frontend))
    missing = [k for k in ("corr_lookup_grouped4", "corr_lookup_pyramid")
               if launches[k] <= 0]
    if missing:
        raise RuntimeError(f"kernels not launched on the main path: "
                           f"{missing}")
    for name, a in (("sequential", ate_seq), ("threaded", ate)):
        if not a <= ATE_LIMIT_M:
            raise RuntimeError(f"{name} ATE-RMSE {a:.4f} m > {ATE_LIMIT_M}")

    # reproducibility: the same tracker, alone and sequential, fresh state
    del frontend, fusion, sink
    torch.cuda.empty_cache()
    frontend, _, wall, _ = track_only(dev, frames, W, {})
    again = tracker_result(frontend)
    kf_frames = [int(round(float(t) * 30)) for t in first[0]]
    log(f"reproducibility: tracker alone on fresh state {wall:.2f} s, "
        f"{again[0].numel()} keyframes (first run {kf_frames}); keyframes, "
        f"poses and depths bit-identical to the sequential run: "
        f"{same_bits(first, again)}; the threaded run's too: "
        f"{threaded_same}")
    if not same_bits(first, again):
        raise RuntimeError("the tracker is not reproducible: a second "
                           "sequential run on fresh state changed the "
                           "keyframes, the poses or the depths")
    return launches


def synthetic_frames(width: int):
    from nerf_slam_tpu_torch.datasets import SyntheticConfig, SyntheticDataset
    ds = SyntheticDataset(SyntheticConfig(n_frames=N_FRAMES, height=H,
                                          width=width))
    return [ds[k] for k in range(len(ds))]


# the tracker's other configurations: (tag, frame width, FrontendConfig
# overrides, the counter that must move, counters that must stay 0)
PATHS = (
    ("a", W, dict(corr_impl="pallas", schur_impl="sparse", global_ba=True),
     "corr_lookup_l0",
     ("corr_lookup_grouped4", "corr_lookup_level",
      "corr_lookup_level_grouped")),
    ("b", W, dict(corr_impl="pallas_grouped"), "corr_lookup_level_grouped",
     ("corr_lookup_grouped4", "corr_lookup_l0", "corr_lookup_level")),
    ("c", W_ODD, dict(corr_impl="pallas_grouped"), "corr_lookup_level",
     ("corr_lookup_grouped4", "corr_lookup_l0",
      "corr_lookup_level_grouped")),
)


def track_only(dev, frames, width: int, extra: dict):
    """One sequential tracking run without mapping (DataModule ->
    SlamModule -> EvalSink) on a fresh tracker; the launch counters are
    zeroed just before it.  Returns (frontend, sink, wall s, launches)."""
    from nerf_slam_tpu_torch.ops import corr_lookup
    from nerf_slam_tpu_torch.pipeline import (DataModule, EvalSink,
                                              SlamModule, connect,
                                              run_sequential)
    frontend = build_frontend(dev, width, **extra)
    data, slam, sink = DataModule(frames), SlamModule(frontend), EvalSink()
    connect(data, slam, "data")
    connect(slam, sink, "slam")
    torch.cuda.synchronize()
    corr_lookup.reset_launches()
    t0 = time.perf_counter()
    run_sequential([data, slam, sink], max_spins=20 * N_FRAMES)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(corr_lookup.launches)
    if not frontend.stop or sink.last_full is None:
        raise RuntimeError(f"tracking {extra} did not run to its end")
    return frontend, sink, wall, launches


def path_phase(dev):
    """Tracking without mapping under each of ``PATHS``; returns the
    launches of each path's own kernel."""
    counted = {}
    for tag, width, extra, kernel, idle in PATHS:
        frontend, sink, wall, launches = track_only(
            dev, synthetic_frames(width), width, extra)
        ate = trajectory_error(sink)
        n_kf = frontend.kf_idx + 1
        log(f"path ({tag}) {extra} {H}x{width}: {n_kf} keyframes of "
            f"{N_FRAMES} frames in {wall:.2f} s, ATE-RMSE {ate:.4f} m, "
            f"launches {launches}")
        if extra.get("global_ba"):
            if frontend.last_gba_scores is None:
                raise RuntimeError(f"path ({tag}): global BA did not run")
            s0, s1 = frontend.last_gba_scores
            log(f"path ({tag}) global BA: last_gba_scores ({s0:.4f}, "
                f"{s1:.4f}), rolled back: {s1 < s0}")
        if launches[kernel] <= 0:
            raise RuntimeError(f"path ({tag}): kernel {kernel} was not "
                               f"launched")
        stray = [k for k in idle if launches[k]]
        if stray:
            raise RuntimeError(f"path ({tag}) launched {stray}, which its "
                               f"configuration does not use")
        if not ate <= ATE_LIMIT_M:
            raise RuntimeError(f"path ({tag}) ATE-RMSE {ate:.4f} m > "
                               f"{ATE_LIMIT_M}")
        counted[kernel] = launches[kernel]
        del frontend, sink
        torch.cuda.empty_cache()
    return counted


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        import nerf_slam_tpu_torch
        from nerf_slam_tpu_torch.ops import build
    except ImportError as e:
        print(f"chip_smoke: the port's package is missing: {e}",
              file=sys.stderr)
        return 1
    pkg_dir = os.path.dirname(os.path.abspath(nerf_slam_tpu_torch.__file__))
    if os.path.dirname(pkg_dir) != ROOT:
        print(f"chip_smoke: nerf_slam_tpu_torch found at {pkg_dir}, not "
              f"beside this script", file=sys.stderr)
        return 1

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    log(card_line())                 # nvidia-smi's name, power.limit
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}")

    t0 = time.perf_counter()
    reports = build.build(["corr_lookup"])
    log(f"kernel build: {time.perf_counter() - t0:.2f} s "
        f"({', '.join(reports) or 'cached'})")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    entries = kernel_phase(dev)
    launches = pipeline_phase(dev)
    torch.cuda.empty_cache()
    launches.update(path_phase(dev))
    for e in entries:
        e["launches"] = launches[e["name"]]
    log(f"chip_smoke: all phases passed in "
        f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
