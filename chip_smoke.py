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

Then the map backends: (d) Sigma-TSDF fidelity, as
``scripts/tsdf_fidelity.py`` measures it: 20 ground-truth-depth frames of
the synthetic room with objects at 240x320 fused into the default 192^3
volume, the marching-tetrahedra mesh scored against the analytic surface,
ray-cast PSNR and depth L1, each held to QUALITY.md's default row; (e)
the ``slam_demo`` CLI with ``--fusion sigma --eval`` on the production
frames and weights, sequentially (ATE-RMSE at most 0.25 m), then with
``--stereo`` and with ``--rgbd`` (no map); (f) the hash-grid NeRF
(default ``HashGridConfig``) fitted for 2000 iterations at 4096 rays on
the sequential run's keyframes, beside the PE field's fit on the same
keyframes: the loss must stay finite and the PSNR of the last evaluation
must exceed the first's; a second fit from the same seed, 500
iterations, must repeat the first's to the bit (its table gradient is a
fixed-order scatter).

The tracker's sensor modes run right after paths (a)-(c), on the
production frames, weights and filters, sequentially, each twice on
fresh state and held to the bit: (g) stereo (the right camera 0.1 m
along +x, the rig pose from the packets, 64 edge slots for the stereo
edges), which must put (i, i) stereo edges into the graph, and (h) RGB-D
(the packets' depths as sensed depths); both must launch kernels #1 and
#2 and keep every pose and depth finite, and they print the Sim(3)- and
SE(3)-aligned ATE and the Sim(3) scale.  Last, after (f), (i) the
mapper's options on the sequential run's keyframes: a 2000-iteration PE
fit with pose refinement (``optimize_extrinsics``, from iteration 500,
25 pose-only steps a 100-step cycle), the same with depth annealing over
1000 iterations, a training-view render without the occupancy bound
(``render_accel=False``) and free-view renders at the dynamic
resolution.

Output, in order: the card's name and power limit, the kernel build time,
one line per kernel check, the pipeline and path lines, the ``kernels``
JSON line, and last ``{"ok": true, "device": {...}}``.  Any failure exits
non-zero without the ``ok`` line.  Needs a CUDA device; imports no JAX.
"""
from __future__ import annotations

import hashlib
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
# the volumes' magnitude (|v| < 4): bf16 1.6e-2, f32 1e-5.  #2 is held to
# the bit (max |err| 0).
TOL_BF16, TOL_F32 = 1.6e-2, 1e-5

# (d): QUALITY.md's TSDF default row (scripts/tsdf_fidelity.py, 192^3,
# 20 GT-depth frames at 240x320) and the bands around it
TSDF_FRAMES, TSDF_H, TSDF_W = 20, 240, 320
TSDF_REF = {"mesh_err_mean_cm": (0.237, 0.02), "psnr_db": (31.15, 0.5),
            "depth_l1_cm": (0.71, 0.1)}
# (f): the hash grid's fit, evaluated every HASH_EVAL_EVERY iterations
HASH_EVAL_EVERY = 500
# (g): the synthetic rig's baseline, metres along the camera's +x
STEREO_BASELINE = 0.1
# (i): the pose refinement's schedule
REFINE = dict(optimize_extrinsics=True, extrinsics_start=500,
              extrinsics_period=100, extrinsics_pose_iters=25)
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
    if not torch.equal(got, want):
        raise RuntimeError(f"pyramid lookup differs from its plain version: "
                           f"max |err| {err}, not bit-equal")
    ms = time_ms(lambda: corr_lookup.lookup_pyramid(levels, coords))
    plain_ms = time_ms(lambda: corr_lookup.lookup_pyramid_plain(
        levels, coords), reps=20, warmup=2)
    lv_dims = [tuple(v.shape[-2:]) for v in levels]
    nb, fl, nb_sec = lookup_traffic(coords, lv_dims, lv_dims, got, 1, 49)
    b_ms, b_by = bound(nb, fl)
    bs_ms = bound(nb_sec, fl)[0]
    log(f"kernel corr_lookup_pyramid E=1 {h}x{w}: max|err| {err:.3g} (bit "
        f"for bit) {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} "
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
    train_set = fusion.train_set          # the keyframes, for phase (f)
    pe_iters = max(0, NGP_HORIZON - fusion.iteration)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fusion.fit_volume(pe_iters)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    pe_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    row = fusion.evaluate_training_views(max_views=8)
    if row is None or not math.isfinite(row["psnr"]):
        raise RuntimeError(f"bad evaluation row {row}")
    pe = dict(psnr=row["psnr"], steps_s=pe_iters / fit_s, peak_gib=pe_peak)
    log(f"pipeline sequential (untimed): {n_kf_seq} keyframes of "
        f"{N_FRAMES} frames in {wall:.2f} s, ATE-RMSE {ate_seq:.4f} m")
    log(f"quality: PSNR {row['psnr']:.2f} dB, depth L1 "
        f"{row['depth_l1_cm']:.2f} cm (scale-aligned "
        f"{row['depth_l1_aligned_cm']:.2f} cm) after {fusion.iteration} NGP "
        f"iterations, 8 training views; the last {pe_iters} PE iterations "
        f"{pe['steps_s']:.1f} steps/s, peak memory {pe_peak:.2f} GiB")

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
    return launches, train_set, pe


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


def _box_shell(pts, lo, hi):
    """Unsigned distance to an axis-aligned box shell."""
    q = np.maximum(lo - pts, pts - hi)
    outside = np.linalg.norm(np.maximum(q, 0.0), axis=-1)
    inside = np.minimum(q.max(axis=-1), 0.0)
    return np.abs(outside + inside)


def scene_surface_distance(pts, ds):
    """Exact unsigned distance from points to the synthetic room's
    surface: its box shell and every interior sphere and box
    (scripts/tsdf_fidelity.py's measure)."""
    c = ds.cfg
    d = _box_shell(pts, np.array([-c.room_half, -c.room_half, 0.0]),
                   np.array([c.room_half, c.room_half, c.room_height]))
    for ob in ds.objects:
        if ob["type"] == "sphere":
            do = np.abs(np.linalg.norm(pts - np.asarray(ob["c"]), axis=-1)
                        - ob["r"])
        else:
            do = _box_shell(pts, np.asarray(ob["lo"]), np.asarray(ob["hi"]))
        d = np.minimum(d, do)
    return d


def tsdf_phase(dev):
    """(d) GT-depth TSDF fusion at the default preset, scored as
    QUALITY.md's default row was."""
    from nerf_slam_tpu_torch.datasets import SyntheticConfig, SyntheticDataset
    from nerf_slam_tpu_torch.fusion import TsdfFusion, TsdfFusionConfig

    cfg = TsdfFusionConfig()
    fusion = TsdfFusion(cfg, device=dev)
    ds = SyntheticDataset(SyntheticConfig(
        n_frames=TSDF_FRAMES, height=TSDF_H, width=TSDF_W, seed=21,
        n_objects=8))
    views = [ds[k] for k in range(TSDF_FRAMES)]
    cov = np.full((TSDF_H, TSDF_W), 1e-4, np.float32)  # GT depth: tiny sigma
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for p in views:
        fusion.integrate_frame(np.linalg.inv(p["poses"]), p["intrinsics"],
                               p["depths"], cov, p["images"], record=False)
    torch.cuda.synchronize()
    fuse_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    sel = views[::7]
    t0 = time.perf_counter()
    ev = fusion.evaluate([p["images"] for p in sel], [p["depths"] for p in sel],
                         [p["poses"] for p in sel],
                         [p["intrinsics"] for p in sel], max_views=3)
    eval_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    verts, faces, _ = fusion.extract_mesh(weight_thresh=1.0)
    mesh_s = time.perf_counter() - t0
    if verts.shape[0] == 0:
        raise RuntimeError("TSDF fidelity: the mesh is empty")
    err = scene_surface_distance(verts, ds)
    got = {"mesh_err_mean_cm": float(err.mean()) * 100,
           "psnr_db": ev["psnr"], "depth_l1_cm": ev["depth_l1_cm"]}
    log(f"(d) TSDF fidelity {cfg.grid_size}^3, {TSDF_FRAMES} GT-depth frames "
        f"at {TSDF_H}x{TSDF_W}: mesh error mean "
        f"{got['mesh_err_mean_cm']:.4f} cm, p95 "
        f"{float(np.percentile(err, 95)) * 100:.4f} cm, {verts.shape[0]} "
        f"vertices, {faces.shape[0]} faces; PSNR {got['psnr_db']:.3f} dB, "
        f"depth L1 {got['depth_l1_cm']:.4f} cm; integration {fuse_s:.3f} s "
        f"({1e3 * fuse_s / TSDF_FRAMES:.2f} ms a frame, host clock), "
        f"ray-cast eval {eval_s:.2f} s, mesh {mesh_s:.2f} s (host numpy), "
        f"peak memory {peak:.2f} GiB")
    for key, (ref, band) in TSDF_REF.items():
        if not abs(got[key] - ref) <= band:
            raise RuntimeError(f"TSDF fidelity: {key} {got[key]:.4f} outside "
                               f"QUALITY.md's {ref} +- {band}")


def cli_phase(dev):
    """(e) The slam_demo CLI on the production frames and weights,
    sequentially: --fusion sigma --eval (ATE-RMSE at most ATE_LIMIT_M),
    then --stereo and --rgbd without a map (finite ATE); counters zeroed
    just before each run."""
    from nerf_slam_tpu_torch.cli import slam_demo
    from nerf_slam_tpu_torch.ops import corr_lookup

    for flags in (["--fusion", "sigma", "--eval"],
                  ["--fusion", "none", "--stereo"],
                  ["--fusion", "none", "--rgbd"]):
        args = slam_demo.parse_args([
            "--weights", os.path.join(ROOT, "weights_synthetic.npz"),
            "--height", str(H), "--width", str(W), "--n_frames",
            str(N_FRAMES), "--buffer", str(BUFFER), "--out", os.devnull,
            "--device", dev.type] + flags)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        corr_lookup.reset_launches()
        res = slam_demo.run(args)
        launches = dict(corr_lookup.launches)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        ate = res.get("ate_rmse_m", math.nan)
        tsdf = (f", TSDF eval row psnr {res.get('fusion_psnr')} depth_l1_cm "
                f"{res.get('fusion_depth_l1_cm')}" if "--eval" in flags
                else "")
        log(f"(e) CLI {' '.join(flags)} {H}x{W}: {res['n_keyframes']} "
            f"keyframes of {N_FRAMES} frames, {res['kf_per_s']:.4f} "
            f"keyframes/s ({res['wall_s']:.2f} s), ATE-RMSE {ate:.4f} m"
            f"{tsdf}, peak memory {peak:.2f} GiB, launches {launches}")
        missing = [k for k in ("corr_lookup_grouped4", "corr_lookup_pyramid")
                   if launches[k] <= 0]
        if missing:
            raise RuntimeError(f"(e) {flags}: kernels not launched: "
                               f"{missing}")
        if "--eval" in flags and not ate <= ATE_LIMIT_M:
            raise RuntimeError(f"(e) ATE-RMSE {ate} m > {ATE_LIMIT_M}")
        if not math.isfinite(ate):
            raise RuntimeError(f"(e) {flags}: ATE-RMSE {ate}")


def field_digest(fusion) -> str:
    """sha256 of every parameter's bytes of a NeRF field (host copies)."""
    h = hashlib.sha256()
    for name, t in sorted(fusion.field.state_dict().items()):
        h.update(name.encode())
        h.update(t.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def hash_fit(dev, train_set, iters: int):
    """The hash-grid field fitted on ``train_set`` for ``iters`` iterations
    at 4096 rays from SEED, evaluated every HASH_EVAL_EVERY.  Returns
    (fit seconds, losses, rows, the field's digest after each chunk)."""
    from nerf_slam_tpu_torch.fusion import (NerfFusion, NerfFusionConfig,
                                            NGPConfig)
    fusion = NerfFusion(NerfFusionConfig(
        buffer=BUFFER, height=H, width=W, batch_rays=4096,
        ngp=NGPConfig(encoding="hash")), seed=SEED, device=dev)
    fusion.train_set = train_set
    fusion.has_data = True
    torch.cuda.synchronize()
    fit_s, losses, rows, digests = 0.0, [], [], []
    for _ in range(iters // HASH_EVAL_EVERY):
        t0 = time.perf_counter()
        loss = fusion.fit_volume(HASH_EVAL_EVERY)
        torch.cuda.synchronize()
        fit_s += time.perf_counter() - t0
        losses.append(float(loss))
        digests.append(field_digest(fusion))
        rows.append(fusion.evaluate_training_views(max_views=8))
    return fit_s, losses, rows, digests


def hash_phase(dev, train_set, pe, second_iters: int):
    """(f) The hash-grid NeRF fitted on the sequential run's keyframes,
    NGP_HORIZON iterations at 4096 rays, evaluated every HASH_EVAL_EVERY;
    beside the PE field's fit on the same keyframes (``pe``).  A second
    fit from the same seed, ``second_iters`` iterations, must give the
    same field bits and losses at every evaluation it reaches."""
    torch.cuda.reset_peak_memory_stats()
    fit_s, losses, rows, digests = hash_fit(dev, train_set, NGP_HORIZON)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    psnrs = [r["psnr"] for r in rows]
    log(f"(f) hash-grid NeRF {H}x{W}, {int(train_set.valid.sum())} keyframes:"
        f" PSNR {', '.join(f'{p:.4f}' for p in psnrs)} dB at iterations "
        f"{[r['iteration'] for r in rows]}, loss {losses}, "
        f"{NGP_HORIZON / fit_s:.1f} steps/s, peak memory {peak:.2f} GiB; "
        f"PE field on the same keyframes: PSNR {pe['psnr']:.2f} dB after "
        f"{NGP_HORIZON} iterations, {pe['steps_s']:.1f} steps/s, peak "
        f"memory {pe['peak_gib']:.2f} GiB")
    if not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"(f) hash-grid loss not finite: {losses}")
    if not psnrs[-1] > psnrs[0]:
        raise RuntimeError(f"(f) hash-grid PSNR did not rise: {psnrs}")
    fit2_s, losses2, rows2, digests2 = hash_fit(dev, train_set, second_iters)
    n = len(digests2)
    same = digests2 == digests[:n] and losses2 == losses[:n]
    log(f"(f) second hash-grid fit, {second_iters} iterations from the same "
        f"seed: {second_iters / fit2_s:.1f} steps/s, PSNR "
        f"{', '.join('%.4f' % r['psnr'] for r in rows2)} dB; field bits and "
        f"losses equal to the first fit's at iterations "
        f"{[r['iteration'] for r in rows2]}: {same}")
    if not same:
        raise RuntimeError("(f) the hash-grid fit is not reproducible: a "
                           "second fit from the same seed differs")
    return NGP_HORIZON / fit_s


def sensor_phase(dev):
    """(g) the stereo tracker and (h) the RGB-D tracker on the production
    frames (rendered with the right camera), weights and filters,
    sequentially, each twice on fresh state.  Returns their launches."""
    from nerf_slam_tpu_torch.datasets import SyntheticConfig, SyntheticDataset
    from nerf_slam_tpu_torch.utils.evaluation import (ate_rmse,
                                                      trajectory_from_packet,
                                                      umeyama_alignment)
    ds = SyntheticDataset(SyntheticConfig(
        n_frames=N_FRAMES, height=H, width=W, stereo=True,
        baseline=STEREO_BASELINE))
    frames = [ds[k] for k in range(N_FRAMES)]
    rig = tuple(float(v) for v in frames[0]["stereo_rel"])
    counted = {}
    # the initialization's graph holds 51 edges with the stereo ones,
    # more than the main path's 48 slots: (g) gets the CLI's 64
    for tag, extra in (("g", dict(stereo=True, stereo_rel=rig, e_active=64)),
                       ("h", dict(rgbd=True))):
        results = []
        for run in range(2):
            frontend, sink, wall, launches = track_only(dev, frames, W, extra)
            n, st = frontend.kf_idx + 1, frontend.state
            res = tracker_result(frontend) + (st.features1.cpu(),
                                              st.idepths_sensed[:n].cpu())
            results.append(res)
            if not (torch.isfinite(res[1]).all()
                    and torch.isfinite(res[2]).all()):
                raise RuntimeError(f"({tag}) non-finite poses or depths")
            missing = [k for k in ("corr_lookup_grouped4",
                                   "corr_lookup_pyramid")
                       if launches[k] <= 0]
            if missing:
                raise RuntimeError(f"({tag}) kernels not launched: "
                                   f"{missing}")
            n_stereo = int((frontend.graph.ii == frontend.graph.jj).sum())
            if tag == "g" and n_stereo == 0:
                raise RuntimeError("(g) no (i, i) stereo edges in the graph")
            est, gt = trajectory_from_packet(sink.last_full)
            if est.shape[0] < 3 or not np.isfinite(est).all():
                raise RuntimeError(f"({tag}) bad trajectory")
            scale = umeyama_alignment(est, gt)[2]
            log(f"({tag}) {extra} {H}x{W} run {run + 1}: {n} keyframes of "
                f"{N_FRAMES} frames in {wall:.2f} s, {n_stereo} (i, i) edges "
                f"in the final graph, ATE-RMSE Sim(3)-aligned "
                f"{ate_rmse(est, gt):.4f} m (scale {scale:.4f}), "
                f"SE(3)-aligned {ate_rmse(est, gt, align_scale=False):.4f} "
                f"m, launches {launches}")
            counted[tag] = launches
            del frontend, sink
            torch.cuda.empty_cache()
        same = same_bits(*results)
        log(f"({tag}) second run on fresh state bit-identical to the first "
            f"(keyframes, poses, depths, right features, sensed depths): "
            f"{same}")
        if not same:
            raise RuntimeError(f"({tag}) the tracker is not reproducible")
    return counted


def mapper_phase(dev, train_set, pe):
    """(i) The PE field with pose refinement, then with depth annealing
    too, NGP_HORIZON iterations each on the sequential run's keyframes;
    renders without the occupancy bound and at the dynamic resolution."""
    from nerf_slam_tpu_torch.fusion import NerfFusion, NerfFusionConfig
    base = dict(buffer=BUFFER, height=H, width=W, batch_rays=4096)
    fitted = None
    for tag, kw in (("pose refinement", REFINE),
                    ("pose refinement + depth annealing over 1000",
                     dict(REFINE, depth_anneal_iters=1000))):
        fusion = NerfFusion(NerfFusionConfig(**base, **kw), seed=SEED,
                            device=dev)
        fusion.train_set = train_set
        fusion.has_data = True
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = float(fusion.fit_volume(NGP_HORIZON))
        torch.cuda.synchronize()
        steps_s = NGP_HORIZON / (time.perf_counter() - t0)
        row = fusion.evaluate_training_views(max_views=8)
        deltas = fusion.pose_deltas.detach()
        n_views = int(train_set.valid.sum())
        log(f"(i) PE fit with {tag}, {NGP_HORIZON} iterations: "
            f"{steps_s:.1f} steps/s (plain fit {pe['steps_s']:.1f}), PSNR "
            f"{row['psnr']:.4f} dB (plain {pe['psnr']:.4f}), scale-aligned "
            f"depth L1 {row['depth_l1_aligned_cm']:.4f} cm, loss {loss:.5f},"
            f" largest pose delta {float(deltas.abs().max()):.6f} "
            f"(translation {float(deltas[:n_views, :3].abs().max()):.6f}, "
            f"rotation {float(deltas[:n_views, 3:].abs().max()):.6f} rad)")
        if not (math.isfinite(loss) and math.isfinite(row["psnr"])
                and torch.isfinite(deltas).all()):
            raise RuntimeError(f"(i) {tag}: non-finite loss, PSNR or deltas")
        if not (float(deltas.abs().max()) > 0 and bool((deltas[0] == 0)
                                                       .all())):
            raise RuntimeError(f"(i) {tag}: the poses did not move, or view "
                               f"0 moved")
        fitted = fitted or fusion
    cfg = fitted.cfg
    cfg.render_accel = False
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rgb, depth = fitted.render_training_view(0)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    cfg.render_accel, cfg.dynamic_render_res = True, True
    fitted._render_ms = {}
    c2w = train_set.c2w[0].cpu().numpy().copy()
    c2w[:3, 3] = (c2w[:3, 3] - np.asarray(cfg.offset)) / cfg.scale
    intr = train_set.intrinsics[0].cpu().numpy()
    fitted.render_image(c2w, intr)                  # measures scale 1
    full_ms = fitted._render_ms[1]
    scale = fitted._pick_render_scale()
    rgb2, depth2 = fitted.render_image(c2w, intr)
    log(f"(i) training-view render {H}x{W} without the occupancy bound "
        f"(render_accel=False): {plain_ms:.2f} ms; free-view render with "
        f"it at full resolution {full_ms:.2f} ms, then the dynamic "
        f"resolution's pick for {cfg.render_target_ms} ms: scale {scale}, "
        f"{fitted._render_ms[scale]:.2f} ms (host clock, synced)")
    for a in (rgb, depth, rgb2, depth2):
        if not np.isfinite(np.asarray(a.cpu() if hasattr(a, "cpu") else a)
                           ).all():
            raise RuntimeError("(i) a render is not finite")
    if tuple(np.asarray(depth2).shape) != (H, W):
        raise RuntimeError(f"(i) the dynamic render is {depth2.shape}")


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
    launches, train_set, pe = pipeline_phase(dev)
    torch.cuda.empty_cache()
    launches.update(path_phase(dev))
    sensor_phase(dev)
    torch.cuda.empty_cache()
    tsdf_phase(dev)
    torch.cuda.empty_cache()
    cli_phase(dev)
    torch.cuda.empty_cache()
    # the second fit is held to the first's bits over its first chunk
    hash_phase(dev, train_set, pe, HASH_EVAL_EVERY)
    torch.cuda.empty_cache()
    mapper_phase(dev, train_set, pe)
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
