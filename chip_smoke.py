"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``nerf_slam_tpu_torch/ops/csrc``,
checks each against its plain PyTorch version at the tracking shapes of
the 336x640 production cell, times it beside its bound (counted in
elements and in 32-byte sectors) and, for the two one-level kernels,
beside one ``F.grid_sample`` call that computes the same function, and
the segment-sum kernel against the one-hot product at the sigma cells'
dense-BA and GRU-pool shapes, then drives the main path end to end:
synthetic frames -> DataModule -> SlamModule (RaftVisualFrontend, trained
weights, motion filter 2.4 px, keyframe rejection 4.0) -> FusionModule
(PE-NeRF) -> EvalSink, as ``bench.py`` configures it.  One sequential run
gives the quality numbers (ATE-RMSE, PSNR after 2000 NGP iterations, as
QUALITY.md measures them); one threaded run, with the launch counters
zeroed just before it, gives keyframes/s and shows that the main path
went through its kernels (the lookups and the segment sums).  The
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
``--stereo`` and with ``--rgbd`` (no map, 15 frames); (f) the hash-grid
NeRF (default ``HashGridConfig``) fitted for 1000 iterations at 4096 rays on
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
mapper's options on the sequential run's keyframes: a 1000-iteration PE
fit with pose refinement (``optimize_extrinsics``, from iteration 500,
25 pose-only steps a 100-step cycle), the same with depth annealing over
1000 iterations, a training-view render without the occupancy bound
(``render_accel=False``) and free-view renders at the dynamic
resolution.

Then the real file formats, each through the ``slam_demo`` CLI with the
same weights and filters, sequentially, the counters zeroed before each
run: (j) the in-repo instant-ngp scene ``convergence_results/
object_scene_nerf`` (30 frames, 336x640 PNGs) with ``--fusion nerf
--eval``: at least 20 keyframes, ATE-RMSE at most 0.50 m (the JAX
package's record 0.4009 m plus 25%), the PSNR after the run's mapping
iterations, and the tracker once more on fresh state held to the bit;
(k) the synthetic room rendered at TUM's 480x640 through the freiburg3
camera and written in the TUM RGB-D layout by the port's PNG encoder,
read at 384x512, with ``--rgbd --fusion sigma``; (l) the room with a
right camera 0.1 m along +x at EuRoC's 480x752 in the ``mav0/`` layout
(sensor.yaml files, ground truth, a constant IMU), rectified to 336x640,
with ``--stereo``: the baseline recovered within 1e-4 and (i, i) edges
in the graph.  Each must launch kernels #1 and #2 and keep every pose and
depth finite.  (m) The production tracker saved after keyframe 12 and
resumed in a fresh tracker equals the sequential run to the bit, and a PE
field saved after 500 iterations and resumed to 1000 equals an
uninterrupted fit; (n) path (d)'s mesh written as OBJ, read back by
``load_mesh`` and rendered by ``MeshRenderer`` on the card at two of
(d)'s views, within 1 cm (mean) of a 768-step TSDF ray cast and 0.5 cm
of the ground truth; (o) (k)'s first 15 frames once more with
``--profile --fusion none``, whose trace must name kernel #1's device
function; and Replica (JPEG color frames) where OpenCV or Pillow imports,
else one line saying why it was not run.

Then the visual-inertial and the training paths: (p) the CLI with
``--vio`` on the production frames: one inertial state a packet the SLAM
stage takes (it stops when the tracker's 24-keyframe buffer is full), an
incremental backend that relinearizes and reuses factors, a finite
estimate, and the tracker's keyframes, poses and depths equal to the same
run without ``--vio`` to the bit; the inertial chain replayed on the CPU
from the same packets, within 1e-4 m and 1e-4 rad of the card's; the
largest position error against ground truth and the backend's ms a
frame.  (q) the trainer (``cli/train_droid_synthetic.run_phase``): three
optimizer steps of the p2b phase (192x320, 7 frames, 8 GRU iterations,
remat, 4 scenes a step, EMA 0.998; 12 seed-fixed scenes and 2 held out)
from ``weights_synthetic.npz``, twice, the two results equal to the bit;
one step of p4b (336x640, 5 frames) from there; loss, finite gradients,
s a scene-gradient and an optimizer step, peak memory; the result
through the CLI's ``--weights`` on the production cell (ATE-RMSE at most
0.25 m), and a ``droid.pth``-named state dict of the weights through
``--weights``.

Last, the parallel and the GUI paths: (r) the production tracker with
``edge_shards=2`` on the one card, twice, against the unsharded tracker
alone: the same keyframes, ATE-RMSE at most 0.25 m (with its gap to the
unsharded run's and the largest pose gap), the two runs equal to the
bit, kernel #1 launched twice as often (once a shard an iteration) and
#2 as often; the sharded DBA step and the data-parallel NGP step, two
shards each at the production widths, on the card and on the CPU from
the same inputs, within 1e-4; the CLI with ``--edge_shards 2 --fusion
nerf --eval`` (ATE-RMSE at most 0.25 m) and with ``--device_split
--parallel_run`` (one card: the single-device line, the mapping
parameters on ``cuda:0``; two: on ``cuda:1``).  (s) the CLI with ``--gui
--viewer_port <free port> --fusion nerf`` on the production frames in a
temporary working directory: ``/state.json`` holds every keyframe,
``/kf.jpg``, ``/depth.jpg`` and ``/sigma.jpg`` are JPEGs, ``/cloud.ply``
a PLY, a ``sigma_thresh`` command sent over HTTP reaches the GUI, the
exports exist and the ``mesh`` end command wrote a mesh with vertices;
keyframes/s with and without the GUI, and the GUI's export and publish
times.

Output, in order: the card's name and power limit, the kernel build time,
one line per kernel check, the pipeline and path lines (a)-(o) and
Replica, (p), (q), (r) and (s), each phase's end time, the launches of
#1 and #2 on (j), (k), (l), (o), (p), (r) and (s), the ``kernels`` JSON
line, and last ``{"ok": true, "device": {...}}``.  Any failure exits
non-zero without the ``ok`` line.  Needs a CUDA device; imports no JAX.
``--only p,q,r,s`` (any of the four) runs those phases alone (a partial
run, without the kernel line or the ``ok`` line).
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import json
import math
import os
import subprocess
import sys
import tempfile
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

# the segment-sum kernel's check at the benchmark's sigma cells
# (portbench/configs/sigma_*_384x512.json): 48x64 features, 48 + 48 edge
# slots, a pose window of 32, 40 depth slots
SEG_HW, SEG_E, SEG_P, SEG_K = 48 * 64, 96, 32, 40

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
# (f): the hash grid's fit, evaluated every HASH_EVAL_EVERY iterations;
# (i): the PE fits with the mapper's options; (e): the CLI's --stereo and
# --rgbd runs (a run past 540 s cut these three from 2000, 2000 and 30)
HASH_EVAL_EVERY = 500
HASH_ITERS, OPTION_ITERS, CLI_SENSOR_FRAMES = 1000, 1000, 15
# (g): the synthetic rig's baseline, metres along the camera's +x
STEREO_BASELINE = 0.1
# (i): the pose refinement's schedule
REFINE = dict(optimize_extrinsics=True, extrinsics_start=500,
              extrinsics_period=100, extrinsics_pose_iters=25)
# (j): the in-repo NeRF-format scene (instant-ngp transforms.json, 336x640)
# and the JAX package's record on it (convergence_results/summary.json,
# row object_scene: 24 keyframes, ATE-RMSE 0.4009 m) plus 25%
NERF_SCENE = os.path.join(ROOT, "convergence_results", "object_scene_nerf")
NERF_MIN_KF, NERF_ATE_LIMIT_M = 20, 0.50
# (k): TUM's 480x640 frames, the freiburg3 camera the loader assigns, and
# the loader's 384x512 output
TUM_HW, TUM_OUT_HW = (480, 640), (384, 512)
FR3 = (535.4, 539.2, 320.1, 247.6)
# (l): EuRoC's 752x480 cameras, rectified to the production 336x640
EUROC_HW = (480, 752)
# (n): the mesh render against the TSDF ray cast (at MESH_RAY_STEPS steps)
# and against the ground truth, mean |depth diff| limits
MESH_VIEWS, MESH_HW, MESH_LIMIT_CM, MESH_GT_LIMIT_CM = 2, (240, 320), 1.0, 0.5
MESH_RAY_STEPS, MESH_VIEW_LIMIT_S = 768, 10.0
# (m): the keyframe after which the production tracker is saved
RESUME_KF = 12
# (o): (k)'s frames under the profiler (all 30: a 360 MiB trace and about
# a minute of the run; the first call past 450 s cut them to 15)
PROFILE_FRAMES = 15
WEIGHTS = os.path.join(ROOT, "weights_synthetic.npz")
# (p): the card's inertial chain against its CPU replay (m and rad)
VIO_TOL = 1e-4
# (q): the trainer's phases cut to a few steps and seed-fixed scenes (the
# widths, frames, GRU iterations, accumulation and EMA are the phases')
TRAIN_CUT = {"p2b": dict(steps=3, scenes=12, holdout=2),
             "p4b": dict(steps=1, scenes=4, holdout=1)}
DEVICE = "cuda"             # the CLI's and the renderer's device
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


def segment_phase(dev):
    """The segment-sum kernel against its plain version (the one-hot
    products) at the dense BA's four sums (Hgrid: 4E rows of 6 x 6 into
    P x P segments; v: 2E of 6 into P; C/w: E of 2 x HW into K; Ehat: 2E
    of 6 x HW into P x K, all f32) and the GRU pool (48 edges of HW x 128
    bf16, a mean over K), ids from a plan of the sigma cells' padded
    shapes.  Each within f32 rounding of the one-hot product (1e-6 of the
    segment's sum of |x|, plus one bf16 rounding of a bf16 output), its
    largest gap printed (0 where cuBLAS adds the rows in ascending order
    too); at Ehat and the pool the kernel's time beside its byte bound
    (kept rows and ids read once, the outputs written once) and the plain
    version's time.  Returns the ``kernels`` entry."""
    from nerf_slam_tpu_torch.ops import segment
    from nerf_slam_tpu_torch.solver import dba

    kf0, kf1 = 60, 60 + SEG_P
    edges = [(i, j) for i in range(kf0 - 4, kf1) for j in range(kf0, kf1)
             if 0 < abs(i - j) <= 3][:SEG_E]
    p = dba.plan(np.array([e[0] for e in edges]),
                 np.array([e[1] for e in edges]), kf0, kf1, SEG_E, SEG_P,
                 SEG_K, device=dev)

    def pair(a, b, n):
        return torch.where((a >= 0) & (b >= 0), a * n + b, -1)

    pp, kk2 = torch.cat([p.pi, p.pj]), torch.cat([p.kk, p.kk])
    quad = (torch.cat([p.pi, p.pi, p.pj, p.pj]),
            torch.cat([p.pi, p.pj, p.pi, p.pj]))
    f32, bf16 = torch.float32, torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(SEED)
    # name: (ids, n_seg, row shape, dtype, mean, timed)
    cases = {
        "ehat": (pair(pp, kk2, SEG_K), SEG_P * SEG_K, (6, SEG_HW), f32,
                 False, True),
        "pool": (torch.where(p.edge_valid[:48] > 0, p.kk[:48], -1), SEG_K,
                 (SEG_HW, 128), bf16, True, True),
        "hgrid": (pair(*quad, SEG_P), SEG_P * SEG_P, (6, 6), f32, False,
                  False),
        "v": (pp, SEG_P, (6,), f32, False, False),
        "cw": (p.kk, SEG_K, (2, SEG_HW), f32, False, False)}
    res = {}
    for name, (ids, n_seg, shape, dtype, mean, timed) in cases.items():
        x = torch.randn((ids.shape[0],) + shape, generator=g,
                        device=dev).to(dtype)
        fn = segment.segment_mean if mean else segment.segment_sum
        got = fn(x, ids, n_seg).reshape(n_seg, -1).float()
        want = segment.sums_plain(x, ids, n_seg, dtype, mean)[0].float()
        scale = segment.sums_plain(x.abs(), ids, n_seg, f32, mean)[0]
        torch.cuda.synchronize()
        gap = (got - want).abs()
        err = float(gap.max())
        rel = float((gap / scale.clamp(min=1e-30)).max())
        tol = 1e-6 * scale + (2.0 ** -8 * want.abs() if dtype == bf16
                              else 0.0)
        if not bool((gap <= tol + 1e-30).all()):
            raise RuntimeError(f"segment sum ({name}) differs from the "
                               f"one-hot product beyond f32 rounding: max "
                               f"|err| {err}")
        line = (f"kernel segment_sum ({name}) {ids.numel()} rows x "
                f"{x[0].numel()} {str(dtype)[6:]} into {n_seg} segments"
                f"{', mean' if mean else ''}: one-hot product's bits "
                f"{torch.equal(got, want)}, max |err| {err:.3g} ("
                f"{rel:.3g} of the segment's sum of |x|)")
        res[name] = dict(err=err, rel=rel, bits=torch.equal(got, want))
        if timed:
            ms = time_ms(lambda: fn(x, ids, n_seg))
            plain_ms = time_ms(lambda: segment.sums_plain(
                x, ids, n_seg, dtype, mean), reps=10, warmup=2)
            kept = int(((ids >= 0) & (ids < n_seg)).sum())
            cols = x[0].numel()
            nb = (kept + n_seg) * cols * x.element_size() + ids.numel() * 8
            b_ms, b_by = bound(nb, kept * cols + (n_seg * cols if mean
                                                  else 0))
            res[name].update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                             bound_by=b_by, bytes=nb, kept_rows=kept)
            line += (f", {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                     f"{b_ms:.4f} ms ({b_by}, {nb / 1e6:.1f} MB, {kept} rows "
                     f"kept), {100 * b_ms / ms:.1f}% of it")
        log(line)
        del x, got, want, scale, gap
    r = res["ehat"]
    return {"name": "segment_sum", "route": "cuda",
            "source": "nerf_slam_tpu_torch/ops/csrc/segment_sum.cu",
            "replaces": None, "max_abs_err": max(v["err"]
                                                 for v in res.values()),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None, "shapes": res}


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
    from nerf_slam_tpu_torch.ops import corr_lookup, segment

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
    segment.reset_launches()
    wall, sink = run_pipeline(frames, frontend, fusion, parallel=True)
    launches = {**corr_lookup.launches, **segment.launches}
    ate = trajectory_error(sink)
    n_kf = frontend.kf_idx + 1
    log(f"pipeline threaded (timed): {n_kf / wall:.4f} keyframes/s, {n_kf} "
        f"keyframes of {N_FRAMES} frames in {wall:.3f} s, ATE-RMSE "
        f"{ate:.4f} m, {fusion.iteration} NGP iterations")
    log(f"launches on the main path: {launches}")
    threaded_same = same_bits(first, tracker_result(frontend))
    missing = [k for k in ("corr_lookup_grouped4", "corr_lookup_pyramid",
                           "segment_sum") if launches[k] <= 0]
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
    return launches, train_set, pe, frames, first


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


def tsdf_phase(dev, tmp: str):
    """(d) GT-depth TSDF fusion at the default preset, scored as
    QUALITY.md's default row was; then (n) on its mesh."""
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
    mesh_phase(fusion, verts, faces, views, tmp)


def mesh_phase(fusion, verts, faces, views, tmp: str) -> None:
    """(n) Path (d)'s mesh written by the mesher as OBJ, read back by
    ``load_mesh`` and rendered on the card by ``MeshRenderer`` at two of
    (d)'s ground-truth views, against the TSDF ray cast at the same views
    (mean |depth difference| on pixels both hit under MESH_LIMIT_CM) and
    against the views' ground-truth depths (under MESH_GT_LIMIT_CM).

    The ray cast marches MESH_RAY_STEPS steps (a fifth of a voxel) for
    this comparison; (d)'s evaluation's 192 steps leave it about 1 cm
    from the ground truth (it skips past silhouettes), more than the mesh
    render's own error, and that comparison is printed beside."""
    from nerf_slam_tpu_torch.fusion.mesher import write_obj
    from nerf_slam_tpu_torch.utils.evaluation import MeshRenderer, load_mesh
    path = os.path.join(tmp, "tsdf_mesh.obj")
    t0 = time.perf_counter()
    write_obj(path, verts, faces)
    mv, mf = load_mesh(path)
    io_s = time.perf_counter() - t0
    os.remove(path)
    h, w = MESH_HW
    rows, times = [], []
    for p in [views[k] for k in (3, 14)][:MESH_VIEWS]:
        intr = np.asarray(p["intrinsics"], np.float64) * (w / TSDF_W)
        renderer = MeshRenderer((mv, mf), intr, (w, h), device=DEVICE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mesh_depth = renderer.render_mesh(p["poses"])
        times.append(time.perf_counter() - t0)
        gt = np.asarray(p["depths"])
        row = {}
        for steps in (MESH_RAY_STEPS, 192):
            _, cast = fusion._raycast(
                fusion.volume, fusion._tensor(p["poses"]), (h, w),
                fusion._tensor(intr), n_steps=steps)
            cast = cast.cpu().numpy()
            both = (mesh_depth > 0) & (cast > 0)
            row[steps] = float(np.abs(mesh_depth - cast)[both].mean()) * 100
            row["cover"] = float(both.mean())
        hit = (mesh_depth > 0) & (gt > 0)
        row["gt"] = float(np.abs(mesh_depth - gt)[hit].mean()) * 100
        rows.append(row)
        if times[-1] > MESH_VIEW_LIMIT_S:
            log(f"(n) one view took {times[-1]:.1f} s: the views are cut "
                f"to this one")
            break
    log(f"(n) mesh of (d), {mf.shape[0]} triangles, written as OBJ and read "
        f"back by load_mesh in {io_s:.2f} s (host); MeshRenderer on the card "
        f"at {h}x{w}: {', '.join(f'{t:.3f}' for t in times)} s a view "
        f"(host clock, synced); mean |mesh depth - TSDF ray cast| at "
        f"{MESH_RAY_STEPS} steps "
        f"{', '.join(f'{r[MESH_RAY_STEPS]:.4f}' for r in rows)} cm (192 "
        f"steps: {', '.join(f'{r[192]:.4f}' for r in rows)} cm) on "
        f"{', '.join(f'{100 * r['cover']:.1f}%' for r in rows)} of the "
        f"pixels; mean |mesh depth - ground truth| "
        f"{', '.join(f'{r['gt']:.4f}' for r in rows)} cm")
    if not (mv.shape == verts.shape and mf.shape == faces.shape):
        raise RuntimeError(f"(n) load_mesh read {mv.shape}/{mf.shape}, wrote "
                           f"{verts.shape}/{faces.shape}")
    for r in rows:
        if not (r[MESH_RAY_STEPS] < MESH_LIMIT_CM and r["cover"] > 0.5
                and r["gt"] < MESH_GT_LIMIT_CM):
            raise RuntimeError(f"(n) mesh render out of bounds: {r}")


def cli_phase(dev):
    """(e) The slam_demo CLI on the production frames and weights,
    sequentially: --fusion sigma --eval (ATE-RMSE at most ATE_LIMIT_M),
    then --stereo and --rgbd without a map (finite ATE); counters zeroed
    just before each run."""
    from nerf_slam_tpu_torch.cli import slam_demo
    from nerf_slam_tpu_torch.ops import corr_lookup

    for flags, frames in ((["--fusion", "sigma", "--eval"], N_FRAMES),
                          (["--fusion", "none", "--stereo"], CLI_SENSOR_FRAMES),
                          (["--fusion", "none", "--rgbd"], CLI_SENSOR_FRAMES)):
        args = slam_demo.parse_args([
            "--weights", os.path.join(ROOT, "weights_synthetic.npz"),
            "--height", str(H), "--width", str(W), "--n_frames",
            str(frames), "--buffer", str(BUFFER), "--out", os.devnull,
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
            f"keyframes of {frames} frames, {res['kf_per_s']:.4f} "
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
    HASH_ITERS iterations at 4096 rays, evaluated every HASH_EVAL_EVERY;
    beside the PE field's fit on the same keyframes (``pe``).  A second
    fit from the same seed, ``second_iters`` iterations, must give the
    same field bits and losses at every evaluation it reaches."""
    torch.cuda.reset_peak_memory_stats()
    fit_s, losses, rows, digests = hash_fit(dev, train_set, HASH_ITERS)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    psnrs = [r["psnr"] for r in rows]
    log(f"(f) hash-grid NeRF {H}x{W}, {int(train_set.valid.sum())} keyframes:"
        f" PSNR {', '.join(f'{p:.4f}' for p in psnrs)} dB at iterations "
        f"{[r['iteration'] for r in rows]}, loss {losses}, "
        f"{HASH_ITERS / fit_s:.1f} steps/s, peak memory {peak:.2f} GiB; "
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
    return HASH_ITERS / fit_s


def sensor_phase(dev):
    """(g) the stereo tracker and (h) the RGB-D tracker on the production
    frames (rendered with the right camera), weights and filters,
    sequentially, each twice on fresh state.  Returns each one's
    launches, Sim(3)-aligned ATE and scale."""
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
            counted[tag] = {"launches": launches, "ate": ate_rmse(est, gt),
                            "scale": scale}
            log(f"({tag}) {extra} {H}x{W} run {run + 1}: {n} keyframes of "
                f"{N_FRAMES} frames in {wall:.2f} s, {n_stereo} (i, i) edges "
                f"in the final graph, ATE-RMSE Sim(3)-aligned "
                f"{ate_rmse(est, gt):.4f} m (scale {scale:.4f}), "
                f"SE(3)-aligned {ate_rmse(est, gt, align_scale=False):.4f} "
                f"m, launches {launches}")
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
    too, OPTION_ITERS iterations each on the sequential run's keyframes;
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
        loss = float(fusion.fit_volume(OPTION_ITERS))
        torch.cuda.synchronize()
        steps_s = OPTION_ITERS / (time.perf_counter() - t0)
        row = fusion.evaluate_training_views(max_views=8)
        deltas = fusion.pose_deltas.detach()
        n_views = int(train_set.valid.sum())
        log(f"(i) PE fit with {tag}, {OPTION_ITERS} iterations: "
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


# ----------------------------------------------------------------------
# (j)-(o): the real-format datasets through the CLI, resume, meshes,
# the profiler
# ----------------------------------------------------------------------

KERNELS_12 = ("corr_lookup_grouped4", "corr_lookup_pyramid")


def sync() -> None:
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def cli_run(flags):
    """``slam_demo.run`` with ``flags`` on the card, sequentially, the
    launch counters zeroed just before it.  Returns (results, launches,
    the tracker it built)."""
    from nerf_slam_tpu_torch.cli import slam_demo
    from nerf_slam_tpu_torch.ops import corr_lookup
    built = []
    build = slam_demo.build_frontend
    slam_demo.build_frontend = lambda *a: built.append(build(*a)) or built[-1]
    try:
        args = slam_demo.parse_args(
            ["--weights", WEIGHTS, "--buffer", str(BUFFER), "--out",
             os.devnull, "--device", DEVICE] + flags)
        sync()
        corr_lookup.reset_launches()
        res = slam_demo.run(args)
        sync()
        launches = dict(corr_lookup.launches)
    finally:
        slam_demo.build_frontend = build
    return res, launches, built[0]


def check_tracking(tag: str, fe, launches) -> dict:
    """Kernels #1 and #2 launched, every keyframe pose and depth finite;
    returns the Sim(3)-aligned ATE, its scale and the SE(3)-aligned ATE
    from the tracker's keyframes."""
    from nerf_slam_tpu_torch.utils.evaluation import (
        _pose_to_c2w_translation, ate_rmse, umeyama_alignment)
    missing = [k for k in KERNELS_12 if launches[k] <= 0]
    if missing:
        raise RuntimeError(f"({tag}) kernels not launched: {missing}")
    n, st = fe.kf_idx + 1, fe.state
    if not (torch.isfinite(st.cam_T_world[:n]).all()
            and torch.isfinite(st.idepths[:n]).all()):
        raise RuntimeError(f"({tag}) non-finite poses or depths")
    est = _pose_to_c2w_translation(st.cam_T_world[:n].cpu().numpy())
    gt = st.gt_poses[:n, :3, 3].cpu().numpy().astype(np.float64)
    return {"ate": ate_rmse(est, gt), "scale": umeyama_alignment(est, gt)[2],
            "ate_se3": ate_rmse(est, gt, align_scale=False), "n_kf": n}


def nerf_format_phase() -> dict:
    """(j) The CLI on the in-repo NeRF-format scene at 336x640 with the
    NeRF map and --eval; then the tracker once more on fresh state (no
    map), held to the first run's bits."""
    flags = ["--dataset_name", "nerf", "--dataset_dir", NERF_SCENE,
             "--height", str(H), "--width", str(W)]
    res, launches, fe = cli_run(flags + ["--fusion", "nerf", "--eval"])
    q = check_tracking("j", fe, launches)
    first = tracker_result(fe)
    psnr = res.get("fusion_psnr", math.nan)
    depth_l1 = res.get("fusion_depth_l1_aligned_cm", math.nan)
    log(f"(j) CLI --dataset_name nerf {os.path.basename(NERF_SCENE)} "
        f"{H}x{W} --fusion nerf --eval: {q['n_kf']} keyframes, "
        f"{res['kf_per_s']:.4f} keyframes/s ({res['wall_s']:.2f} s; data "
        f"stage {res['data_mean_ms']:.1f} ms a frame), "
        f"ATE-RMSE {q['ate']:.4f} m (scale {q['scale']:.4f}; JAX record "
        f"24 keyframes, 0.4009 m), PSNR {psnr:.4f} dB after "
        f"{res.get('fusion_iteration')} mapping iterations (aligned depth L1"
        f" {depth_l1:.2f} cm), launches {launches}")
    del fe
    torch.cuda.empty_cache()
    res2, launches2, fe2 = cli_run(flags + ["--fusion", "none"])
    same = same_bits(first, tracker_result(fe2))
    log(f"(j) the tracker again on fresh state (--fusion none, "
        f"{res2['wall_s']:.2f} s): keyframes, poses and depths bit-identical "
        f"to the first run: {same}")
    if q["n_kf"] < NERF_MIN_KF:
        raise RuntimeError(f"(j) {q['n_kf']} keyframes < {NERF_MIN_KF}")
    if not q["ate"] <= NERF_ATE_LIMIT_M:
        raise RuntimeError(f"(j) ATE-RMSE {q['ate']:.4f} m > "
                           f"{NERF_ATE_LIMIT_M}")
    if not math.isfinite(psnr):
        raise RuntimeError(f"(j) no finite PSNR: {res}")
    if not same:
        raise RuntimeError("(j) the tracker is not reproducible on the NeRF "
                           "scene")
    return {"launches": launches}


def write_tum(root: str) -> str:
    """The synthetic room rendered at TUM's 480x640 through the freiburg3
    camera, written in the TUM RGB-D layout by the port's PNG encoder:
    rgb/, depth/ (uint16, depth x 5000), rgb.txt, depth.txt,
    groundtruth.txt (tx ty tz qx qy qz qw)."""
    from nerf_slam_tpu_torch.datasets import SyntheticConfig, SyntheticDataset
    from nerf_slam_tpu_torch.datasets.image_io import write_png
    from nerf_slam_tpu_torch.geometry import se3
    d = os.path.join(root, "rgbd_dataset_freiburg3_synthetic")
    os.makedirs(os.path.join(d, "rgb"))
    os.makedirs(os.path.join(d, "depth"))
    ds = SyntheticDataset(SyntheticConfig(n_frames=N_FRAMES, height=TUM_HW[0],
                                          width=TUM_HW[1]))
    ds.K = np.array(FR3)
    rgb, dep, gt = (["# color images"], ["# depth maps"],
                    ["# timestamp tx ty tz qx qy qz qw"])
    for k in range(N_FRAMES):
        pkt = ds[k]
        t = 1305031102.0 + k / 30.0
        name = f"{t:.6f}.png"
        write_png(os.path.join(d, "rgb", name), pkt["images"])
        write_png(os.path.join(d, "depth", name), np.clip(
            np.round(pkt["depths"] * 5000), 0, 65535).astype(np.uint16))
        rgb.append(f"{t:.6f} rgb/{name}")
        dep.append(f"{t + 0.003:.6f} depth/{name}")
        pose = se3.from_matrix(torch.as_tensor(pkt["poses"],
                                               dtype=torch.float64))
        gt.append(f"{t:.6f} " + " ".join(f"{v:.9f}" for v in pose.tolist()))
    for name, lines in (("rgb.txt", rgb), ("depth.txt", dep),
                        ("groundtruth.txt", gt)):
        with open(os.path.join(d, name), "w") as f:
            f.write("\n".join(lines) + "\n")
    return d


def _sensor_yaml(T_BS, K, wh) -> str:
    rows = ",\n         ".join(", ".join(f"{v:.12f}" for v in r)
                               for r in T_BS)
    return ("%YAML:1.0\n# General sensor definitions.\nsensor_type: camera\n"
            "comment: synthetic rig\n\n# Sensor extrinsics wrt. the "
            "body-frame.\nT_BS:\n  cols: 4\n  rows: 4\n"
            f"  data: [{rows}]\n\n# Camera specific definitions.\n"
            f"rate_hz: 30\nresolution: [{wh[0]}, {wh[1]}]\n"
            "camera_model: pinhole\n"
            f"intrinsics: [{K[0]}, {K[1]}, {K[2]}, {K[3]}] #fu, fv, cu, cv\n"
            "distortion_model: radial-tangential\n"
            "distortion_coefficients: [0.0, 0.0, 0.0, 0.0]\n")


_IMU_YAML = ("%YAML:1.0\n#Default imu sensor yaml file\nsensor_type: imu\n"
             "comment: constant synthetic IMU\nT_BS:\n  cols: 4\n  rows: 4\n"
             "  data: [1.0, 0.0, 0.0, 0.0,\n         0.0, 1.0, 0.0, 0.0,\n"
             "         0.0, 0.0, 1.0, 0.0,\n         0.0, 0.0, 0.0, 1.0]\n"
             "rate_hz: 200\n"
             "gyroscope_noise_density: 1.6968e-04\n"
             "gyroscope_random_walk: 1.9393e-05\n"
             "accelerometer_noise_density: 2.0000e-3\n"
             "accelerometer_random_walk: 3.0000e-3\n")


def write_euroc(root: str) -> str:
    """The synthetic room with a right camera 0.1 m along +x, rendered at
    EuRoC's 480x752 and written in the ``mav0/`` layout: 8-bit gray PNGs,
    data.csv lists, sensor.yaml files in EuRoC's layout (zero
    distortion), ground truth with wxyz quaternions, a constant 200 Hz
    imu0."""
    from nerf_slam_tpu_torch.datasets import SyntheticConfig, SyntheticDataset
    from nerf_slam_tpu_torch.datasets.image_io import write_png
    from nerf_slam_tpu_torch.geometry import se3
    mav = os.path.join(root, "V9_synthetic", "mav0")
    ds = SyntheticDataset(SyntheticConfig(
        n_frames=N_FRAMES, height=EUROC_HW[0], width=EUROC_HW[1],
        stereo=True, baseline=STEREO_BASELINE))
    T_B_c1 = np.eye(4)
    T_B_c1[0, 3] = STEREO_BASELINE
    csv = {"cam0": ["#timestamp [ns],filename"],
           "cam1": ["#timestamp [ns],filename"]}
    gt = ["#timestamp,p_x,p_y,p_z,q_w,q_x,q_y,q_z,v_x,v_y,v_z,b_w_x,b_w_y,"
          "b_w_z,b_a_x,b_a_y,b_a_z"]
    for cam, tbs in (("cam0", np.eye(4)), ("cam1", T_B_c1)):
        os.makedirs(os.path.join(mav, cam, "data"))
        with open(os.path.join(mav, cam, "sensor.yaml"), "w") as f:
            f.write(_sensor_yaml(tbs, ds.K, EUROC_HW[::-1]))
    stamps = []
    for k in range(N_FRAMES):
        pkt = ds[k]
        t_ns = 1403636579763555584 + int(round(k * 1e9 / 30))
        stamps.append(t_ns)
        for cam, key in (("cam0", "images"), ("cam1", "images_right")):
            rgb = pkt[key].astype(np.float64)
            gray = np.round(rgb @ [0.299, 0.587, 0.114]).astype(np.uint8)
            write_png(os.path.join(mav, cam, "data", f"{t_ns}.png"), gray)
            csv[cam].append(f"{t_ns},{t_ns}.png")
        c2w = pkt["poses"].astype(np.float64)
        tq = se3.from_matrix(torch.as_tensor(c2w)).tolist()
        gt.append(f"{t_ns},{tq[0]},{tq[1]},{tq[2]},{tq[6]},{tq[3]},{tq[4]},"
                  f"{tq[5]},0,0,0,0,0,0,0,0,0")
    for cam, lines in csv.items():
        with open(os.path.join(mav, cam, "data.csv"), "w") as f:
            f.write("\n".join(lines) + "\n")
    os.makedirs(os.path.join(mav, "state_groundtruth_estimate0"))
    with open(os.path.join(mav, "state_groundtruth_estimate0", "data.csv"),
              "w") as f:
        f.write("\n".join(gt) + "\n")
    os.makedirs(os.path.join(mav, "imu0"))
    with open(os.path.join(mav, "imu0", "sensor.yaml"), "w") as f:
        f.write(_IMU_YAML)
    imu = ["#timestamp [ns],w_RS_S_x [rad s^-1],w_RS_S_y [rad s^-1],"
           "w_RS_S_z [rad s^-1],a_RS_S_x [m s^-2],a_RS_S_y [m s^-2],"
           "a_RS_S_z [m s^-2]"]
    for t in range(stamps[0] - 5_000_000, stamps[-1] + 5_000_001, 5_000_000):
        imu.append(f"{t},0.0,0.0,0.0,0.0,0.0,9.81")
    with open(os.path.join(mav, "imu0", "data.csv"), "w") as f:
        f.write("\n".join(imu) + "\n")
    return os.path.dirname(mav)


def tum_phase(tmp: str, h_ref: dict) -> dict:
    """(k) The CLI on the TUM-layout rendering with --rgbd and the
    Sigma-TSDF map; the loader gives 384x512 frames."""
    t0 = time.perf_counter()
    d = write_tum(tmp)
    write_s = time.perf_counter() - t0
    res, launches, fe = cli_run(["--dataset_name", "tum", "--dataset_dir", d,
                                 "--rgbd", "--fusion", "sigma"])
    q = check_tracking("k", fe, launches)
    log(f"(k) CLI --dataset_name tum --rgbd --fusion sigma, {TUM_HW[0]}x"
        f"{TUM_HW[1]} PNGs (written in {write_s:.2f} s) read at "
        f"{fe.H}x{fe.W}: {q['n_kf']} keyframes, {res['kf_per_s']:.4f} "
        f"keyframes/s ({res['wall_s']:.2f} s; data stage "
        f"{res['data_mean_ms']:.1f} ms a frame), ATE-RMSE Sim(3)-aligned "
        f"{q['ate']:.4f} m (scale {q['scale']:.4f}), SE(3)-aligned "
        f"{q['ate_se3']:.4f} m; path (h) RGB-D at {H}x{W}: {h_ref['ate']:.4f}"
        f" m (scale {h_ref['scale']:.4f}); launches {launches}")
    if (fe.H, fe.W) != TUM_OUT_HW:
        raise RuntimeError(f"(k) the TUM loader gave {fe.H}x{fe.W}")
    return {"launches": launches, "dir": d}


def euroc_phase(tmp: str, g_ref: dict) -> dict:
    """(l) The CLI on the EuRoC-layout stereo rendering, rectified to
    336x640, --stereo without a map."""
    from nerf_slam_tpu_torch.datasets import build_dataset
    t0 = time.perf_counter()
    root = write_euroc(tmp)
    write_s = time.perf_counter() - t0
    baseline = build_dataset("euroc", root, height=H, width=W,
                             stereo=True).baseline
    res, launches, fe = cli_run(["--dataset_name", "euroc", "--dataset_dir",
                                 root, "--stereo", "--height", str(H),
                                 "--width", str(W), "--fusion", "none"])
    q = check_tracking("l", fe, launches)
    n_stereo = int((fe.graph.ii == fe.graph.jj).sum())
    log(f"(l) CLI --dataset_name euroc --stereo, {EUROC_HW[0]}x{EUROC_HW[1]}"
        f" PNGs (written in {write_s:.2f} s) rectified to {fe.H}x{fe.W}: "
        f"baseline recovered {baseline:.6f} m (rig {STEREO_BASELINE}), "
        f"{n_stereo} (i, i) edges in the final graph, {q['n_kf']} keyframes,"
        f" {res['kf_per_s']:.4f} keyframes/s ({res['wall_s']:.2f} s; data "
        f"stage {res['data_mean_ms']:.1f} ms a frame), "
        f"ATE-RMSE Sim(3)-aligned {q['ate']:.4f} m (scale {q['scale']:.4f}),"
        f" SE(3)-aligned {q['ate_se3']:.4f} m; path (g) stereo at {H}x{W}: "
        f"{g_ref['ate']:.4f} m (scale {g_ref['scale']:.4f}); launches "
        f"{launches}")
    if not abs(baseline - STEREO_BASELINE) <= 1e-4:
        raise RuntimeError(f"(l) baseline {baseline} m, not "
                           f"{STEREO_BASELINE} within 1e-4")
    if n_stereo == 0:
        raise RuntimeError("(l) no (i, i) stereo edges in the graph")
    return {"launches": launches}


def resume_phase(dev, frames, first, train_set, tmp: str) -> None:
    """(m) The production tracker saved after keyframe RESUME_KF, loaded
    into a fresh tracker and run to the end, against the sequential run;
    a PE field saved after 500 iterations on the sequential run's
    keyframes and resumed to 1000, against an uninterrupted 1000-iteration
    fit."""
    from nerf_slam_tpu_torch.fusion import NerfFusion, NerfFusionConfig
    from nerf_slam_tpu_torch.utils import checkpoint
    path = os.path.join(tmp, "frontend.npz")
    fe = build_frontend(dev, W)
    k = 0
    while fe.kf_idx <= RESUME_KF and not fe.stop:
        fe(k, frames[k])
        k += 1
    if fe.stop:
        raise RuntimeError(f"(m) the sequence ended before keyframe "
                           f"{RESUME_KF}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    checkpoint.save_frontend(path, fe)
    save_s = time.perf_counter() - t0
    size = os.path.getsize(path) / 2 ** 20
    del fe
    torch.cuda.empty_cache()
    fe = build_frontend(dev, W)
    t0 = time.perf_counter()
    checkpoint.load_frontend(path, fe)
    load_s = time.perf_counter() - t0
    while k < len(frames) and not fe.stop:
        fe(k, frames[k])
        k += 1
    same = same_bits(first, tracker_result(fe))
    log(f"(m) tracker saved after keyframe {RESUME_KF} (frame "
        f"{fe.kf_idx_to_f_idx[RESUME_KF]}; {size:.1f} MiB, save {save_s:.2f} "
        f"s, load {load_s:.2f} s), "
        f"resumed to frame {k - 1}: keyframes, poses and depths bit-identical "
        f"to the sequential run: {same}")
    del fe
    os.remove(path)
    torch.cuda.empty_cache()
    if not same:
        raise RuntimeError("(m) the resumed tracker differs from the "
                           "sequential run")

    def field():
        f = NerfFusion(NerfFusionConfig(buffer=BUFFER, height=H, width=W,
                                        batch_rays=4096), seed=SEED,
                       device=dev)
        f.train_set, f.has_data = train_set, True
        return f

    whole = field()
    whole.fit_volume(1000)
    half = field()
    half.fit_volume(500)
    path = os.path.join(tmp, "nerf.npz")
    checkpoint.save_nerf(path, half)
    resumed = NerfFusion(NerfFusionConfig(buffer=BUFFER, height=H, width=W,
                                          batch_rays=4096), seed=SEED + 7,
                         device=dev)
    checkpoint.load_nerf(path, resumed)
    resumed.fit_volume(500)
    same = field_digest(whole) == field_digest(resumed)
    log(f"(m) PE field saved after 500 iterations "
        f"({os.path.getsize(path) / 2 ** 20:.1f} MiB) and resumed to "
        f"{resumed.iteration}: field bits equal to an uninterrupted "
        f"{whole.iteration}-iteration fit: {same}")
    os.remove(path)
    if not same:
        raise RuntimeError("(m) the resumed field differs from the "
                           "uninterrupted fit")


def profile_phase(tum_dir: str) -> dict:
    """(o) (k)'s first PROFILE_FRAMES frames once more, --profile --fusion
    none: the torch.profiler trace must exist and name kernel #1's device
    function."""
    from nerf_slam_tpu_torch.utils.runtime import default_trace_dir
    trace_dir = default_trace_dir()
    before = set(os.listdir(trace_dir)) if os.path.isdir(trace_dir) else set()
    res, launches, fe = cli_run(["--dataset_name", "tum", "--dataset_dir",
                                 tum_dir, "--rgbd", "--fusion", "none",
                                 "--final_k", str(PROFILE_FRAMES),
                                 "--profile"])
    check_tracking("o", fe, launches)
    new = sorted(set(os.listdir(trace_dir)) - before)
    if len(new) != 1:
        raise RuntimeError(f"(o) expected one new trace in {trace_dir}, "
                           f"found {new}")
    path = os.path.join(trace_dir, new[0])
    with open(path) as f:
        text = f.read()
    # the device function of #1 (gated, bf16 out); #2 is <float, true>
    k1 = text.count("corr_lookup_grouped4_kernel<__nv_bfloat16, false>")
    log(f"(o) CLI (k), its first {PROFILE_FRAMES} frames, with --profile "
        f"--fusion none: {fe.kf_idx + 1} keyframes, {res['wall_s']:.2f} s "
        f"under the profiler, trace {len(text) / 2 ** 20:.1f} MiB, "
        f"{text.count('"cat": "kernel"')} kernel events, {k1} naming "
        f"kernel #1's corr_lookup_grouped4_kernel<__nv_bfloat16, false> "
        f"(counted launches {launches['corr_lookup_grouped4']})")
    os.remove(path)
    if k1 == 0:
        raise RuntimeError("(o) the trace names no launch of kernel #1")
    return {"launches": launches}


def replica_phase(frames, tmp: str) -> None:
    """The production frames in the Replica layout (JPEG color, 16-bit
    depth PNGs, traj.txt, cam_params.json), tracked by the CLI, where a
    JPEG codec (OpenCV or Pillow) is installed."""
    from nerf_slam_tpu_torch.datasets.image_io import (jpeg_decoder_available,
                                                       write_png)
    if not jpeg_decoder_available():
        log("Replica: not run on this machine: its JPEG color frames need "
            "OpenCV (cv2) or Pillow (PIL), and neither imports here")
        return
    d = os.path.join(tmp, "replica", "room0")
    os.makedirs(os.path.join(d, "results"))
    try:
        import cv2

        def write_jpg(path, rgb):
            cv2.imwrite(path, np.ascontiguousarray(rgb[..., ::-1]),
                        [cv2.IMWRITE_JPEG_QUALITY, 95])
    except ImportError:
        from PIL import Image

        def write_jpg(path, rgb):
            Image.fromarray(rgb).save(path, quality=95)
    traj = []
    for k, pkt in enumerate(frames):
        write_jpg(os.path.join(d, "results", f"frame{k:06d}.jpg"),
                  pkt["images"])
        write_png(os.path.join(d, "results", f"depth{k:06d}.png"),
                  np.clip(np.round(pkt["depths"] * 6553.5), 0,
                          65535).astype(np.uint16))
        gl = pkt["poses"].astype(np.float64).copy()
        gl[:3, 1:3] *= -1                      # OpenCV -> OpenGL axes
        traj.append(" ".join(f"{v:.9f}" for v in gl.reshape(-1)))
    with open(os.path.join(d, "traj.txt"), "w") as f:
        f.write("\n".join(traj) + "\n")
    K = frames[0]["intrinsics"]
    with open(os.path.join(os.path.dirname(d), "cam_params.json"), "w") as f:
        json.dump({"camera": {"w": W, "h": H, "fx": float(K[0]),
                              "fy": float(K[1]), "cx": float(K[2]),
                              "cy": float(K[3]), "scale": 6553.5}}, f)
    res, launches, fe = cli_run(["--dataset_name", "replica",
                                 "--dataset_dir", d, "--fusion", "none"])
    q = check_tracking("replica", fe, launches)
    log(f"Replica: CLI --dataset_name replica on the production frames "
        f"written as JPEG + 16-bit PNG at {H}x{W}: {q['n_kf']} keyframes, "
        f"{res['kf_per_s']:.4f} keyframes/s (data stage "
        f"{res['data_mean_ms']:.1f} ms a frame), ATE-RMSE {q['ate']:.4f} m, "
        f"launches {launches}")


class _Recorder:
    """An inertial frontend that keeps what it was given (the IMU rows,
    the frame's ground-truth pose) and forwards the call."""

    def __init__(self, inner):
        self.inner = inner
        self.packets = []

    def __call__(self, batch):
        self.packets.append({"k": batch["k"],
                             "imu_t0_t1": batch.get("imu_t0_t1"),
                             "poses": np.asarray(batch["poses"]),
                             "is_last_frame": batch.get("is_last_frame")})
        return self.inner(batch)


class _NoVisualFrontend:
    """VioSLAM's visual-frontend contract without the tracker (the CPU
    replay of the inertial chain)."""

    def __call__(self, k, packet):
        return None

    def stop_condition(self):
        return False


def vio_phase() -> dict:
    """(p) ``slam_demo --vio`` on the production frames: one inertial state
    a packet the SLAM stage takes, an incremental backend (relinearized and reused factors), a
    finite estimate, the tracker's keyframes, poses and depths equal to
    the same run without ``--vio`` to the bit; the inertial chain replayed
    on the CPU from the same packets within VIO_TOL of the card's."""
    from nerf_slam_tpu_torch.cli import slam_demo
    from nerf_slam_tpu_torch.geometry import se3
    from nerf_slam_tpu_torch.slam import (NavState,
                                          PreIntegrationInertialFrontend,
                                          VioSLAM)
    from nerf_slam_tpu_torch.solver.factor_graph import Key

    built, backend_s = [], []
    build = slam_demo.build_tracker

    def build_recorded(*a):
        vio = build(*a)
        inner = vio.inertial_frontend
        vio.init = NavState(pose=inner.state.pose.copy(),
                            vel=inner.state.vel.copy())
        vio.inertial_frontend = _Recorder(inner)
        update = vio.backend.update

        def timed(*u):
            sync()
            t0 = time.perf_counter()
            out = update(*u)
            sync()
            backend_s.append(time.perf_counter() - t0)
            return out
        vio.backend.update = timed
        built.append(vio)
        return vio

    base = ["--height", str(H), "--width", str(W), "--n_frames",
            str(N_FRAMES), "--fusion", "none"]
    slam_demo.build_tracker = build_recorded
    try:
        res, launches, fe = cli_run(base + ["--vio"])
    finally:
        slam_demo.build_tracker = build
    vio = built[0]
    stats = dict(vio.backend.stats)
    est = vio.backend.estimate
    keys = est.keys()
    # one inertial state a packet the SLAM stage took (it ends when the
    # tracker's keyframe buffer is full, in JAX as in the port)
    n_pkt = len(vio.inertial_frontend.packets)
    if not (res["vio_states"] == n_pkt == stats["updates"]
            and res["vio_relinearized"] > 0 and stats["reused"] > 0):
        raise RuntimeError(f"(p) VIO states {res['vio_states']} of {n_pkt} "
                           f"packets, stats {stats}")
    if not all(torch.isfinite(est.at(k)).all() for k in keys):
        raise RuntimeError("(p) non-finite VIO estimate")
    check_tracking("p", fe, launches)
    res0, launches0, fe0 = cli_run(base)
    if not same_bits(tracker_result(fe), tracker_result(fe0)):
        raise RuntimeError("(p) the tracker under --vio differs from the "
                           "run without it")

    # the inertial chain again on the CPU, from the same packets
    packets = vio.inertial_frontend.packets
    inner = vio.inertial_frontend.inner
    cpu = VioSLAM(_NoVisualFrontend(), PreIntegrationInertialFrontend(
        inner.calib, vio.init), device="cpu")
    t0 = time.perf_counter()
    for pkt in packets:
        cpu(pkt)
    cpu_s = time.perf_counter() - t0
    ce = cpu.backend.estimate
    dpos = max(float((est.at(k)[:3].cpu() - ce.at(k)[:3]).norm())
               for k in keys if k.name == "x")
    drot = max(float(se3.log_so3(se3.quat_mul(
        se3.quat_inv(ce.at(k)[3:7]), est.at(k)[3:7].cpu())).norm())
        for k in keys if k.name == "x")
    dvel = max(float((est.at(k).cpu() - ce.at(k)).abs().max())
               for k in keys if k.name == "v")
    if not (dpos <= VIO_TOL and drot <= VIO_TOL):
        raise RuntimeError(f"(p) card vs CPU inertial chain: {dpos} m, "
                           f"{drot} rad")
    gt_err = max(float(np.linalg.norm(est.at(Key("x", p["k"]))[:3].cpu()
                                      .numpy() - p["poses"][:3, 3]))
                 for p in packets)
    log(f"(p) CLI --vio {H}x{W}: {res['n_keyframes']} keyframes, "
        f"{res['vio_states']} inertial states ({n_pkt} packets of "
        f"{N_FRAMES} frames reached the SLAM stage), backend relinearized "
        f"{stats['relinearized']} / reused {stats['reused']} factors over "
        f"{stats['updates']} updates; the tracker equal to the run "
        f"without --vio to the bit (ATE-RMSE {res['ate_rmse_m']:.6f} m); "
        f"largest VIO position error vs ground truth {gt_err:.6e} m; "
        f"backend {1e3 * sum(backend_s) / len(packets):.2f} ms a frame on "
        f"the card (first {1e3 * backend_s[0]:.1f}, median "
        f"{1e3 * float(np.median(backend_s)):.1f}, last "
        f"{1e3 * backend_s[-1]:.1f} ms), {1e3 * cpu_s / len(packets):.2f} "
        f"ms on the CPU; card "
        f"vs CPU chain: position {dpos:.3e} m, rotation {drot:.3e} rad, "
        f"velocity {dvel:.3e} m/s; launches #1 / #2 "
        f"{launches['corr_lookup_grouped4']} / "
        f"{launches['corr_lookup_pyramid']}")
    return {"launches": launches}


def training_phase(tmp: str) -> None:
    """(q) The trainer on the card: TRAIN_STEPS optimizer steps of p2b,
    twice from weights_synthetic.npz, bit-equal; one step of p4b from the
    result; those weights tracked through the CLI (ATE-RMSE at most
    ATE_LIMIT_M); a droid.pth-named state dict through ``--weights``."""
    from nerf_slam_tpu_torch.cli import train_droid_synthetic as trainer
    from nerf_slam_tpu_torch.models import DroidNet, load_flax_weights
    from nerf_slam_tpu_torch.models.weights import to_reference
    from nerf_slam_tpu_torch.utils.checkpoint import load_arrays

    specs = {s["name"]: s for s in trainer.PHASES["stable"]}
    out = {}
    for tag, name, init, over in (
            ("a", "p2b", WEIGHTS, TRAIN_CUT["p2b"]),
            ("b", "p2b", WEIGHTS, TRAIN_CUT["p2b"]),
            ("c", "p4b", None, TRAIN_CUT["p4b"])):
        spec = {**specs[name], **over}
        path = os.path.join(tmp, f"train_{tag}.npz")
        sync()
        t0 = time.perf_counter()
        summary = trainer.run_phase(spec, init or out["a"][0], path,
                                    device=DEVICE, log=lambda s: None)
        wall = time.perf_counter() - t0
        m = summary["metrics"]
        log(f"(q) train {name} {spec['H']}x{spec['W']} x{spec['frames']} "
            f"frames, {spec['steps']} steps x {spec['accum']} scenes "
            f"({spec['scenes']} scenes, {spec['holdout']} held out): loss "
            f"{m['loss']:.6f} (geo {m['geodesic']:.6f}), gradients finite "
            f"{summary['grads_finite']}, {summary['s_per_grad']:.3f} s a "
            f"scene-gradient, {summary['s_per_step']:.3f} s an optimizer "
            f"step, peak memory {summary['peak_mem_gib']} GiB, phase "
            f"wall {wall:.1f} s")
        if not (summary["grads_finite"] and math.isfinite(m["loss"])):
            raise RuntimeError(f"(q) {name}: non-finite loss or gradients")
        out[tag] = (path, load_arrays(path)[0])
    fa, fb = out["a"][1], out["b"][1]
    differ = [k for k in fa if not np.array_equal(fa[k], fb[k])]
    if differ:
        raise RuntimeError(f"(q) two p2b runs differ in {len(differ)} of "
                           f"{len(fa)} tensors, e.g. {differ[:3]}")
    moved = sum(not np.array_equal(fa[k], load_arrays(WEIGHTS)[0][k])
                for k in fa)
    log(f"(q) the two p2b runs equal to the bit ({len(fa)} tensors, "
        f"{moved} moved from the warm start)")

    res, launches, _ = cli_run(["--height", str(H), "--width", str(W),
                                "--n_frames", str(N_FRAMES), "--fusion",
                                "none", "--weights", out["c"][0]])
    ate = res.get("ate_rmse_m", math.nan)
    log(f"(q) the trained weights through --weights: {res['n_keyframes']} "
        f"keyframes, ATE-RMSE {ate:.6f} m, {res['kf_per_s']:.4f} "
        f"keyframes/s")
    if not ate <= ATE_LIMIT_M:
        raise RuntimeError(f"(q) ATE-RMSE {ate} m > {ATE_LIMIT_M}")

    net = load_flax_weights(DroidNet(dtype=torch.float32),
                            load_arrays(WEIGHTS)[0])
    pth = os.path.join(tmp, "droid.pth")
    torch.save(to_reference(net.state_dict()), pth)
    res, launches, fe = cli_run(["--height", str(H), "--width", str(W),
                                 "--n_frames", str(N_FRAMES), "--fusion",
                                 "none", "--weights", pth])
    want = net.state_dict()
    if not all(torch.equal(v.cpu(), want[k].to(v.dtype))
               for k, v in fe.net.state_dict().items()):
        raise RuntimeError("(q) droid.pth weights differ from the source")
    log(f"(q) droid.pth through --weights: {res['n_keyframes']} keyframes, "
        f"ATE-RMSE {res.get('ate_rmse_m', math.nan):.6f} m (no damping "
        f"sidecar: the tracker's default damping), launches #1 / #2 "
        f"{launches['corr_lookup_grouped4']} / "
        f"{launches['corr_lookup_pyramid']}")


# (r): the sharded tracker's shard count, the rays of the data-parallel
# step (NerfFusion's batch), and the card-vs-CPU limit of the two steps
SHARDS, DP_RAYS, PAR_TOL = 2, 4096, 1e-4


def dba_problem(gen):
    """One Gauss-Newton problem at the production cell's widths, on the
    CPU: BUFFER keyframes of (H/8, W/8) inverse depths, 2 * E_ACTIVE edge
    slots filled with edges between keyframes 1-3 apart, flow targets
    from the true poses, the poses perturbed (keyframe 0 fixed), the
    depth damping 1e-2, about what the production tracker applies (the
    GRU's 0.01 softplus times the weights' scale 1.0, plus 1e-4).  (With
    parallel.tracking.dryrun's 1e-4 the step's f32 rounding alone reaches
    4.5e-5 against an f64 solve on the CPU, and two f32 machines differ
    by twice that.)"""
    from nerf_slam_tpu_torch.geometry import camera, se3
    from nerf_slam_tpu_torch.solver import dba

    n, h, w, E = BUFFER, H // 8, W // 8, 2 * E_ACTIVE
    pairs = [(i, i + d) for d in (1, 2, 3) for i in range(n - d)]
    pairs += [(j, i) for i, j in pairs]
    ii, jj = (np.array(x[:E]) for x in zip(*pairs))
    poses_gt = se3.exp(torch.cat([0.3 * torch.randn((n, 3), generator=gen),
                                  0.05 * torch.randn((n, 3), generator=gen)],
                                 -1))
    disps = 0.5 + 0.5 * torch.rand((n, h, w), generator=gen)
    intr = torch.tensor([[w * 0.9, w * 0.9, w / 2, h / 2]]).repeat(n, 1)
    target, valid, _ = camera.projective_transform(
        poses_gt, disps, intr, torch.as_tensor(ii), torch.as_tensor(jj))
    noise = 0.01 * torch.randn((n, 6), generator=gen)
    noise[0] = 0.0
    targets, weights = torch.zeros((2, E, h, w, 2))
    targets[:len(ii)] = target
    weights[:len(ii)] = valid
    args = (se3.retr(poses_gt, noise), disps, intr, targets, weights,
            1e-2 * torch.ones((n, h, w)), torch.zeros((n, h, w)))
    return args, dba.plan(ii, jj, 0, n, E=E, P=n, K=n, device="cpu")


def plan_on(plan, device):
    """A DBA plan's tensors on ``device``."""
    return type(plan)(*[v if v is None else v.to(device) for v in plan])


def wall_ms(fn, reps: int = 5) -> float:
    """Host-clock ms a call of ``fn`` takes to its end on the card (launch
    cost included), after one warm-up."""
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync()
    return 1e3 * (time.perf_counter() - t0) / reps


def parallel_steps(dev) -> None:
    """(r) The sharded DBA step and the data-parallel NGP step, SHARDS
    shards each, at the production widths, on the card and on the CPU
    from the same inputs: the DBA's poses and depths within PAR_TOL; the
    NGP loss within PAR_TOL relative and the shards' mean gradient within
    PAR_TOL of each tensor's largest, the field computing in f32 on both
    (the Adam step that follows is the library's)."""
    from nerf_slam_tpu_torch.fusion.ngp import (NGPConfig, PEField,
                                                draw_ray_samples)
    from nerf_slam_tpu_torch.parallel import mapping, tracking
    from nerf_slam_tpu_torch.solver import dba

    gen = torch.Generator().manual_seed(SEED)
    args, plan = dba_problem(gen)
    out = []
    for d in (dev, torch.device("cpu")):
        step = tracking.make_sharded_dba_step([d] * SHARDS)
        out.append([t.cpu() for t in step(*[a.to(d) for a in args],
                                          plan_on(plan, d))])
    gp, ga = plan_on(plan, dev), [a.to(dev) for a in args]
    sharded_ms = wall_ms(lambda: tracking.make_sharded_dba_step(
        [dev] * SHARDS)(*ga, gp))
    single_ms = wall_ms(lambda: dba.dba_iterations(*ga, gp, iters=1))
    err = [float((a - b).abs().max()) for a, b in zip(*out)]
    log(f"(r) sharded DBA step, {SHARDS} shards of {2 * E_ACTIVE} edges, "
        f"{BUFFER} keyframes of {H // 8}x{W // 8}: card vs CPU max |d pose| "
        f"{err[0]:.3e}, |d disp| {err[1]:.3e}; {sharded_ms:.2f} ms a step on "
        f"the card, host clock (unsharded {single_ms:.2f} ms)")
    if not max(err) <= PAR_TOL:
        raise RuntimeError(f"(r) sharded DBA step, card vs CPU: {err}")

    cfg = NGPConfig()
    rays = DP_RAYS // SHARDS
    batch = {"origins": 0.5 + 0.1 * torch.randn((DP_RAYS, 3), generator=gen),
             "dirs": 0.3 * torch.randn((DP_RAYS, 3), generator=gen)
             + torch.tensor([0.0, 0.0, 1.0]),
             "rgb": torch.rand((DP_RAYS, 3), generator=gen),
             "depth": torch.where(torch.rand(DP_RAYS, generator=gen) > 0.3,
                                  0.2 + 0.7 * torch.rand(DP_RAYS,
                                                         generator=gen),
                                  torch.zeros(DP_RAYS)),
             "depth_w": torch.ones(DP_RAYS)}
    draws = [draw_ray_samples(rays, cfg, mapping.shard_generator(SEED, s,
                                                                 "cpu"),
                              "cpu") for s in range(SHARDS)]
    res = []
    for d in (dev, torch.device("cpu")):
        field = PEField(cfg, compute_dtype=torch.float32,
                        generator=torch.Generator().manual_seed(SEED)).to(d)
        step = mapping.make_dp_train_step(
            [d] * SHARDS, field, cfg,
            torch.optim.Adam(field.parameters(), lr=cfg.pe_lr))
        sync()
        t0 = time.perf_counter()
        loss = float(step(batch, SEED, draws))
        sync()
        res.append((loss, [p.grad.cpu() for p in field.parameters()],
                    [p.detach().cpu() for p in field.parameters()],
                    1e3 * (time.perf_counter() - t0)))
    (lg, gg, pg, ms_g), (lc, gc, pc, ms_c) = res
    g_err = max(float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
                for a, b in zip(gg, gc))
    p_err = max(float((a - b).abs().max()) for a, b in zip(pg, pc))
    log(f"(r) data-parallel step, {SHARDS} shards of {rays} rays, PE field "
        f"in f32: loss card {lg:.7f} / CPU {lc:.7f}, mean gradient within "
        f"{g_err:.3e} of each tensor's largest, parameters after the Adam "
        f"step within {p_err:.3e}; {ms_g:.1f} ms on the card, {ms_c:.1f} "
        f"ms on the CPU")
    if not (abs(lg - lc) <= PAR_TOL * abs(lc) and g_err <= PAR_TOL):
        raise RuntimeError(f"(r) data-parallel step, card vs CPU: loss "
                           f"{lg} / {lc}, gradients {g_err}")


def parallel_phase(dev) -> dict:
    """(r) The production tracker alone with edge_shards=SHARDS on one
    card, in turns with the unsharded tracker (unsharded, sharded,
    sharded, unsharded; fresh state each): the same keyframes, ATE-RMSE
    at most ATE_LIMIT_M, each configuration's two runs equal to the bit,
    kernel #1 launched SHARDS times as often and #2 as often; then the
    two sharded steps (:func:`parallel_steps`) and the CLI
    (:func:`parallel_cli`)."""
    frames = synthetic_frames(W)
    runs = {1: [], SHARDS: []}
    for shards in (1, SHARDS, SHARDS, 1):
        fe, sink, wall, launches = track_only(
            dev, frames, W, {"edge_shards": shards} if shards > 1 else {})
        runs[shards].append((tracker_result(fe), trajectory_error(sink),
                             wall, launches))
        del fe, sink
        torch.cuda.empty_cache()
    (ref, ate0, _, launches0), (got, ate, _, launches) = \
        runs[1][0], runs[SHARDS][0]
    n0, n = ref[0].numel(), got[0].numel()
    gap = (float((got[1] - ref[1]).abs().max()) if n == n0
           else math.nan)
    repeat = {k: same_bits(v[0][0], v[1][0]) for k, v in runs.items()}
    walls = {k: [f"{r[2]:.2f}" for r in v] for k, v in runs.items()}
    log(f"(r) tracker edge_shards={SHARDS} on {torch.cuda.device_count()} "
        f"card(s), {H}x{W}: {n} keyframes (unsharded {n0}), ATE-RMSE "
        f"{ate:.6f} m (unsharded {ate0:.6f} m, gap {ate - ate0:+.6f} m), "
        f"largest pose gap {gap:.3e}; wall s in turns: unsharded "
        f"{walls[1][0]}, sharded {' and '.join(walls[SHARDS])}, unsharded "
        f"{walls[1][1]}; each configuration's two runs bit-identical: "
        f"{repeat}; launches {launches} (unsharded {launches0})")
    if n != n0:
        raise RuntimeError(f"(r) {n} keyframes sharded, {n0} unsharded")
    if not ate <= ATE_LIMIT_M:
        raise RuntimeError(f"(r) ATE-RMSE {ate} m > {ATE_LIMIT_M}")
    if not all(repeat.values()):
        raise RuntimeError(f"(r) a tracker is not reproducible: {repeat}")
    k1, k2 = "corr_lookup_grouped4", "corr_lookup_pyramid"
    if not (launches[k1] == SHARDS * launches0[k1] > 0
            and launches[k2] == launches0[k2] > 0):
        raise RuntimeError(f"(r) launches {launches}, unsharded "
                           f"{launches0}")
    parallel_steps(dev)
    parallel_cli(dev)
    return {"launches": launches}


def parallel_cli(dev) -> None:
    """(r) The CLI with ``--edge_shards SHARDS --fusion nerf --eval``
    (ATE-RMSE at most ATE_LIMIT_M), and with ``--device_split
    --parallel_run``: mapping on the second card where there is one, else
    JAX's single-device line and mapping beside tracking."""
    from nerf_slam_tpu_torch.cli import slam_demo

    base = ["--height", str(H), "--width", str(W), "--n_frames",
            str(N_FRAMES), "--fusion", "nerf"]
    res, cli_launches, fe = cli_run(base + ["--eval", "--edge_shards",
                                            str(SHARDS)])
    check_tracking("r", fe, cli_launches)
    cli_ate = res.get("ate_rmse_m", math.nan)
    log(f"(r) CLI --edge_shards {SHARDS} --fusion nerf --eval: "
        f"{res['n_keyframes']} keyframes, {res['kf_per_s']:.4f} keyframes/s"
        f", ATE-RMSE {cli_ate:.6f} m, PSNR {res.get('fusion_psnr')}, "
        f"launches {cli_launches}")
    if not cli_ate <= ATE_LIMIT_M:
        raise RuntimeError(f"(r) CLI --edge_shards ATE-RMSE {cli_ate} m")
    del fe
    torch.cuda.empty_cache()

    built, lines = [], io.StringIO()
    build = slam_demo.build_fusion
    slam_demo.build_fusion = lambda a: built.append(build(a)) or built[-1]
    try:
        with contextlib.redirect_stdout(lines):
            res, _, _ = cli_run(base + ["--device_split", "--parallel_run"])
    finally:
        slam_demo.build_fusion = build
    fusion = built[0][0]
    n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
    want = "cuda:1" if n_dev >= 2 else str(torch.empty(0, device=dev).device)
    where = {str(p.device) for p in fusion.field.parameters()}
    fell_back = "falling back to shared-device scheduling" in \
        lines.getvalue()
    log(f"(r) CLI --device_split --parallel_run on {n_dev} device(s) of "
        f"the type: mapping parameters on "
        f"{sorted(where)}, {fusion.iteration} NGP iterations, "
        f"{res['kf_per_s']:.4f} keyframes/s, single-device line printed: "
        f"{fell_back}")
    if where != {want} or fell_back != (n_dev < 2) or fusion.iteration <= 0:
        raise RuntimeError(f"(r) --device_split: mapping on {where}, "
                           f"expected {want}; line printed {fell_back}")


def _http_get(port: int, path: str) -> bytes:
    import urllib.request
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as r:
        return r.read()


def gui_phase(tmp: str) -> dict:
    """(s) The CLI with ``--gui --viewer_port <free port> --fusion nerf`` on
    the production frames, in a temporary working directory (the mesh end
    command writes there): the viewer's state, JPEGs and cloud, a command
    sent over HTTP reaching the GUI, the exports under ``--viz_out``, the
    mesh; keyframes/s with and without the GUI, and the GUI's export and
    publish times.  Fails where neither OpenCV nor Pillow imports (the
    viewer's constructor says so)."""
    import socket

    from nerf_slam_tpu_torch import gui
    from nerf_slam_tpu_torch.utils.evaluation import load_mesh

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    viz = os.path.join(tmp, "viz")
    viewers, times = [], {"export": [], "publish": []}
    viewer_cls, export, publish = (gui.LiveViewer, gui.HeadlessGui.export,
                                   gui.LiveViewer._publish)

    def timer(name, fn):
        def run(self, *a):
            sync()
            t0 = time.perf_counter()
            out = fn(self, *a)
            times[name].append(time.perf_counter() - t0)
            return out
        return run

    gui.LiveViewer = lambda *a, **k: viewers.append(
        viewer_cls(*a, **k)) or viewers[-1]
    gui.HeadlessGui.export = timer("export", export)
    viewer_cls._publish = timer("publish", publish)
    cwd = os.getcwd()
    os.chdir(tmp)
    base = ["--height", str(H), "--width", str(W), "--n_frames",
            str(N_FRAMES), "--fusion", "nerf"]
    try:
        res, launches, fe = cli_run(base + ["--gui", "--viewer_port",
                                            str(port), "--viz_out", viz])
        v = viewers[0]
        n_kf = res["n_keyframes"]
        state = json.loads(_http_get(port, "/state.json"))
        kfs = [t["kf"] for t in state["trajectory"]]
        jpgs = {name: _http_get(port, f"/{name}.jpg")
                for name in ("kf", "depth", "sigma")}
        cloud = _http_get(port, "/cloud.ply")
        _http_get(port, "/cmd?name=sigma_thresh&value=3.5")
        cmds = v.pop_commands()
        v.close()
        files = sorted(os.listdir(viz))
        mesh_path = os.path.join(tmp, "fusion_mesh.obj")
        verts = (load_mesh(mesh_path)[0] if os.path.exists(mesh_path)
                 else np.zeros((0, 3)))
        res0, _, _ = cli_run(base)
    finally:
        os.chdir(cwd)
        gui.LiveViewer = viewer_cls
        gui.HeadlessGui.export = export
        viewer_cls._publish = publish
    check_tracking("s", fe, launches)
    log(f"(s) CLI --gui --viewer_port {port} --fusion nerf {H}x{W}: "
        f"{n_kf} keyframes, {res['kf_per_s']:.4f} keyframes/s with the GUI, "
        f"{res0['kf_per_s']:.4f} without (gui stage {res['gui_mean_ms']:.1f}"
        f" ms a spin); {len(times['export'])} exports, "
        f"{1e3 * float(np.mean(times['export'])):.1f} ms each (first "
        f"{1e3 * times['export'][0]:.1f}, last {1e3 * times['export'][-1]:.1f}"
        f"); {len(times['publish'])} viewer publishes, "
        f"{1e3 * float(np.median(times['publish'])):.1f} ms median, "
        f"{1e3 * max(times['publish']):.1f} ms the largest; /state.json "
        f"{len(kfs)} trajectory entries over keyframes {sorted(set(kfs))[:3]}"
        f"...{sorted(set(kfs))[-1:]}; JPEG bytes "
        f"{ {k: len(b) for k, b in jpgs.items()} }, cloud.ply "
        f"{len(cloud)} bytes; commands {cmds}; exports {len(files)} files; "
        f"mesh {verts.shape[0]} vertices")
    if set(kfs[-n_kf:]) != set(range(n_kf)) or len(set(kfs)) != n_kf:
        raise RuntimeError(f"(s) /state.json keyframes {sorted(set(kfs))}, "
                           f"{n_kf} keyframes tracked")
    if not all(b[:2] == b"\xff\xd8" for b in jpgs.values()):
        raise RuntimeError("(s) the viewer's images are not JPEGs")
    if not cloud.startswith(b"ply"):
        raise RuntimeError("(s) /cloud.ply is no PLY")
    if not ({"cmd": "sigma_thresh", "value": 3.5} in cmds
            and v.gui.sigma_thresh == 3.5):
        raise RuntimeError(f"(s) the HTTP command did not reach the GUI: "
                           f"{cmds}")
    for prefix in ("cloud_", "depth_", "sigma_", "trajectory.json"):
        if not any(f.startswith(prefix) for f in files):
            raise RuntimeError(f"(s) no {prefix} export in {files}")
    if verts.shape[0] == 0:
        raise RuntimeError("(s) the mesh end command wrote no mesh")
    return {"launches": launches}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="smoke run of the port on one "
                                 "GPU")
    ap.add_argument("--only", default="",
                    help="comma-separated phases among p,q,r,s to run "
                         "alone (a partial run: no kernels or ok line)")
    only = [t for t in ap.parse_args(argv).only.split(",") if t]
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
    reports = build.build(["corr_lookup", "segment_sum"])
    log(f"kernel build: {time.perf_counter() - t0:.2f} s "
        f"({', '.join(reports) or 'cached'})")
    for name, rep in reports.items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    if only:
        with tempfile.TemporaryDirectory() as tmp:
            if "p" in only:
                vio_phase()
            if "q" in only:
                training_phase(tmp)
            if "r" in only:
                parallel_phase(dev)
            if "s" in only:
                gui_phase(tmp)
        log(f"chip_smoke: phases {only} passed in "
            f"{time.perf_counter() - t_start:.1f} s")
        return 0

    def mark(tag: str) -> None:
        torch.cuda.empty_cache()
        log(f"[{time.perf_counter() - t_start:.1f} s] {tag} done")

    entries = kernel_phase(dev)
    entries.append(segment_phase(dev))
    mark("kernels")
    launches, train_set, pe, frames, first = pipeline_phase(dev)
    mark("main path")
    launches.update(path_phase(dev))
    mark("(a)-(c)")
    sensors = sensor_phase(dev)
    mark("(g), (h)")
    with tempfile.TemporaryDirectory() as tmp:
        tsdf_phase(dev, tmp)
        mark("(d), (n)")
        cli_phase(dev)
        mark("(e)")
        # the second fit is held to the first's bits over its first chunk
        hash_phase(dev, train_set, pe, HASH_EVAL_EVERY)
        mark("(f)")
        mapper_phase(dev, train_set, pe)
        mark("(i)")
        paths = {"j": nerf_format_phase()}
        mark("(j)")
        paths["k"] = tum_phase(tmp, sensors["h"])
        mark("(k)")
        paths["l"] = euroc_phase(tmp, sensors["g"])
        mark("(l)")
        resume_phase(dev, frames, first, train_set, tmp)
        mark("(m)")
        paths["o"] = profile_phase(paths["k"]["dir"])
        mark("(o)")
        replica_phase(frames, tmp)
        mark("Replica")
        paths["p"] = vio_phase()
        mark("(p)")
        training_phase(tmp)
        mark("(q)")
        paths["r"] = parallel_phase(dev)
        mark("(r)")
        paths["s"] = gui_phase(tmp)
        mark("(s)")
    log("launches of kernels #1 / #2 on the new paths: " + ", ".join(
        f"({tag}) {p['launches']['corr_lookup_grouped4']} / "
        f"{p['launches']['corr_lookup_pyramid']}" for tag, p in paths.items()))
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
