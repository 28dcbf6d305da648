"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``nerf_slam_tpu_torch/ops/csrc``,
checks each against its plain PyTorch version at the tracking shapes of
the 336x640 production cell, times it beside its bound, then drives the
main path end to end: synthetic frames -> DataModule -> SlamModule
(RaftVisualFrontend, trained weights, motion filter 2.4 px, keyframe
rejection 4.0) -> FusionModule (PE-NeRF) -> EvalSink, as ``bench.py``
configures it.  One sequential run gives the quality numbers (ATE-RMSE,
PSNR after 2000 NGP iterations, as QUALITY.md measures them); one
threaded run, with the launch counters zeroed just before it, gives
keyframes/s and shows that the main path went through every kernel.

Output, in order: the card's name and power limit, the kernel build time,
one line per kernel check, the pipeline lines, the ``kernels`` JSON line,
and last ``{"ok": true, "device": {...}}``.  Any failure exits non-zero
without the ``ok`` line.  Needs a CUDA device; imports no JAX.
"""
from __future__ import annotations

import json
import math
import os
import statistics
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
NGP_HORIZON = 2000          # QUALITY.md: NGP iterations before PSNR
ATE_LIMIT_M = 0.25          # QUALITY.md 0.1835 m; random weights ~0.79 m
SEED = 0

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, fp32 (non-tensor) flop/s
PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOPS = 67e12

# kernel vs plain version: both evaluate the same f32 operations in the
# same order with round-to-nearest and no fused multiply-add, so they
# should agree bit for bit; the limits allow one ulp of the output type at
# the volumes' magnitude (|v| < 4): bf16 1.6e-2, f32 1e-5
TOL_BF16, TOL_F32 = 1.6e-2, 1e-5


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 30, warmup: int = 5) -> float:
    """Median of ``reps`` launches, each timed with CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events)


def lookup_traffic(coords, real_dims, slab_dims, out, n_act,
                   flops_per_tap_row):
    """Least bytes and flops of one lookup call on these inputs.

    Bytes: each active (edge, pixel, level) reads the in-bounds part of
    its 8x8 bf16 tap support once, plus its 8-byte coords; the whole
    output is written once.  Flops: the interpolation arithmetic per
    (active pixel-edge, level, window row)."""
    c = coords[:n_act].double()
    taps = 0.0
    for lvl in range(4):
        s = 2.0 ** lvl
        h_ok = min(real_dims[lvl][0], slab_dims[lvl][0])
        w_ok = min(real_dims[lvl][1], slab_dims[lvl][1])
        xi = torch.clamp(torch.floor(c[..., 0] / s) - 3, -8,
                         real_dims[lvl][1] + 8)
        yi = torch.clamp(torch.floor(c[..., 1] / s) - 3, -8,
                         real_dims[lvl][0] + 8)
        nx = torch.clamp(torch.minimum(xi + 8, torch.tensor(float(w_ok),
                         device=c.device)) - torch.clamp(xi, min=0), min=0)
        ny = torch.clamp(torch.minimum(yi + 8, torch.tensor(float(h_ok),
                         device=c.device)) - torch.clamp(yi, min=0), min=0)
        taps += float((nx * ny).sum())
    n_pix = c.shape[0] * c.shape[1] * c.shape[2]
    nbytes = taps * 2 + n_pix * 8 + out.numel() * out.element_size()
    flops = n_pix * 4 * 7 * flops_per_tap_row
    return nbytes, flops


def bound(nbytes: float, flops: float):
    t_b, t_f = nbytes / PEAK_BYTES_S, flops / PEAK_F32_FLOPS
    return 1e3 * max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")


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
        nb, fl = lookup_traffic(coords, dims, slab_dims, got,
                                N_ACT if gated else E_ACTIVE, 45)
        b_ms, b_by = bound(nb, fl)
        res[gated] = dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                          bound_by=b_by, bytes=nb)
        log(f"kernel corr_lookup_grouped4 gated={gated} E={E_ACTIVE} "
            f"n_act={N_ACT if gated else E_ACTIVE} {h}x{w}: max|err| {err:.3g}"
            f" (tol {tol}) {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}, {nb / 1e6:.1f} MB)")
    del slabs
    r = res[True]
    entries.append({
        "name": "corr_lookup_grouped4", "route": "cuda",
        "source": "nerf_slam_tpu_torch/ops/csrc/corr_lookup.cu",
        "replaces": "nerf_slam_tpu/ops/corr_pallas.py:500",
        "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
        "library_ms": None,
        "ungated": {k: res[False][k] for k in
                    ("err", "ms", "plain_ms", "bound_ms")}})

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
    nb, fl = lookup_traffic(coords, lv_dims, lv_dims, got, 1, 49)
    b_ms, b_by = bound(nb, fl)
    log(f"kernel corr_lookup_pyramid E=1 {h}x{w}: max|err| {err:.3g} (tol "
        f"{TOL_F32}) {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} "
        f"ms ({b_by}, {nb / 1e6:.2f} MB)")
    entries.append({
        "name": "corr_lookup_pyramid", "route": "cuda",
        "source": "nerf_slam_tpu_torch/ops/csrc/corr_lookup.cu",
        "replaces": "nerf_slam_tpu/ops/corr_pallas.py:165",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})
    return entries


def build_main_path(dev):
    """Frontend and fusion as bench.py builds its production cell."""
    from nerf_slam_tpu_torch.fusion import NerfFusion, NerfFusionConfig
    from nerf_slam_tpu_torch.models import DroidNet, load_flax_weights
    from nerf_slam_tpu_torch.tracking import (FrontendConfig,
                                              RaftVisualFrontend)
    from nerf_slam_tpu_torch.utils.checkpoint import load_arrays

    flat, meta = load_arrays(os.path.join(ROOT, "weights_synthetic.npz"))
    net = load_flax_weights(DroidNet(dtype=torch.bfloat16), flat)
    cfg = FrontendConfig(
        buffer=BUFFER, e_active=E_ACTIVE, e_inactive=E_ACTIVE,
        p_window=BUFFER, k_depth=BUFFER + 4, motion_filter_thresh=2.4,
        keyframe_thresh=4.0, damping_scale=float(meta["damping_scale"]),
        damping_offset=float(meta["damping_offset"]))
    frontend = RaftVisualFrontend(net, cfg, (H, W), device=dev)
    fusion = NerfFusion(NerfFusionConfig(buffer=BUFFER, height=H, width=W,
                                         batch_rays=4096, iters_per_spin=10),
                        seed=SEED, device=dev)
    return frontend, fusion


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


def pipeline_phase(dev):
    from nerf_slam_tpu_torch.datasets import SyntheticConfig, SyntheticDataset
    from nerf_slam_tpu_torch.ops import corr_lookup

    ds = SyntheticDataset(SyntheticConfig(n_frames=N_FRAMES, height=H,
                                          width=W))
    frames = [ds[k] for k in range(len(ds))]
    frontend, fusion = build_main_path(dev)

    # quality: the sequential run QUALITY.md's protocol uses
    wall, sink = run_pipeline(frames, frontend, fusion, parallel=False)
    ate_seq = trajectory_error(sink)
    n_kf_seq = frontend.kf_idx + 1
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
    missing = [k for k, n in launches.items() if n <= 0]
    if missing:
        raise RuntimeError(f"kernels not launched on the main path: "
                           f"{missing}")
    for name, a in (("sequential", ate_seq), ("threaded", ate)):
        if not a <= ATE_LIMIT_M:
            raise RuntimeError(f"{name} ATE-RMSE {a:.4f} m > {ATE_LIMIT_M}")
    return launches


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
    for e in entries:
        e["launches"] = launches[e["name"]]
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
