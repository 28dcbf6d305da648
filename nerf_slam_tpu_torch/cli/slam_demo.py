"""SLAM demo CLI of the PyTorch/CUDA port.

    python -m nerf_slam_tpu_torch.cli.slam_demo --weights weights_synthetic.npz \
        --height 336 --width 640 --n_frames 30 --buffer 24 --fusion sigma --eval

The JAX package's ``cli/slam_demo.py`` with the same flags and defaults:
dataset, keyframe buffer, stride, map backend (``--fusion nerf`` the
depth-supervised radiance field, ``sigma`` the uncertainty-weighted TSDF,
``tsdf`` the unweighted one, ``none``), sequential or ``--parallel_run``
(one thread per stage on one card).  ``--stereo`` tracks with the
dataset's right camera and the rig pose its packets carry (``stereo_rel``),
``--rgbd`` seeds metric inverse depths from the packets' depths,
``--vio`` adds the inertial chain (``VioSLAM``: IMU preintegration into
the incremental backend, beside the tracker) and reports ``vio_states``
and ``vio_relinearized``.
``--dataset_name nerf|tum|euroc|replica|realsense`` with ``--dataset_dir``
reads that format (EuRoC at ``--height`` x ``--width``, with ``--stereo``
rectified to a shared pinhole); ``--profile`` writes a ``torch.profiler``
trace of the run (``utils/runtime.profile_trace``: CPU ranges of the
thread that runs the stages, CUDA kernels of every thread).  It prints
one JSON line: wall time, keyframes and keyframes/s, each stage's mean
spin time, ATE-RMSE against ground truth and, under ``--eval``, the map's
evaluation row.

``--gui`` adds the headless GUI stage (``gui.HeadlessGui``: point
clouds, the trajectory and depth / sigma heatmaps under ``--viz_out``;
at the end it sends ``mesh`` and ``eval`` back to the fusion stage),
``--viewer_port`` serves it live over HTTP (``gui.LiveViewer``).
``--edge_shards n`` splits the tracker's edge slots into n shards
(``FrontendConfig.edge_shards``; ``e_active`` and ``e_inactive`` must
divide by n), placed round robin over the visible devices of
``--device``'s type.  ``--device_split`` puts mapping on the second such
device where there is one (``utils.runtime.fusion_device``), else says so
and keeps it beside tracking.

It runs on the GPU; ``--device cpu`` (the one flag the JAX CLI lacks)
runs it on the CPU, for the tests.  ``--weights`` takes the flat-key
``.npz`` (with its damping sidecar) or a DROID ``droid.pth``
(``models/weights.py``).
"""
from __future__ import annotations

import argparse
import json
import time

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="nerf_slam_tpu_torch demo")
    p.add_argument("--dataset_dir", type=str, default=None,
                   help="path to dataset (None -> synthetic room)")
    p.add_argument("--dataset_name", type=str, default="synthetic",
                   choices=["synthetic", "nerf", "replica", "tum",
                            "euroc", "realsense"])
    p.add_argument("--buffer", type=int, default=32, help="max keyframes")
    p.add_argument("--img_stride", type=int, default=1)
    p.add_argument("--initial_k", type=int, default=0)
    p.add_argument("--final_k", type=int, default=-1)
    p.add_argument("--stereo", action="store_true")
    p.add_argument("--rgbd", action="store_true",
                   help="seed metric sensed depths from packet depths")
    p.add_argument("--vio", action="store_true",
                   help="visual-inertial SLAM")
    p.add_argument("--weights", type=str, default=None,
                   help=".npz weights (flat flax keys, with a .json "
                        "damping sidecar) or a droid.pth; random weights "
                        "otherwise")
    p.add_argument("--fusion", type=str, default="nerf",
                   choices=["nerf", "sigma", "tsdf", "none"])
    p.add_argument("--mask_type", type=str, default="ours",
                   choices=["ours", "raw", "ours_w_thresh", "no_depth"],
                   help="depth-uncertainty masking of the NeRF's depth "
                        "supervision")
    p.add_argument("--fit_iters", type=int, default=0,
                   help="continue mapping to this TOTAL iteration count "
                        "after the sequence ends")
    p.add_argument("--eval_every", type=int, default=200,
                   help="iterations between online-eval rows under --eval")
    p.add_argument("--eval_views", type=int, default=8)
    p.add_argument("--parallel_run", action="store_true")
    p.add_argument("--eval", action="store_true")
    p.add_argument("--gui", action="store_true",
                   help="headless GUI stage: exports under --viz_out")
    p.add_argument("--viewer_port", type=int, default=0,
                   help="with --gui: serve a live HTTP viewer on this port")
    p.add_argument("--device_split", action="store_true",
                   help="mapping on a second device")
    p.add_argument("--viz_out", type=str, default="viz_out",
                   help="directory for headless GUI exports")
    p.add_argument("--out", type=str, default="results.csv")
    p.add_argument("--height", type=int, default=120)
    p.add_argument("--width", type=int, default=160)
    p.add_argument("--n_frames", type=int, default=40)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--global_ba", action="store_true",
                   help="run global bundle adjustment at termination")
    p.add_argument("--edge_shards", type=int, default=1,
                   help="shard the tracker's update over this many edge "
                        "shards (e_active and e_inactive must divide it)")
    p.add_argument("--profile", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu (for the tests)")
    return p.parse_args(argv)


def build_dataset(args):
    from ..datasets import build_dataset as factory
    return factory(args.dataset_name, args.dataset_dir,
                   n_frames=args.n_frames, height=args.height,
                   width=args.width, initial_k=args.initial_k,
                   final_k=args.final_k, buffer=args.buffer,
                   stereo=args.stereo, imu=args.vio)


def build_frontend(args, image_size, stereo_rel=None):
    """The tracker with the ``--weights`` .npz (and its damping sidecar),
    a ``droid.pth``, or random weights drawn from ``--seed``; ``--stereo``
    with the rig pose ``stereo_rel`` (cam1_T_cam0, the dataset's),
    ``--rgbd``."""
    from ..models import DroidNet, load_flax_weights
    from ..models.weights import load_droid_pth
    from ..tracking import FrontendConfig, RaftVisualFrontend
    from ..utils.checkpoint import load_arrays

    dev = torch.device(args.device)
    # bf16 on the card, as the JAX package computes; f32 on the CPU
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    damping_kw = {}
    if args.weights and not args.weights.endswith(".npz"):
        net = DroidNet(dtype=dtype)
        net.load_state_dict(load_droid_pth(args.weights))
    elif args.weights:
        flat, meta = load_arrays(args.weights)
        net = load_flax_weights(DroidNet(dtype=dtype), flat)
        # the BA damping recipe the weights were trained with
        for k in ("damping_scale", "damping_offset"):
            if k in meta:
                damping_kw[k] = float(meta[k])
    else:
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(args.seed)
            net = DroidNet(dtype=dtype)
        print("WARNING: no --weights given; using random network weights "
              "(tracking quality will be poor)")
    if args.stereo and stereo_rel is not None:
        damping_kw["stereo_rel"] = tuple(float(v) for v in stereo_rel)
    cfg = FrontendConfig(buffer=args.buffer, p_window=min(args.buffer, 32),
                         k_depth=min(args.buffer + 8, 40),
                         global_ba=args.global_ba, stereo=args.stereo,
                         rgbd=args.rgbd, edge_shards=args.edge_shards,
                         **damping_kw)
    return RaftVisualFrontend(net, cfg, image_size, device=dev)


def build_tracker(args, dataset, probe, frontend):
    """The SLAM stage's object: the tracker, or under ``--vio`` a
    ``VioSLAM`` with the inertial frontend seeded from the first packet's
    pose and the dataset's velocity at its time (zero where the dataset
    has none), its backend on ``--device``."""
    if not args.vio:
        return frontend
    import numpy as np
    from ..datasets.base import ImuCalibration
    from ..geometry import se3
    from ..slam import NavState, PreIntegrationInertialFrontend, VioSLAM
    from ..solver.factor_graph import as_f32
    calib = getattr(dataset, "imu", None) or ImuCalibration()
    pose0 = np.array([0, 0, 0, 0, 0, 0, 1.0])
    if probe.get("poses") is not None:
        pose0 = se3.from_matrix(as_f32(probe["poses"])).numpy()
    vel0 = np.zeros(3)
    if hasattr(dataset, "velocity_at"):
        vel0 = dataset.velocity_at(float(probe["t_cams"]))
    inertial = PreIntegrationInertialFrontend(
        calib, NavState(pose=pose0, vel=vel0), timestamps_ns=True)
    return VioSLAM(frontend, inertial, device=args.device)


def build_fusion(args):
    """(fusion, FusionModule mode), or (None, None) for ``--fusion none``."""
    if args.fusion == "none":
        return None, None
    if args.fusion == "nerf":
        from ..fusion import NerfFusion, NerfFusionConfig
        cfg = NerfFusionConfig(
            buffer=args.buffer, height=args.height, width=args.width,
            mask_type=args.mask_type,
            eval_every=args.eval_every if args.eval else 0,
            eval_views=args.eval_views)
        from ..utils.runtime import fusion_device
        dev = fusion_device(args.device_split, args.device) or args.device
        return NerfFusion(cfg, seed=args.seed, device=dev), "nerf"
    from ..fusion import TsdfFusion, TsdfFusionConfig
    mask = "weighted" if args.fusion == "sigma" else "uniform"
    return (TsdfFusion(TsdfFusionConfig(depth_mask_type=mask),
                       device=args.device), args.fusion)


def run(args) -> dict:
    from ..pipeline import (DataModule, EvalSink, FusionModule, GuiModule,
                            SlamModule, connect, run_parallel,
                            run_sequential)
    from ..utils.evaluation import ate_rmse, trajectory_from_packet

    dataset = build_dataset(args)
    probe = dataset[0]
    image_size = probe["images"].shape[:2]
    if args.stereo and probe.get("images_right") is None:
        raise ValueError("--stereo needs a dataset providing images_right")
    # the rig calibration rides the packets (cam1_T_cam0 7-vector)
    frontend = build_frontend(args, image_size,
                              probe.get("stereo_rel") if args.stereo
                              else None)
    tracker = build_tracker(args, dataset, probe, frontend)
    fusion, fusion_mode = build_fusion(args)

    data_m = DataModule(dataset, img_stride=args.img_stride)
    slam_m = SlamModule(tracker)
    sink = EvalSink()
    modules = [data_m, slam_m, sink]
    connect(data_m, slam_m, "data")
    connect(slam_m, sink, "slam")
    fusion_m = None
    if fusion is not None:
        fusion_m = FusionModule(fusion, mode=fusion_mode)
        connect(slam_m, fusion_m, "slam")
        modules.insert(2, fusion_m)
    if args.gui:
        from ..gui import HeadlessGui, LiveViewer
        gui = HeadlessGui(out_dir=args.viz_out)
        if args.viewer_port:
            gui = LiveViewer(gui, port=args.viewer_port)
            print(f"live viewer at http://localhost:{gui.port}/", flush=True)
        gui_m = GuiModule(gui)
        connect(slam_m, gui_m, "slam")
        if fusion_m is not None:
            # the GUI -> fusion command back-channel
            connect(gui_m, fusion_m, "gui")
        modules.append(gui_m)

    t0 = time.time()
    if args.profile:
        from ..utils.runtime import profile_trace
        with profile_trace():
            if args.parallel_run:
                run_parallel(modules, timeout_s=3600.0)
            else:
                run_sequential(modules)
    elif args.parallel_run:
        run_parallel(modules, timeout_s=3600.0)
    else:
        run_sequential(modules)
    if frontend.device.type == "cuda":
        torch.cuda.synchronize(frontend.device)
    wall = time.time() - t0

    results = {"wall_s": wall, "n_keyframes": frontend.kf_idx + 1,
               "kf_per_s": (frontend.kf_idx + 1) / wall}
    for m in modules:
        results[f"{m.name}_mean_ms"] = m.stats()["mean_ms"]
    if sink.last_full is not None:
        est, gt = trajectory_from_packet(sink.last_full)
        if est.shape[0] >= 3:
            results["ate_rmse_m"] = ate_rmse(est, gt)
    if args.vio and tracker.backend.estimate is not None:
        results["vio_states"] = sum(
            1 for k in tracker.backend.estimate.keys() if k.name == "x")
        results["vio_relinearized"] = tracker.backend.stats["relinearized"]

    if args.fit_iters and fusion_mode == "nerf" \
            and fusion.iteration < args.fit_iters:
        # mapping continued after the sequence; fit_volume appends an
        # online-eval row every eval_every iterations
        fusion.fit_volume(args.fit_iters - fusion.iteration)
        print(f"[fit] reached iter {fusion.iteration}", flush=True)

    if args.eval and fusion is not None:
        if fusion_mode == "nerf":
            # in the map's own frame at the training views, immune to the
            # monocular scale and gauge
            row = fusion.evaluate_training_views()
            if row:
                results.update({f"fusion_{k}": v for k, v in row.items()})
            fusion.write_results_csv(args.out)
        elif sink.last_full is not None:
            pkt = sink.last_full
            n = min(4, int(pkt.get("viz_count", len(pkt["gt_poses"]))))
            row = fusion.evaluate(pkt["cam0_images"][:n],
                                  pkt["gt_depths"][:n], pkt["gt_poses"][:n],
                                  pkt["cam0_intrinsics"][:n] * 8.0)
            results.update({f"fusion_{k}": v for k, v in row.items()})

    print(json.dumps(results))
    return results


def main(argv=None):
    run(parse_args(argv))


if __name__ == "__main__":
    main()
