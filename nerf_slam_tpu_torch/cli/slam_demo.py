"""SLAM demo CLI of the PyTorch/CUDA port.

    python -m nerf_slam_tpu_torch.cli.slam_demo --weights weights_synthetic.npz \
        --height 336 --width 640 --n_frames 30 --buffer 24 --fusion sigma --eval

The JAX package's ``cli/slam_demo.py`` with the same flags and defaults:
dataset, keyframe buffer, stride, map backend (``--fusion nerf`` the
depth-supervised radiance field, ``sigma`` the uncertainty-weighted TSDF,
``tsdf`` the unweighted one, ``none``), sequential or ``--parallel_run``
(one thread per stage on one card).  ``--stereo`` tracks with the
dataset's right camera and the rig pose its packets carry (``stereo_rel``),
``--rgbd`` seeds metric inverse depths from the packets' depths.
``--dataset_name nerf|tum|euroc|replica|realsense`` with ``--dataset_dir``
reads that format (EuRoC at ``--height`` x ``--width``, with ``--stereo``
rectified to a shared pinhole); ``--profile`` writes a ``torch.profiler``
trace of the run (``utils/runtime.profile_trace``: CPU ranges of the
thread that runs the stages, CUDA kernels of every thread).  It prints
one JSON line: wall time, keyframes and keyframes/s, each stage's mean
spin time, ATE-RMSE against ground truth and, under ``--eval``, the map's
evaluation row.

It runs on the GPU; ``--device cpu`` (the one flag the JAX CLI lacks)
runs it on the CPU, for the tests.  Features the port does not have yet
raise, naming by its title the item of ROADMAP.md's module queue they
wait for: ``--vio`` ("VIO"), ``--edge_shards`` > 1 and ``--device_split``
("parallel/"), ``--gui`` and ``--viewer_port`` ("gui/"), and a ``.pth``
weights file ("Training": the ``droid.pth`` conversion).
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
                        "damping sidecar); random weights otherwise")
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
    p.add_argument("--gui", action="store_true")
    p.add_argument("--viewer_port", type=int, default=0)
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
    p.add_argument("--edge_shards", type=int, default=1)
    p.add_argument("--profile", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu (for the tests)")
    return p.parse_args(argv)


# flags whose features are not ported: (attribute, refused when, the title
# of the ROADMAP.md item that ports them)
_REFUSED = (
    ("vio", bool, "VIO"),
    ("gui", bool, "gui/"),
    ("viewer_port", bool, "gui/"),
    ("device_split", bool, "parallel/"),
    ("edge_shards", lambda n: n > 1, "parallel/"),
)


def check_args(args) -> None:
    """Raise for every feature the port does not have yet."""
    for name, refused, item in _REFUSED:
        if refused(getattr(args, name)):
            raise NotImplementedError(
                f"--{name} is not ported yet: ROADMAP.md, module {item}")
    if args.weights and not args.weights.endswith(".npz"):
        raise NotImplementedError(
            "only .npz weights load: the droid.pth conversion is not "
            "ported yet: ROADMAP.md, module Training")


def build_dataset(args):
    from ..datasets import build_dataset as factory
    return factory(args.dataset_name, args.dataset_dir,
                   n_frames=args.n_frames, height=args.height,
                   width=args.width, initial_k=args.initial_k,
                   final_k=args.final_k, buffer=args.buffer,
                   stereo=args.stereo)


def build_frontend(args, image_size, stereo_rel=None):
    """The tracker with the ``--weights`` .npz (and its damping sidecar)
    or random weights drawn from ``--seed``; ``--stereo`` with the rig pose
    ``stereo_rel`` (cam1_T_cam0, the dataset's), ``--rgbd``."""
    from ..models import DroidNet, load_flax_weights
    from ..tracking import FrontendConfig, RaftVisualFrontend
    from ..utils.checkpoint import load_arrays

    dev = torch.device(args.device)
    # bf16 on the card, as the JAX package computes; f32 on the CPU
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    damping_kw = {}
    if args.weights:
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
                         rgbd=args.rgbd, **damping_kw)
    return RaftVisualFrontend(net, cfg, image_size, device=dev)


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
        return NerfFusion(cfg, seed=args.seed, device=args.device), "nerf"
    from ..fusion import TsdfFusion, TsdfFusionConfig
    mask = "weighted" if args.fusion == "sigma" else "uniform"
    return (TsdfFusion(TsdfFusionConfig(depth_mask_type=mask),
                       device=args.device), args.fusion)


def run(args) -> dict:
    from ..pipeline import (DataModule, EvalSink, FusionModule, SlamModule,
                            connect, run_parallel, run_sequential)
    from ..utils.evaluation import ate_rmse, trajectory_from_packet

    check_args(args)
    dataset = build_dataset(args)
    probe = dataset[0]
    image_size = probe["images"].shape[:2]
    if args.stereo and probe.get("images_right") is None:
        raise ValueError("--stereo needs a dataset providing images_right")
    # the rig calibration rides the packets (cam1_T_cam0 7-vector)
    frontend = build_frontend(args, image_size,
                              probe.get("stereo_rel") if args.stereo
                              else None)
    fusion, fusion_mode = build_fusion(args)

    data_m = DataModule(dataset, img_stride=args.img_stride)
    slam_m = SlamModule(frontend)
    sink = EvalSink()
    modules = [data_m, slam_m, sink]
    connect(data_m, slam_m, "data")
    connect(slam_m, sink, "slam")
    if fusion is not None:
        fusion_m = FusionModule(fusion, mode=fusion_mode)
        connect(slam_m, fusion_m, "slam")
        modules.insert(2, fusion_m)

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
