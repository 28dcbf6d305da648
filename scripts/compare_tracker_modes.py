"""The JAX and the port tracker over the same synthetic frames, on the CPU.

    JAX_PLATFORMS=cpu python scripts/compare_tracker_modes.py \\
        --mode rgbd --height 168 --width 320 [--corr_impl onehot]

Runs 30 frames of the synthetic room (rendered with a right camera 0.1 m
along +x under ``--mode stereo``) through both packages' trackers with
the trained ``weights_synthetic.npz`` in f32 and the production filters
(motion 2.4 px, keyframe 4.0), in ``--mode`` mono, stereo (the rig pose
cam1_T_cam0 of the frames) or rgbd (the frames' depths as sensed depths),
and prints one JSON line per package: keyframes, the Sim(3)-aligned
ATE-RMSE with the Sim(3) scale, the SE(3)-aligned ATE-RMSE and the wall
time.  Each tracker runs alone, from its own state, so the two agree to
the extent that their rounding does not tip a keyframe decision.
``--corr_impl onehot`` (the plain lookup, no kernel) keeps the JAX run
short at this size: the Pallas kernels run in interpret mode on the CPU.
``--source gray`` feeds the same frames in gray (EuRoC's cameras are
monochrome); ``--source euroc`` renders the room at EuRoC's aspect
(480x752 scaled to the size), writes it in the EuRoC ``mav0/`` layout
(``chip_smoke.write_euroc``) and feeds the port loader's packets,
rectified to ``--height`` x ``--width``.
``--init_only`` stops each tracker where its initialization ends (the
first ``keyframe_warmup`` + 1 keyframes after their 16 update
iterations) and prints the same numbers for those keyframes, with the
median ratio of their inverse depths to the frames' true ones (one pixel
of each 8x8 block, as the RGB-D tracker senses them): the step at which
an RGB-D session's Sim(3) scale is first read.

It imports both packages (as the tests do).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--mode", choices=["mono", "stereo", "rgbd"],
                   default="rgbd")
    p.add_argument("--height", type=int, default=168)
    p.add_argument("--width", type=int, default=320)
    p.add_argument("--frames", type=int, default=30)
    p.add_argument("--corr_impl", default="onehot")
    p.add_argument("--source", choices=["synthetic", "gray", "euroc"],
                   default="synthetic")
    p.add_argument("--packages", default="port,jax")
    p.add_argument("--threads", type=int, default=6)
    p.add_argument("--init_only", action="store_true")
    return p.parse_args(argv)


def config(args, meta) -> dict:
    kw = dict(buffer=24, e_active=64, e_inactive=48, p_window=24,
              k_depth=28, motion_filter_thresh=2.4, keyframe_thresh=4.0,
              corr_impl=args.corr_impl,
              damping_scale=float(meta["damping_scale"]),
              damping_offset=float(meta["damping_offset"]))
    if args.mode == "rgbd":
        kw["rgbd"] = True
    if args.mode == "stereo":
        kw.update(stereo=True,
                  stereo_rel=(-0.1, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0))
    return kw


def port_tracker(args, flat, kw):
    from nerf_slam_tpu_torch.models import DroidNet, load_flax_weights
    from nerf_slam_tpu_torch.tracking import frontend as tfe
    net = load_flax_weights(DroidNet(dtype=torch.float32), flat)
    return tfe.RaftVisualFrontend(net, tfe.FrontendConfig(**kw),
                                  (args.height, args.width), device="cpu")


def jax_tracker(args, flat, kw):
    from nerf_slam_tpu.models import DroidNet as JaxNet
    from nerf_slam_tpu.tracking import frontend as jfe
    from nerf_slam_tpu.utils.checkpoint import unflatten_into

    class F32(jfe.RaftVisualFrontend):
        """The JAX tracker with its network and GRU state in f32."""

        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.net = JaxNet(dtype=jnp.float32)

        def _alloc_edges(self):
            e = super()._alloc_edges()
            return e._replace(hidden=e.hidden.astype(jnp.float32))

    params = unflatten_into(JaxNet(dtype=jnp.float32).init_params(
        jax.random.PRNGKey(0), args.height, args.width), flat)
    return F32(params, jfe.FrontendConfig(**kw), (args.height, args.width))


def load_frames(args):
    """The ``--frames`` packets of ``--source``."""
    from nerf_slam_tpu_torch.datasets import (SyntheticConfig,
                                              SyntheticDataset, build_dataset)
    if args.source == "euroc":
        import tempfile

        import chip_smoke
        chip_smoke.N_FRAMES = args.frames
        chip_smoke.EUROC_HW = (args.height * 480 // 336,
                               args.width * 752 // 640)
        with tempfile.TemporaryDirectory() as tmp:
            ds = build_dataset("euroc", chip_smoke.write_euroc(tmp),
                               height=args.height, width=args.width,
                               stereo=args.mode == "stereo")
            return [ds[k] for k in range(len(ds))]
    ds = SyntheticDataset(SyntheticConfig(
        n_frames=args.frames, height=args.height, width=args.width,
        stereo=args.mode == "stereo", baseline=0.1))
    frames = [ds[k] for k in range(args.frames)]
    if args.source == "gray":
        for f in frames:
            for key in ("images", "images_right"):
                if key in f:
                    g = np.round(f[key].astype(np.float64)
                                 @ [0.299, 0.587, 0.114]).astype(np.uint8)
                    f[key] = np.repeat(g[..., None], 3, -1)
    return frames


def _host(x) -> np.ndarray:
    return np.asarray(x.cpu() if hasattr(x, "cpu") else x)


def init_numbers(tracker, frames) -> dict:
    """The initialized keyframes' trajectory against the ground truth and
    their inverse depths against the frames' true ones."""
    from nerf_slam_tpu_torch.utils.evaluation import (_pose_to_c2w_translation,
                                                      ate_rmse,
                                                      umeyama_alignment)
    st, n = tracker.state, tracker.kf_idx
    est = _pose_to_c2w_translation(_host(st.cam_T_world)[:n])
    gt = _host(st.gt_poses)[:n, :3, 3]
    idepths = _host(st.idepths)[:n]
    true = np.stack([1.0 / frames[tracker.kf_idx_to_f_idx[i]]["depths"][
        4::8, 4::8] for i in range(n)])
    return {"keyframes": n, "ate_sim3_m": ate_rmse(est, gt),
            "sim3_scale": umeyama_alignment(est, gt)[2],
            "ate_se3_m": ate_rmse(est, gt, align_scale=False),
            "idepth_ratio": float(np.median(idepths / true))}


def main(argv=None) -> int:
    from nerf_slam_tpu_torch.utils.checkpoint import load_arrays
    from nerf_slam_tpu_torch.utils.evaluation import (ate_rmse,
                                                      trajectory_from_packet,
                                                      umeyama_alignment)
    args = parse_args(argv)
    torch.set_num_threads(args.threads)
    flat, meta = load_arrays(os.path.join(ROOT, "weights_synthetic.npz"))
    kw = config(args, meta)
    frames = load_frames(args)
    build = {"port": port_tracker, "jax": jax_tracker}
    for name in args.packages.split(","):
        tracker = build[name](args, flat, kw)
        t0 = time.perf_counter()
        last = None
        for k, f in enumerate(frames):
            out = tracker(k, f)
            if out is not None and "viz_idx" in out:
                last = out
            if args.init_only and tracker.is_initialized:
                break
        wall = time.perf_counter() - t0
        if args.init_only:
            print(json.dumps({"package": name, "mode": args.mode,
                              "source": args.source, "at": "init",
                              "size": [args.height, args.width],
                              **init_numbers(tracker, frames),
                              "wall_s": wall}), flush=True)
            continue
        pkt = {k: (_host(v) if hasattr(v, "shape") else v)
               for k, v in last.items()}
        est, gt = trajectory_from_packet(pkt)
        print(json.dumps({
            "package": name, "mode": args.mode, "source": args.source,
            "corr_impl": args.corr_impl,
            "size": [args.height, args.width],
            "keyframes": int(pkt["viz_count"]),
            "ate_sim3_m": ate_rmse(est, gt),
            "sim3_scale": umeyama_alignment(est, gt)[2],
            "ate_se3_m": ate_rmse(est, gt, align_scale=False),
            "wall_s": wall}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
