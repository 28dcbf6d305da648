"""The JAX and the port inertial chain over the same IMU, on the CPU.

    JAX_PLATFORMS=cpu python scripts/compare_vio_trajectory.py [--frames 30]

Runs ``VioSLAM`` with a stub visual frontend (no tracker: the inertial
chain alone) through both packages over the bench cell's trajectory (the
synthetic room's full orbit, 12 deg a frame at 30 frames, its simulated
200 Hz IMU; the image size does not enter) and prints one JSON line per
package: the largest position error of the solved states against ground
truth, the relinearized/reused counts and the wall time, then the
largest difference between the two packages' states.  The JAX run takes
about 90 s at 30 frames.

It imports both packages (as the tests do).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


class Stub:
    """VioSLAM's visual-frontend contract without the tracker."""

    def __init__(self, n):
        self.n, self.kf_idx = n, -1

    def __call__(self, k, packet):
        self.kf_idx = k
        return {"k": k}

    def stop_condition(self):
        return self.kf_idx >= self.n - 1


def run(pkg: str, n: int):
    if pkg == "jax":
        from nerf_slam_tpu.datasets.base import ImuCalibration
        from nerf_slam_tpu.datasets.synthetic import (SyntheticConfig,
                                                      SyntheticDataset)
        from nerf_slam_tpu.slam.imu import (NavState,
                                            PreIntegrationInertialFrontend)
        from nerf_slam_tpu.slam.meta_slam import VioSLAM
        from nerf_slam_tpu.solver.factor_graph import Key
        kw = {}
    else:
        from nerf_slam_tpu_torch.datasets.base import ImuCalibration
        from nerf_slam_tpu_torch.datasets.synthetic import (SyntheticConfig,
                                                            SyntheticDataset)
        from nerf_slam_tpu_torch.slam.imu import (
            NavState, PreIntegrationInertialFrontend)
        from nerf_slam_tpu_torch.slam.meta_slam import VioSLAM
        from nerf_slam_tpu_torch.solver.factor_graph import Key
        kw = {"device": "cpu"}
    from nerf_slam_tpu_torch.geometry import se3
    import torch
    ds = SyntheticDataset(SyntheticConfig(n_frames=n, height=24, width=32,
                                          imu=True))
    pose0 = se3.from_matrix(torch.as_tensor(ds.poses[0],
                                            dtype=torch.float32)).numpy()
    slam = VioSLAM(Stub(n), PreIntegrationInertialFrontend(
        ImuCalibration(), NavState(pose=pose0, vel=ds.velocity_at(0.0))),
        **kw)
    t0 = time.perf_counter()
    for k in range(n):
        pkt = ds[k]
        pkt["k"] = k
        slam(pkt)
    wall = time.perf_counter() - t0
    est = slam.backend.estimate
    states = np.stack([np.concatenate([np.asarray(est.at(Key(c, k)))
                                       for c in "xvb"]) for k in range(n)])
    err = np.linalg.norm(states[:, :3] - ds.poses[:, :3, 3], axis=1)
    print(json.dumps({"package": pkg, "frames": n,
                      "max_position_err_m": float(err.max()),
                      "at_frame": int(err.argmax()),
                      **slam.backend.stats, "wall_s": wall}), flush=True)
    return states


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=30)
    args = ap.parse_args()
    a = run("jax", args.frames)
    b = run("torch", args.frames)
    print(json.dumps({"max_state_diff": float(np.abs(a - b).max())}))


if __name__ == "__main__":
    main()
