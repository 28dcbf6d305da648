"""Where the inertial backend's time goes, on a device.

    python3 scripts/profile_vio_backend.py [--device cuda] [--frames 24]

Runs ``VioSLAM`` with no visual frontend (the inertial chain alone: IMU
preintegration into the incremental solver) over the bench cell's
trajectory (the synthetic room's full orbit at 30 frames; the image size
does not enter) on ``--device``, prints the backend's time per update
(host clock around work that ends in a synchronize), then profiles one
more update with ``torch.profiler`` and prints the operator and runtime
calls that take the most host time (with the CUDA runtime's
``cudaMemcpyAsync`` and ``cudaStreamSynchronize`` counts on the card),
and how many ATen operators the error of the whole graph, one IMU
factor's residual and its ``jacfwd`` linearization call.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


class NoVisualFrontend:
    def __call__(self, k, packet):
        return None

    def stop_condition(self):
        return False


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--frames", type=int, default=24)
    args = ap.parse_args()
    from nerf_slam_tpu_torch.datasets import SyntheticConfig, SyntheticDataset
    from nerf_slam_tpu_torch.datasets.base import ImuCalibration
    from nerf_slam_tpu_torch.geometry import se3
    from nerf_slam_tpu_torch.slam import (NavState,
                                          PreIntegrationInertialFrontend,
                                          VioSLAM)
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device(args.device)
    ds = SyntheticDataset(SyntheticConfig(n_frames=30, height=24, width=32,
                                          imu=True))
    pose0 = se3.from_matrix(torch.as_tensor(ds.poses[0],
                                            dtype=torch.float32)).numpy()
    slam = VioSLAM(NoVisualFrontend(), PreIntegrationInertialFrontend(
        ImuCalibration(), NavState(pose=pose0, vel=ds.velocity_at(0.0))),
        device=args.device)
    packets = [dict(ds[k], k=k) for k in range(args.frames + 1)]

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    times = []
    for pkt in packets[:-1]:
        sync()
        t0 = time.perf_counter()
        slam(pkt)
        sync()
        times.append(1e3 * (time.perf_counter() - t0))
    name = (torch.cuda.get_device_name(0) if dev.type == "cuda"
            else "CPU")
    print(f"{name}: {len(times)} updates, ms each: first {times[0]:.1f}, "
          f"median {np.median(times):.1f}, last {times[-1]:.1f}, mean "
          f"{np.mean(times):.1f}; {len(slam.graph)} factors, stats "
          f"{slam.backend.stats}")
    def aten_calls(fn):
        with profile(activities=[ProfilerActivity.CPU]) as p:
            fn()
            sync()
        return sum(e.count for e in p.key_averages()
                   if e.key.startswith("aten::"))
    est, lin = slam.backend.estimate, slam.backend._lin_point
    imu = next(f for f in slam.graph.factors.values()
               if type(f).__name__ == "ImuFactor")
    print(f"ATen calls: graph.error over {len(slam.graph)} factors "
          f"{aten_calls(lambda: slam.graph.error(est))}, one ImuFactor "
          f"residual {aten_calls(lambda: imu.residual(*[est.at(k) for k in imu.keys]))}"
          f", its linearize (jacfwd) "
          f"{aten_calls(lambda: imu.linearize(lin))}")
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if dev.type == "cuda" else [])
    sync()
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        slam(packets[-1])
        sync()
    print(f"profiled update: {1e3 * (time.perf_counter() - t0):.1f} ms")
    ka = prof.key_averages()
    calls = {e.key: e.count for e in ka}
    print("aten calls", sum(c for k, c in calls.items()
                            if k.startswith("aten::")),
          "| cudaLaunchKernel", calls.get("cudaLaunchKernel", 0),
          "| cudaMemcpyAsync", calls.get("cudaMemcpyAsync", 0),
          "| cudaStreamSynchronize", calls.get("cudaStreamSynchronize", 0))
    print(ka.table(sort_by="self_cpu_time_total", row_limit=15))


if __name__ == "__main__":
    main()
