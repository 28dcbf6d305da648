"""Where the port's main path spends its time on the card.

    python3 scripts/profile_torch_main_path.py [--out profile.json]

Builds the 336x640 production cell exactly as ``chip_smoke.py`` does and
runs it once untimed (warm-up), then twice under ``torch.profiler``:

- threaded, as ``chip_smoke.py`` times it: the device's busy and idle
  share (union of kernel and copy intervals over the wall time), the
  kernels with the most device time (names cut to 160 characters), and
  host wall time per stage;
- sequential, on one thread, where the profiler's ranges also attribute
  device time to the stages (it records ranges on the thread that
  started it only).

Prints one JSON object.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def _annotate(cls, method: str, label: str, host_ms):
    """Wrap ``cls.method`` in a profiler range and add its host wall time
    to ``host_ms[label]`` (on the class: the pipeline calls the frontend
    through ``__call__``)."""
    fn = getattr(cls, method)

    def wrapped(*a, **k):
        t0 = time.perf_counter()
        try:
            with record_function(label):
                return fn(*a, **k)
        finally:
            host_ms[label] += 1e3 * (time.perf_counter() - t0)
    setattr(cls, method, wrapped)


def _profiled_run(frames, frontend, fusion, parallel, host_ms, top):
    host_ms.clear()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall, _ = chip_smoke.run_pipeline(frames, frontend, fusion,
                                          parallel=parallel)
    dev_iv, by_kernel = [], collections.Counter()
    stages = collections.defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if e.name in host_ms:     # a range mirrored on the device
                continue
            dev_iv.append((e.time_range.start, e.time_range.end))
            by_kernel[e.name[:160]] += e.time_range.elapsed_us()
        elif e.name in host_ms:
            stages[e.name][0] += e.device_time_total / 1e3
            stages[e.name][1] += 1
    busy_ms = _union_us(dev_iv) / 1e3
    n_kf = frontend.kf_idx + 1
    return {
        "keyframes": n_kf, "ngp_iters": fusion.iteration, "wall_s": wall,
        "keyframes_per_s": n_kf / wall, "device_busy_ms": busy_ms,
        "device_idle_share": 1.0 - busy_ms / (1e3 * wall),
        "device_events": len(dev_iv),
        "stage_host_ms": dict(host_ms),
        "stage_device_ms": {k: v[0] for k, v in stages.items()},
        "stage_calls": {k: v[1] for k, v in stages.items()},
        "top_kernels_ms": {k: v / 1e3 for k, v in by_kernel.most_common(top)},
    }


def _union_us(intervals):
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="also write the JSON here")
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_main_path: no CUDA device", file=sys.stderr)
        return 1
    from nerf_slam_tpu_torch.datasets import (SyntheticConfig,
                                              SyntheticDataset)
    from nerf_slam_tpu_torch.ops import build

    dev = torch.device("cuda")
    build.build(["corr_lookup"])
    ds = SyntheticDataset(SyntheticConfig(
        n_frames=chip_smoke.N_FRAMES, height=chip_smoke.H,
        width=chip_smoke.W))
    frames = [ds[k] for k in range(len(ds))]
    frontend, fusion = chip_smoke.build_main_path(dev)
    chip_smoke.run_pipeline(frames, frontend, fusion, parallel=True)

    host_ms = collections.defaultdict(float)
    for obj, method, label in (
            (frontend, "__call__", "stage.slam_frame"),
            (frontend, "_ingest", "slam.ingest"),
            (frontend, "update", "slam.update"),
            (fusion, "fuse", "stage.fusion_ingest"),
            (fusion, "fit_volume", "stage.fusion_fit")):
        _annotate(type(obj), method, label, host_ms)
    out = {"card": chip_smoke.card_line(),
           "cell": f"{chip_smoke.H}x{chip_smoke.W} synthetic, "
                   f"{chip_smoke.N_FRAMES} frames, production policy"}
    for name, parallel in (("threaded", True), ("sequential", False)):
        out[name] = _profiled_run(frames, frontend, fusion, parallel,
                                  host_ms, args.top)
    text = json.dumps(out)
    print(text, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
