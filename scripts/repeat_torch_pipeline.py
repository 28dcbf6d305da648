"""Run the port's sequential production pipeline many times in one process.

    python3 scripts/repeat_torch_pipeline.py [--runs N] [--kernel-phase]
                                             [--repo DIR]

The tracker is bit-reproducible on the GPU: its segment sums add in a
fixed order (``nerf_slam_tpu_torch/ops/segment.py``), so identical runs
give identical keyframes and poses.  This script shows it: it builds the
336x640 production cell as ``chip_smoke.py`` does, runs ``DataModule ->
SlamModule -> FusionModule -> EvalSink`` sequentially ``--runs`` times on
fresh state and prints each run's ATE-RMSE, how many of its Cholesky
factorizations failed, which frames became keyframes, the keyframe
distance that each frame's update round tested against
``keyframe_thresh`` (below it the newest keyframe is dropped) and a digest
of the tracker's result (keyframe timestamps, poses, inverse depths),
then how many distinct results the runs gave and the count above
``chip_smoke.py``'s ATE limit.  ``--kernel-phase`` runs ``chip_smoke.py``'s
kernel checks first, as the smoke run does.  ``--repo`` runs the port's
package of another tree (an older commit unpacked beside this one) under
this script and this tree's ``chip_smoke.py``.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import hashlib
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--kernel-phase", action="store_true")
    ap.add_argument("--repo", default=ROOT)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("repeat_torch_pipeline: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs     # imports the package only when it runs
    sys.path.insert(0, os.path.abspath(args.repo))
    import nerf_slam_tpu_torch
    print(f"package {os.path.dirname(nerf_slam_tpu_torch.__file__)}",
          flush=True)

    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)
    if args.kernel_phase:
        cs.kernel_phase(dev)
    frames = cs.synthetic_frames(cs.W)
    frontend, fusion = cs.build_main_path(dev)

    infos = []                  # device tensors: no sync inside a run
    cholesky_ex = torch.linalg.cholesky_ex

    def recording(*a, **kw):
        out = cholesky_ex(*a, **kw)
        infos.append(out[1])
        return out

    torch.linalg.cholesky_ex = recording

    dists = []                  # (frame, keyframe distance its round tested)
    call = type(frontend).__call__

    def recording_call(self, k, batch):
        self.last_kf_dist = None
        out = call(self, k, batch)
        if self.last_kf_dist is not None:
            dists.append((k, float(self.last_kf_dist)))
        return out

    type(frontend).__call__ = recording_call
    ates, digests = [], []
    for i in range(args.runs):
        infos.clear()
        dists.clear()
        wall, sink = cs.run_pipeline(frames, frontend, fusion, parallel=False)
        ates.append(cs.trajectory_error(sink))
        failed = int((torch.stack([x.reshape(-1)[0] for x in infos]) != 0)
                     .sum()) if infos else 0
        n_kf = frontend.kf_idx + 1
        stamps = frontend.state.timestamps[:n_kf].cpu().numpy()
        digests.append(hashlib.sha1(b"".join(
            t.cpu().numpy().tobytes() for t in cs.tracker_result(frontend))
        ).hexdigest()[:16])
        print(f"run {i}: result {digests[-1]}, ATE-RMSE {ates[-1]:.6f} m, "
              f"{n_kf} keyframes, "
              f"{wall:.2f} s, {failed} of {len(infos)} factorizations "
              f"failed, keyframe frames "
              f"{' '.join(str(int(round(t * 30))) for t in stamps)}, "
              f"keyframe distances "
              f"{' '.join(f'{k}:{d:.3f}' for k, d in dists)}", flush=True)
    over = sum(a > cs.ATE_LIMIT_M for a in ates)
    print(f"{len(set(digests))} distinct results in {len(ates)} runs; "
          f"{over} runs above {cs.ATE_LIMIT_M} m; median "
          f"{sorted(ates)[len(ates) // 2]:.6f} m, max {max(ates):.6f} m",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
