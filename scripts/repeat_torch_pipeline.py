"""Run the port's sequential production pipeline many times in one process.

    python3 scripts/repeat_torch_pipeline.py [--runs N] [--kernel-phase]

The tracker is not bit-reproducible on the GPU (PyTorch's ``index_add_``
sums with atomics), and once in a few dozen runs the 30-frame trajectory
comes out with twice the usual ATE-RMSE.  This script measures how often:
it builds the 336x640 production cell as ``chip_smoke.py`` does, runs
``DataModule -> SlamModule -> FusionModule -> EvalSink`` sequentially
``--runs`` times on fresh state and prints each run's ATE-RMSE, how many
of its Cholesky factorizations failed, which frames became keyframes and
the keyframe distance that each frame's update round tested against
``keyframe_thresh`` (below it the newest keyframe is dropped), then the
count above ``chip_smoke.py``'s limit.  ``--kernel-phase`` runs
``chip_smoke.py``'s kernel checks first, as the smoke run does.  Needs a
CUDA device.
"""
from __future__ import annotations

import argparse
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--kernel-phase", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("repeat_torch_pipeline: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

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
    ates = []
    for i in range(args.runs):
        infos.clear()
        dists.clear()
        wall, sink = cs.run_pipeline(frames, frontend, fusion, parallel=False)
        ates.append(cs.trajectory_error(sink))
        failed = int((torch.stack([x.reshape(-1)[0] for x in infos]) != 0)
                     .sum()) if infos else 0
        n_kf = frontend.kf_idx + 1
        stamps = frontend.state.timestamps[:n_kf].cpu().numpy()
        print(f"run {i}: ATE-RMSE {ates[-1]:.4f} m, {n_kf} keyframes, "
              f"{wall:.2f} s, {failed} of {len(infos)} factorizations "
              f"failed, keyframe frames "
              f"{' '.join(str(int(round(t * 30))) for t in stamps)}, "
              f"keyframe distances "
              f"{' '.join(f'{k}:{d:.3f}' for k, d in dists)}", flush=True)
    over = sum(a > cs.ATE_LIMIT_M for a in ates)
    print(f"{over} of {len(ates)} runs above {cs.ATE_LIMIT_M} m; median "
          f"{sorted(ates)[len(ates) // 2]:.4f} m, max {max(ates):.4f} m",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
