"""Fit the port's NeRF several times on the same keyframes, from the same
seed, and report how far the results spread.

    python3 scripts/repeat_torch_nerf_fit.py [--runs N] [--encoding hash|pe]
                                             [--iters 2000] [--repo DIR]

Runs the 336x640 production pipeline once, sequentially, as
``chip_smoke.py`` builds it, keeps its keyframes (the training set of its
``NerfFusion``), then fits a fresh field ``--runs`` times on them
(``NGPConfig(encoding=...)`` defaults, 4096 rays a step, the same seed
each time) for ``--iters`` iterations and prints, per fit, the PSNR and
depth L1 at 8 training views, the steps per second of the fit alone, the
peak device memory and a digest of the fitted parameters; then how many
distinct fits the runs gave and the PSNR spread.  Both fields' backward
passes add in a fixed order (the hash grid's table gradient is a sorted,
run-by-run scatter), so every run should give one fit.  ``--repo`` runs
the port of another checkout (for example the parent commit's, to time
the two in turns in one call).  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import hashlib
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=4)
    ap.add_argument("--encoding", default="hash", choices=["hash", "pe"])
    ap.add_argument("--iters", type=int, default=2000)
    ap.add_argument("--repo", default=ROOT)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("repeat_torch_nerf_fit: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.repo))
    import chip_smoke as cs     # imports the package only when it runs
    from nerf_slam_tpu_torch.fusion import (NerfFusion, NerfFusionConfig,
                                            NGPConfig)

    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)
    print(f"package: {os.path.dirname(os.path.abspath(cs.__file__))}",
          flush=True)
    frontend, fusion = cs.build_main_path(dev)
    _, sink = cs.run_pipeline(cs.synthetic_frames(cs.W), frontend, fusion,
                              parallel=False)
    train_set = fusion.train_set
    print(f"keyframes: {int(train_set.valid.sum())}, tracker ATE-RMSE "
          f"{cs.trajectory_error(sink):.4f} m", flush=True)
    del frontend, fusion, sink

    psnrs, digests = [], []
    for i in range(args.runs):
        fit = NerfFusion(NerfFusionConfig(
            buffer=cs.BUFFER, height=cs.H, width=cs.W, batch_rays=4096,
            ngp=NGPConfig(encoding=args.encoding)), seed=cs.SEED, device=dev)
        fit.train_set = train_set
        fit.has_data = True
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss = fit.fit_volume(args.iters)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        row = fit.evaluate_training_views(max_views=8)
        digests.append(hashlib.sha1(b"".join(
            p.detach().cpu().numpy().tobytes()
            for p in fit.field.parameters())).hexdigest()[:16])
        psnrs.append(row["psnr"])
        print(f"fit {i} ({args.encoding}): parameters {digests[-1]}, PSNR "
              f"{row['psnr']:.4f} dB, depth L1 {row['depth_l1_cm']:.3f} cm "
              f"(scale-aligned {row['depth_l1_aligned_cm']:.3f} cm), loss "
              f"{float(loss):.6g}, {args.iters / fit_s:.2f} steps/s, peak "
              f"memory {peak:.2f} GiB", flush=True)
        del fit
        torch.cuda.empty_cache()
    print(f"{len(set(digests))} distinct fits in {args.runs} runs; PSNR "
          f"{min(psnrs):.4f} .. {max(psnrs):.4f} dB (spread "
          f"{max(psnrs) - min(psnrs):.4f} dB)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
