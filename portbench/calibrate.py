"""The readings that the comparison's limits are set from; not part of a
benchmark run.

    python3 -m portbench.calibrate --workload <name> [--workload ...] \
        --seed <first> --seeds <n> --seconds <s>

For each of ``--seeds`` rounds and each cell, one run on a seed of its
own (counting up from ``--seed``): set-up, warm-up and window in this
one process, then the numbers compared three ways: the program's outputs,
the control (the reference one precision lower in the program's place)
and, where the cell has a map step, the reference with its loss over half
the rendered rays in the program's place.  Prints one JSON line a run.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def readings(workload: str, seed: int, seconds: float, device="cuda",
             overrides=None) -> dict:
    import torch
    from portbench import check, harness
    t0 = time.perf_counter()
    run, probes, cell, rows = harness.run_cell(
        workload, seed, seconds, False, device, t0, overrides)
    frames = run.window_frames()
    kinds = [f.kind for f in frames]
    out = {"workload": workload, "seed": seed,
           "frames_per_s": len(frames) / seconds,
           "frames_by_kind": {k: kinds.count(k) for k in
                              ("first", "kept", "rejected", "filtered")},
           "graph_at_close": [frames[-1].keyframes, frames[-1].edges]
           if frames else None,
           "ate_m": check.session_ate(rows)}
    del run
    out["program"] = check.compare(probes, cell)
    out["control"] = check.compare(probes, cell, "control")
    if probes.map_steps:
        out["half_batch"] = check.compare(probes, cell, "half_batch")
        step = probes.map_steps[0]["before"]["step"].get("table")
        out["adam_step"] = None if step is None else float(step)
    del probes, cell
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", action="append", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seeds", type=int, default=3)
    p.add_argument("--seconds", type=float, default=12.0)
    args = p.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")
    for i in range(args.seeds):
        for j, wl in enumerate(args.workload):
            seed = args.seed + i * len(args.workload) + j
            print(json.dumps(readings(wl, seed, args.seconds)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
