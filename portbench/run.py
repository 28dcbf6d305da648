"""Run one cell of the port's benchmark once.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Needs an NVIDIA GPU (exits non-zero without one).  Prints, as the last
line of standard output, one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device`` and, traced,
``breakdown``; its last key, ``checks``, gives each number compared with
the reference beside its limit, as do the last lines of standard error.

``--control`` (not part of a benchmark run) puts the reference, one
precision lower, in the program's place for the comparison: it must come
out not correct.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="the port's benchmark: one run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true",
                   help="compare the lower-precision reference instead of "
                        "the program (must come out not correct)")
    return p.parse_args(argv)


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch
    from portbench import harness
    bench, entry, config, _ = harness.load_cell(args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < entry["chips"]:
        found = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        print(f"portbench: needs {entry['chips']} CUDA device(s), found "
              f"{found}", file=sys.stderr)
        return 2
    # the program's build cache stays in the checkout
    # (nerf_slam_tpu_torch/_build/); nothing else is cached
    os.environ.setdefault("USE_FLAX", "0")
    result = measure(args, bench, entry, config, T_START)
    if result is None:
        return 3
    print(json.dumps(result), flush=True)
    return 0


def measure(args, bench, entry, config, t_start, device="cuda",
            overrides=None, faults=None, root=None):
    """One run: the window, the readers, the comparison.  Returns the
    result line's object, or None (after saying why on standard error)
    when a forbidden module is loaded."""
    import torch
    from portbench import check, harness
    root = root or harness.REPO
    run, probes, cell, rows = harness.run_cell(
        args.workload, args.seed, args.seconds, bool(args.trace), device,
        t_start, overrides, root, faults)
    dev = torch.device(device)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    forbidden = harness.loaded_forbidden()
    if forbidden:
        print(f"portbench: forbidden modules loaded: {forbidden}",
              file=sys.stderr)
        return None

    metrics = {}
    for m in harness.metrics_for(bench, args.workload, bool(args.trace)):
        value = harness.load_reader(m["name"], root)(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    frames = run.window_frames()
    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": run.device_name, "count": 1,
                   "memory_peak_bytes": int(peak)}
    result = {"correct": False, "attempted": len(frames), "failed": 0,
              "metrics": metrics, "device": device_info}
    if args.trace:
        from portbench import yardstick
        device_info["busy_s"] = yardstick.union_length(
            [(s, e) for _, s, e in run.device_events])
        device_info["window_s"] = run.t_close - run.t_open
        result["breakdown"] = harness.breakdown(run)
    if dev.type == "cuda":
        device_info["power"] = power_limit()
    kinds = [f.kind for f in frames]
    result["frames_by_kind"] = {k: kinds.count(k) for k in
                                ("first", "kept", "rejected", "filtered")}
    result["sessions"] = run.sessions
    if frames:
        # the session in flight when the window closed
        last = frames[-1]
        result["graph_at_close"] = {"keyframes": last.keyframes,
                                    "edges": last.edges}
    result["ate_m"] = check.session_ate(rows)

    # the comparison, once the window has closed and the peak is read;
    # the program's objects are gone with their sessions
    del run
    numbers = check.compare(
        probes, cell, "control" if getattr(args, "control", False) else None)
    ok, table = check.judge(numbers, config.get("limits", {}),
                            check.expected_numbers(config))
    result["correct"] = ok
    result["checks"] = table
    for name, row in table.items():
        print(f"{name} {row['value']!r} limit {row['limit']!r}",
              file=sys.stderr, flush=True)
    return result


if __name__ == "__main__":
    sys.exit(main())
