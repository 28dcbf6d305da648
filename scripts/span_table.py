"""Self time, syncs and device idle time by span, from one traced run of
a benchmark cell.

    python3 scripts/span_table.py --workload sigma_mono_384x512.orbit \
        --seed 7 --seconds 50 [--out spans.json]

Runs the cell's window as ``portbench.run --trace 1`` does (set-up,
warm-up, ``torch.profiler`` over the window; the comparison with the
reference is skipped) and prints, for each (stage, span name) of the
spans that start in the window: calls per frame (``map.step`` and its
children: per step), mean self ms (duration less its children's), mean
syncs made directly inside it, the ms a call of the device's idle time
falls inside it, and of those the ms in idle gaps of 1 ms or more (a
stall: the host waiting or computing, where short gaps are launch
overhead).  Idle time goes to the innermost span of the
thread that holds ``DEVICE_LOCK`` (its ``lock.hold``) at that moment;
where no thread holds the lock, to the innermost span open on the first
thread that has one (``slam``, ``fusion``, ``gui``, then the rest); where
no span is open anywhere, to "(no span)".  Also prints the proxies'
``track_ms.keyframe`` and the mean ms of a mapping call's training step
(calls without a packet), which a program without spans gives too.

Needs an NVIDIA GPU (``--device cpu`` runs it at the CPU tests' tiny
size, a rehearsal and never a measurement).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from bisect import bisect_right
from collections import defaultdict
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

STAGE_ORDER = ("slam", "fusion", "gui")
PER_STEP = ("map.step", "map.draw", "map.forward", "map.backward",
            "map.optim")


def innermost(roots):
    """The (start, end, span) pieces of time in which each span is the
    innermost open one, in time order, from root spans of one thread."""
    out = []

    def walk(s):
        cur = s.t0
        for c in sorted(s.children, key=lambda c: c.t0):
            if c.t0 > cur:
                out.append((cur, c.t0, s))
            walk(c)
            cur = max(cur, c.t1)
        if s.t1 > cur:
            out.append((cur, s.t1, s))
    for r in sorted(roots, key=lambda r: r.t0):
        walk(r)
    return out


def overlap(pieces, starts, a, b):
    """The pieces that overlap [a, b), clipped to it: (lo, hi, span) in
    time order."""
    i = max(bisect_right(starts, a) - 1, 0)
    while i < len(pieces) and pieces[i][0] < b:
        lo, hi = max(a, pieces[i][0]), min(b, pieces[i][1])
        if hi > lo:
            yield lo, hi, pieces[i][2]
        i += 1


LONG_GAP_NS = 1_000_000


def attribute_idle(spans, gaps_ns):
    """Idle ns by span (None: no span open) over the gaps, and the part
    of it in gaps of ``LONG_GAP_NS`` or more."""
    by_stage = defaultdict(list)
    for s in spans:
        if s.parent is None:
            by_stage[s.stage].append(s)
    timeline = {st: innermost(r) for st, r in by_stage.items()}
    starts = {st: [p[0] for p in t] for st, t in timeline.items()}
    order = [st for st in STAGE_ORDER if st in timeline] + sorted(
        st for st in timeline if st not in STAGE_ORDER)
    holds = sorted((s.t0, s.t1, s.stage) for s in spans
                   if s.name == "lock.hold")
    hold_starts = [h[0] for h in holds]
    idle, long = defaultdict(int), defaultdict(int)

    def add(span, ns, gap_ns):
        idle[span] += ns
        if gap_ns >= LONG_GAP_NS:
            long[span] += ns

    def free(a, b, gap_ns):
        """[a, b) with no lock holder: the first stage with a span open."""
        rest = [(a, b)]
        for st in order:
            left = []
            for lo, hi in rest:
                cur = lo
                for p0, p1, span in overlap(timeline[st], starts[st], lo,
                                            hi):
                    add(span, p1 - p0, gap_ns)
                    if p0 > cur:
                        left.append((cur, p0))
                    cur = p1
                if cur < hi:
                    left.append((cur, hi))
            rest = left
        for lo, hi in rest:
            add(None, hi - lo, gap_ns)

    for a, b in gaps_ns:
        cur = a
        i = max(bisect_right(hold_starts, a) - 1, 0)
        while i < len(holds) and holds[i][0] < b:
            h0, h1, st = holds[i]
            lo, hi = max(a, h0), min(b, h1)
            if hi > lo:
                if lo > cur:
                    free(cur, lo, b - a)
                for p0, p1, span in overlap(timeline[st], starts[st], lo,
                                            hi):
                    add(span, p1 - p0, b - a)
                cur = max(cur, hi)
            i += 1
        if cur < b:
            free(cur, b, b - a)
    return idle, long


def table(run, spans):
    from portbench.yardstick import gaps
    lo, hi = run.t_open * 1e9, run.t_close * 1e9
    win = [s for s in spans if lo <= s.t0 < hi]
    frames = sum(s.name == "track.frame" for s in win)
    steps = sum(s.name == "map.step" for s in win)
    idle_gaps = gaps([(s, e) for _, s, e in run.device_events], run.t_open,
                     run.t_close)
    idle, long = attribute_idle(spans, [(int(a * 1e9), int(b * 1e9))
                                        for a, b in idle_gaps])
    rows = defaultdict(lambda: {"calls": 0, "self_ns": 0, "syncs": 0,
                                "idle_ns": 0, "long_ns": 0})
    for s in win:
        r = rows[(s.stage, s.name)]
        r["calls"] += 1
        r["self_ns"] += s.self_ns
        r["syncs"] += s.syncs
    for s, ns in idle.items():
        key = ("-", "(no span)") if s is None else (s.stage, s.name)
        rows[key]["idle_ns"] += ns
        rows[key]["long_ns"] += long[s]
    out = []
    for (stage, name), r in sorted(rows.items()):
        per = steps if name in PER_STEP else frames
        n = max(r["calls"], 1)
        out.append({"stage": stage, "span": name,
                    "calls_per": r["calls"] / per if per else None,
                    "per": "step" if name in PER_STEP else "frame",
                    "self_ms": 1e-6 * r["self_ns"] / n,
                    "syncs": r["syncs"] / n,
                    "idle_ms": 1e-6 * r["idle_ns"] / n,
                    "long_idle_ms": 1e-6 * r["long_ns"] / n})
    total_idle = sum(b - a for a, b in idle_gaps)
    return {"frames": frames, "steps": steps, "idle_s": total_idle,
            "idle_share_no_span": (1e-9 * idle[None] / total_idle
                                   if total_idle else None),
            "rows": out}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=50.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import torch
    from portbench import harness
    _, _, config, _ = harness.load_cell(args.workload)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("span_table: needs a CUDA device", file=sys.stderr)
        return 2
    overrides = (harness.tiny_overrides(config) if args.device == "cpu"
                 else None)
    run, _, _, _ = harness.run_cell(args.workload, args.seed, args.seconds,
                                    True, args.device, T_START, overrides)
    res = {"workload": args.workload, "seed": args.seed,
           "device": run.device_name,
           "track_ms.keyframe": harness.load_reader("track_ms.keyframe")(run)}
    fit = [c for c in run.fusion if c.iters and not c.with_packet
           and run.in_window(c.t_start)]
    res["map_call_ms_per_step"] = (
        1e3 * sum(c.t_end - c.t_start for c in fit)
        / sum(c.iters for c in fit) if fit else None)
    try:
        from nerf_slam_tpu_torch.utils import runtime
        spans = runtime.spans()
    except (ImportError, AttributeError):
        spans = None
    if spans is not None:
        res.update(table(run, spans))
        res["loose_syncs"] = runtime.RECORDER.loose_syncs
        print("| stage | span | calls | self ms | syncs | idle ms "
              "| in gaps >= 1 ms |")
        print("|---|---|---|---|---|---|---|")
        for r in res["rows"]:
            calls = ("-" if r["calls_per"] is None
                     else f"{r['calls_per']:.2f}/{r['per']}")
            print(f"| {r['stage']} | `{r['span']}` | {calls} | "
                  f"{r['self_ms']:.3f} | {r['syncs']:.2f} | "
                  f"{r['idle_ms']:.3f} | {r['long_idle_ms']:.3f} |")
    summary = {k: v for k, v in res.items() if k != "rows"}
    print(json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
