"""Mean ms per tracker call in which the device ran nothing: the gaps of
the union of the window's kernels, copies and sets that fall inside each
``track.frame`` span (the program's) starting in the window; nothing
without device events or spans."""
from bisect import bisect_right

from portbench.yardstick import gaps


def read(run):
    try:
        from nerf_slam_tpu_torch.utils.runtime import spans
    except ImportError:
        return None
    lo, hi = run.t_open * 1e9, run.t_close * 1e9
    frames = [s for s in spans("track.frame") if lo <= s.t0 < hi]
    if not frames or not run.device_events:
        return None
    idle = gaps([(s, e) for _, s, e in run.device_events], run.t_open,
                run.t_close)
    starts = [g[0] for g in idle]
    total = 0.0
    for f in frames:
        a, b = f.t0 * 1e-9, f.t1 * 1e-9
        i = max(bisect_right(starts, a) - 1, 0)
        while i < len(idle) and idle[i][0] < b:
            total += max(0.0, min(b, idle[i][1]) - max(a, idle[i][0]))
            i += 1
    return 1e3 * total / len(frames)
