"""Mean ms of a depth packet's sensing (the program's ``track.sense``
spans that start in the window: the packet's depths to sensed inverse
depths at feature resolution, their upload and the depths' upload);
nothing where the program records no such span (a monocular cell, or a
program without it)."""


def read(run):
    try:
        from nerf_slam_tpu_torch.utils.runtime import spans
    except ImportError:
        return None
    lo, hi = run.t_open * 1e9, run.t_close * 1e9
    ms = [1e-6 * (s.t1 - s.t0) for s in spans("track.sense")
          if lo <= s.t0 < hi]
    return sum(ms) / len(ms) if ms else None
