"""Mean ms of an update iteration (the program's ``track.iter`` spans:
projective transform, lookup #1, update operator, damping pool, dense
BA) over those that start in the window; nothing where the program
records no spans."""


def read(run):
    try:
        from nerf_slam_tpu_torch.utils.runtime import spans
    except ImportError:
        return None
    lo, hi = run.t_open * 1e9, run.t_close * 1e9
    ms = [1e-6 * (s.t1 - s.t0) for s in spans("track.iter")
          if lo <= s.t0 < hi]
    return sum(ms) / len(ms) if ms else None
