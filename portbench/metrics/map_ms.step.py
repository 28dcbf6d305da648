"""Mean ms of a NeRF training step (the program's ``map.step`` spans:
draws, loss, backward, Adam) over those that start in the window;
nothing for a map that does not train or a program that records no
spans."""


def read(run):
    try:
        from nerf_slam_tpu_torch.utils.runtime import spans
    except ImportError:
        return None
    lo, hi = run.t_open * 1e9, run.t_close * 1e9
    ms = [1e-6 * (s.t1 - s.t0) for s in spans("map.step")
          if lo <= s.t0 < hi]
    return sum(ms) / len(ms) if ms else None
