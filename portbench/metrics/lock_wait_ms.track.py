"""Mean ms the tracking stage waited to acquire the device lock (the
program's ``lock.wait`` spans of the ``slam`` stage) per tracker call
(``track.frame`` spans), over the spans that start in the window; nothing
where the program records no spans."""


def read(run):
    try:
        from nerf_slam_tpu_torch.utils.runtime import spans
    except ImportError:
        return None
    lo, hi = run.t_open * 1e9, run.t_close * 1e9
    frames = [s for s in spans("track.frame") if lo <= s.t0 < hi]
    waits = [s for s in spans("lock.wait")
             if s.stage == "slam" and lo <= s.t0 < hi]
    if not frames:
        return None
    return 1e-6 * sum(s.t1 - s.t0 for s in waits) / len(frames)
