"""Share (%) of the depth pixels in the dense BA's windows that carry the
sensed-depth prior: over the program's ``track.dba`` spans that start in
the window, the sum of their ``sensed_px`` (feature-grid pixels of the
solve's depth slots with a sensed inverse depth) over the sum of their
``depth_px`` (those with a valid depth), both counted on the host at
ingest.  Nothing where the program records no such counts or no solve
saw a depth (a monocular cell)."""


def read(run):
    try:
        from nerf_slam_tpu_torch.utils.runtime import spans
    except ImportError:
        return None
    lo, hi = run.t_open * 1e9, run.t_close * 1e9
    calls = [s for s in spans("track.dba") if lo <= s.t0 < hi
             and "depth_px" in s.ids and "sensed_px" in s.ids]
    depth = sum(s.ids["depth_px"] for s in calls)
    if not depth:
        return None
    return 100.0 * sum(s.ids["sensed_px"] for s in calls) / depth
