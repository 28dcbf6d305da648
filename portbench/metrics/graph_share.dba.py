"""Share (%) of the dense BA's calls (the program's ``track.dba`` spans
that start in the window) that replayed a CUDA graph: those with a
``dba.replay`` child span.  Nothing where the program records no spans
or has no graph path (no ``solver.dba.GRAPH_COUNTS``)."""


def read(run):
    try:
        from nerf_slam_tpu_torch.solver import dba
        from nerf_slam_tpu_torch.utils.runtime import spans
    except ImportError:
        return None
    if not hasattr(dba, "GRAPH_COUNTS"):
        return None
    lo, hi = run.t_open * 1e9, run.t_close * 1e9
    calls = [s for s in spans("track.dba") if lo <= s.t0 < hi]
    if not calls:
        return None
    replayed = sum(any(c.name == "dba.replay" for c in s.children)
                   for s in calls)
    return 100.0 * replayed / len(calls)
