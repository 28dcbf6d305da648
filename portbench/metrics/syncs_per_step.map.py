"""Host waits for the device (syncs, as ``syncs_per_frame.track`` counts
them) inside NeRF training steps, summed over each ``map.step`` span's
subtree, over the number of those spans that start in the window;
nothing for a map that does not train or a program that records no
spans."""


def read(run):
    try:
        from nerf_slam_tpu_torch.utils.runtime import spans
    except ImportError:
        return None
    lo, hi = run.t_open * 1e9, run.t_close * 1e9
    steps = [s for s in spans("map.step") if lo <= s.t0 < hi]
    if not steps:
        return None
    return sum(s.subtree_syncs() for s in steps) / len(steps)
