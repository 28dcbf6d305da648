"""Host waits for the device (syncs: reads to the host, blocking copies
from pageable memory, stream synchronizes; CUDA's sync debug mode flags
each) inside the tracker's calls, counted by the program against the
innermost open span, summed over each ``track.frame`` span's subtree,
over the number of those spans that start in the window; nothing where
the program records no spans."""


def read(run):
    try:
        from nerf_slam_tpu_torch.utils.runtime import spans
    except ImportError:
        return None
    lo, hi = run.t_open * 1e9, run.t_close * 1e9
    frames = [s for s in spans("track.frame") if lo <= s.t0 < hi]
    if not frames:
        return None
    return sum(s.subtree_syncs() for s in frames) / len(frames)
