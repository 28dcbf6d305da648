"""Mean ms of the tracker's calls on frames the motion filter passed
(each runs an update round once the tracker is initialized, whether the
keyframe is kept or rejected)."""


def read(run):
    ms = [1e3 * (f.t_end - f.t_start) for f in run.window_frames()
          if f.kind in ("kept", "rejected")]
    return sum(ms) / len(ms) if ms else None
