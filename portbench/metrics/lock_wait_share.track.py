"""Of the time from a frame's handoff to the tracker's output, the share
spent outside the tracker's call: waiting for the device lock (held by the
mapping stage) and in the stage's queue.  Percent, over the window's
frames."""


def read(run):
    fr = run.window_frames()
    total = sum(f.t_end - f.t_hand for f in fr)
    if total <= 0:
        return None
    inside = sum(f.t_end - f.t_start for f in fr)
    return 100.0 * (total - inside) / total
