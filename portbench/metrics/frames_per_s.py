"""Frames the tracker finished in the window (keyframes, rejected
keyframes and frames the motion filter stopped alike), over the window's
seconds."""


def read(run):
    done = [f for f in run.frames
            if run.t_open <= f.t_hand and f.t_end <= run.t_close]
    return len(done) / (run.t_close - run.t_open)
