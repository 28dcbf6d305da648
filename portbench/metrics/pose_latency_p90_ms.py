"""The 90th percentile (nearest rank), over every frame handed to the
tracking stage in the window, of the time from the handoff until the
tracker's output for it is out and its newest pose is on the host; a frame
still in flight when the window closes is waited for."""
from portbench.yardstick import percentile


def read(run):
    lat = [1e3 * (f.t_end - f.t_hand) for f in run.window_frames()]
    return percentile(lat, 90) if lat else None
