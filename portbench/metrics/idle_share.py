"""Share of the traced window in which no kernel, copy or set ran on the
device (the union of their intervals)."""
from portbench.yardstick import union_length


def read(run):
    if not run.device_events:
        return None
    busy = union_length([(s, e) for _, s, e in run.device_events])
    return 100.0 * (1.0 - busy / (run.t_close - run.t_open))
