"""Kernel #2 (``corr_lookup_grouped4_kernel<float, true>``, the motion
filter's lookup): the least time its launches in the window could take at
the card's HBM rate, over their device time, in percent.  Memory bounds
it: each in-bounds bf16 tap of the frame's 8x8 supports read once, the
coords read once and the f32 output written once."""
from portbench.yardstick import lookup_bytes, peaks

KERNEL = "corr_lookup_grouped4_kernel<float, true>"


def read(run):
    p = peaks(run.device_name)
    calls = [c for c in run.lookups if c[0] == "lookup_mf"]
    dev_s = sum(e - s for name, s, e in run.device_events if KERNEL in name)
    if p is None or not calls or dev_s <= 0:
        return None
    nbytes = sum(lookup_bytes(coords, coords.shape[0], dims, slabs, 4)
                 for _, coords, _, dims, slabs in calls)
    return 100.0 * nbytes / p["hbm_bytes_s"] / dev_s
