"""Kernel #1 (``corr_lookup_grouped4_kernel<__nv_bfloat16, false>``, the
update round's lookup): the least time its launches in the window could
take at the card's HBM rate, over their device time, in percent.  Memory
bounds it: the bytes are each in-bounds bf16 tap of every live edge's
8x8 supports read once, the coords read once and the bf16 output written
once (``yardstick.lookup_bytes``, from the coords each launch got)."""
from portbench.yardstick import lookup_bytes, peaks

KERNEL = "corr_lookup_grouped4_kernel<__nv_bfloat16, false>"


def read(run):
    p = peaks(run.device_name)
    calls = [c for c in run.lookups if c[0] == "lookup4g"]
    dev_s = sum(e - s for name, s, e in run.device_events if KERNEL in name)
    if p is None or not calls or dev_s <= 0:
        return None
    nbytes = sum(lookup_bytes(coords, int(n_act), dims, slabs, 2)
                 for _, coords, n_act, dims, slabs in calls)
    return 100.0 * nbytes / p["hbm_bytes_s"] / dev_s
