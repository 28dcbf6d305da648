"""The hash-grid map's training FLOPs in the window over the window's
seconds times the card's bf16 dense peak (the field's matrix products run
in bf16), in percent.

A step is ``batch_rays`` rays of ``n_uniform + n_depth`` samples; a
sample costs the hash encoding (trilinear weights and features over 8
corners of each level, and the table gradient's scatter), the density
and colour MLPs forward and twice that backward, and a few operations of
rendering and loss; counted from the configuration's shapes and the
iterations the window completed."""
from portbench.yardstick import peaks


def step_flops(m: dict) -> float:
    g = m["grid"]
    L, F = g["n_levels"], g["n_features"]
    hid, geo = m["hidden"], 15
    encode = L * 8 * (2 + 2 * F)          # corner weight, feature FMAs
    encode_bwd = L * 8 * F                # table gradient
    mlp = 2 * (L * F * hid + hid * (1 + geo) + (geo + 16) * hid
               + hid * hid + hid * 3)
    render = 10
    per_sample = encode + encode_bwd + 3 * mlp + 3 * render
    return m["batch_rays"] * (m["n_uniform"] + m["n_depth"]) * per_sample


def read(run):
    m = run.config["map"]
    p = peaks(run.device_name)
    if m["kind"] != "nerf" or p is None or not run.device_events:
        return None
    iters = sum(c.iters for c in run.fusion
                if run.t_open <= c.t_start and c.t_end <= run.t_close)
    return 100.0 * iters * step_flops(m) / (
        (run.t_close - run.t_open) * p["bf16"])
