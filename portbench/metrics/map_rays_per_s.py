"""NeRF training rays (iterations x ``batch_rays``) of the mapping calls
that ended inside the window, over the window's seconds; nothing for a
map that does not train."""


def read(run):
    m = run.config["map"]
    if m["kind"] != "nerf":
        return None
    iters = sum(c.iters for c in run.fusion
                if run.t_open <= c.t_start and c.t_end <= run.t_close)
    return iters * m["batch_rays"] / (run.t_close - run.t_open)
