"""Mean ms of the TSDF map's calls that integrated a packet."""


def read(run):
    if run.config["map"]["kind"] != "tsdf":
        return None
    ms = [1e3 * (c.t_end - c.t_start) for c in run.fusion
          if c.with_packet and run.t_open <= c.t_start < run.t_close]
    return sum(ms) / len(ms) if ms else None
