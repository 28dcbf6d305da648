"""The comparison that decides ``correct``: what the window's timed path
produced, against the plain reference in ``reference/``.

Numbers compared (each against its limit, in the configuration's
``limits``):

- ``motion_gap``: the motion filter's magnitude (encoders, lookup #2, one
  update) on frames drawn from the seed, the worst relative gap;
- ``round_flow_px``: iterations of update rounds drawn from the seed,
  each replayed from the carry the program held before it, with features,
  contexts and pyramids from the frames (lookup #1, update operator): the
  median pixel gap of the flow targets (with a stereo rig, the worse of
  the stereo edges' median and the other edges');
- ``dba_gap``: the same iterations' dense BA on the flow targets, weights
  and damping the program's update operator left: the median relative
  gap of the inverse depths;
- NeRF map: ``map_step_gap``, one training step drawn from the seed,
  replayed from the field's parameters, Adam state, training set and
  draws that the program's step started from (hash-grid encode, MLP,
  volume rendering, loss, backward, Adam): ||program - reference|| /
  ||reference|| of the parameters' change, over the leaves the
  reference's gradient moves; ``ingest_gap``, a packet's views as
  training-set rows;
- TSDF map: ``tsdf_gap`` (a packet's integration).

The rig is the configuration's: a stereo rig's right views and rig pose,
an RGB-D sensor's sensed inverse depths, each recomputed from the frames
and the configuration, never read from the program.

``stand_in`` puts the reference in the program's place: ``"control"``
one precision below the configuration's (float8 for the tracker's network
and the field's MLP, both bfloat16; bfloat16 inputs and TF32 products for
the float32 BA; bfloat16 for the float32 ingest and integration);
``"half_batch"`` the map step with its loss over half the rendered rays
(the map step's number only).  The benchmark's own runs never set it.
"""
from __future__ import annotations

import json
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .harness import WEIGHTS
from .reference import ate, droid, mapref

MIN_SESSION_KEYFRAMES = 10


def compare(probes, cell, stand_in: Optional[str] = None
            ) -> Dict[str, float]:
    """The numbers compared, by name."""
    droid.plain_precision()
    dev = cell.device
    cfg = cell.config
    out: Dict[str, float] = {}
    control = stand_in == "control"
    tracker = stand_in in (None, "control")

    quant = droid.fp8 if control else None
    weights = str(WEIGHTS)
    if tracker and (probes.motion or probes.rounds):
        net = droid.load_net(weights, dev)
        ctrl = droid.load_net(weights, dev, quant=droid.fp8) if control \
            else None
        imgs = torch.as_tensor(cell.images, device=dev)
        right = None if cell.images_right is None \
            else torch.as_tensor(cell.images_right, device=dev)
        depths = None if cell.depths is None \
            else torch.as_tensor(cell.depths, device=dev)
    if tracker and probes.motion:
        gaps = []
        for p in probes.motion:
            a, b = imgs[p["frame"]], imgs[p["last_kf_frame"]]
            ref = droid.motion_magnitude(net, a, b)
            prog = droid.motion_magnitude(ctrl, a, b) if control \
                else p["mag"]
            gaps.append(abs(prog - ref) / max(abs(ref), 1e-12))
        out["motion_gap"] = max(gaps)
    if tracker and probes.rounds:
        tcfg = tracker_settings(cell)
        stereo = tcfg["stereo_rel"] is not None
        flow, disp = [], []
        for cap in probes.rounds:
            sensed = droid.sensed_idepths(cap, depths, tcfg)
            for before, after in cap["steps"]:
                ref = droid.update_step(net, cap, before, imgs, cell.K, tcfg,
                                        right)
                prog = droid.update_step(ctrl, cap, before, imgs, cell.K,
                                         tcfg, right) if control else after
                flow.append(droid.flow_gap(cap, prog, ref, stereo))
                ref = droid.dba_step(cap, before, after, cell.K, tcfg, sensed)
                prog = droid.dba_step(cap, before, after, cell.K, tcfg,
                                      sensed, lower=True) \
                    if control else after
                disp.append(droid.disp_gap(cap, prog, ref))
        out["round_flow_px"] = max(flow)
        out["dba_gap"] = max(disp)

    m = cfg["map"]
    for cap in probes.map_steps:
        ref = mapref.ngp_step(m, cap["before"], cap["train_set"],
                              cap["batch"])
        prog = mapref.program_change(cap["before"], cap["after"]) \
            if stand_in is None else mapref.ngp_step(
                m, cap["before"], cap["train_set"], cap["batch"],
                quant=quant, half=stand_in == "half_batch")["change"]
        out["map_step_gap"] = mapref.change_gap(
            prog, ref["change"], mapref.moved_leaves(ref["grad"]))
    if not tracker:
        return out
    scale, offset = m.get("scene_scale"), m.get("scene_offset")
    for cap in probes.ingests:
        ref = mapref.ingest_rows(cap["packet"], scale, offset)
        prog = mapref.ingest_rows(cap["packet"], scale, offset,
                                  torch.bfloat16) if control else cap["rows"]
        out["ingest_gap"] = mapref.rows_gap(prog, ref)
    for cap in probes.tsdf:
        ref = mapref.tsdf_integrate(cap["before"], cap["packet"], m,
                                    cap["sigma_thresh"])
        prog = mapref.tsdf_integrate(cap["before"], cap["packet"], m,
                                     cap["sigma_thresh"], torch.bfloat16) \
            if control else cap["after"]
        out["tsdf_gap"] = mapref.volume_gap(cap["before"], prog, ref)
    return out


def tracker_settings(cell) -> dict:
    """The DBA's settings and the rig pose as the configuration and the
    weights' sidecar state them (the reference reads them there, not from
    the program): a right camera ``stereo_baseline_m`` along the left
    one's x axis is cam1_T_cam0 = [-b, 0, 0, 0, 0, 0, 1]."""
    t = cell.config["tracker"]
    with open(str(WEIGHTS) + ".json") as f:
        meta = json.load(f)
    b = t.get("stereo_baseline_m") if t.get("sensor") == "stereo" else None
    return {"dsf": 8, "gn_iters": t["gn_iters"], "ep": t["ep"],
            "lm": t["lm"], "damping_scale": float(meta["damping_scale"]),
            "damping_offset": float(meta["damping_offset"]),
            "stereo_rel": None if b is None else torch.tensor(
                [-float(b), 0.0, 0.0, 0.0, 0.0, 0.0, 1.0])}


def judge(numbers: Dict[str, float], limits: Dict[str, float],
          expected) -> Tuple[bool, Dict[str, dict]]:
    """``correct`` and each number beside its limit.  A number the cell
    expects but the run did not produce, or one without a limit, fails."""
    table, ok = {}, True
    for name in expected:
        v, lim = numbers.get(name), limits.get(name)
        passed = v is not None and lim is not None and np.isfinite(v) \
            and v <= lim
        ok &= bool(passed)
        table[name] = {"value": v, "limit": lim}
    return ok, table


def expected_numbers(config: dict) -> Tuple[str, ...]:
    base = ("motion_gap", "round_flow_px", "dba_gap")
    if config["map"]["kind"] == "nerf":
        return base + ("map_step_gap", "ingest_gap")
    return base + ("tsdf_gap",)


def session_ate(rows) -> list:
    """Each session's keyframe trajectory error (Sim(3) aligned, metres)
    against the frames' ground truth, for sessions with enough keyframes
    to align.  Reported beside the comparison, not held to a limit: the
    tracker's error on these sequences swings from seed to seed (0.04 to
    0.55 m) within reach of a trajectory that never moves (about 0.8 m)."""
    return [ate.session_ate(r) for r in rows
            if len(r) >= MIN_SESSION_KEYFRAMES]
