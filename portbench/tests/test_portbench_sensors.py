"""A configuration's camera rig from data alone: an RGB-D and a stereo
configuration, written with a BENCHMARK.json naming them under a
directory of their own, run through the harness as the card runs a cell
(tiny sizes on the CPU, the look for a card skipped).  Each comes out
correct unbroken; a fault planted in the program's rig comes out not
correct on the number named; so does the control (the reference one
precision lower in the program's place)."""
import argparse
import dataclasses
import json
import shutil
import time

import pytest

from portbench import harness
from portbench import run as prun

SEED = 2 ** 31 + 4321


def rig_configs() -> dict:
    """``sigma_mono_384x512`` with an RGB-D sensor, and a EuRoC-like
    stereo rig (336x640, an 11 cm baseline, 64 active edge slots for the
    stereo edges) with the same tracker settings and Sigma-TSDF map."""
    base = harness.load_json(harness.ROOT / "configs"
                             / "sigma_mono_384x512.json")
    rgbd = dict(base, name="sigma_rgbd_384x512",
                deployment="RGB-D tracking (sensed depths seed keyframes "
                           "and anchor the gauge) with Sigma-TSDF fusion",
                tracker=dict(base["tracker"], sensor="rgbd"))
    stereo = dict(base, name="stereo_336x640", height=336, width=640,
                  deployment="stereo tracking on EuRoC's rig (11 cm "
                             "baseline) with Sigma-TSDF fusion",
                  tracker=dict(base["tracker"], sensor="stereo",
                               stereo_baseline_m=0.11, e_active=64))
    return {"rgbd": rgbd, "stereo": stereo}


def write_root(tmp_path) -> None:
    """BENCHMARK.json, the two configurations, the traffic mixes and the
    metric readers under ``tmp_path``, laid out as in the repository."""
    pkg = tmp_path / harness.ROOT.name
    for sub in ("traffic", "metrics"):
        shutil.copytree(harness.ROOT / sub, pkg / sub)
    (pkg / "configs").mkdir()
    configs, cells = [], []
    for config in rig_configs().values():
        name = config["name"]
        (pkg / "configs" / f"{name}.json").write_text(json.dumps(config))
        configs.append({"name": name,
                        "file": f"{pkg.name}/configs/{name}.json"})
        cells.append({"name": f"{name}.orbit", "config": name,
                      "traffic": "orbit", "chips": 1})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps({
        "configs": configs, "workloads": cells,
        "end_to_end": [{"name": n, "unit": u} for n, u in (
            ("frames_per_s", "frames/s"), ("setup_s", "s"))],
        "per_layer": []}))


def measure(root, workload, faults=None, control=False, seconds=40.0):
    bench, entry, config, _ = harness.load_cell(workload, root)
    args = argparse.Namespace(workload=workload, seed=SEED, seconds=seconds,
                              trace=0, control=control)
    return prun.measure(args, bench, entry, config, time.perf_counter(),
                        device="cpu", overrides=harness.tiny_overrides(config),
                        faults=faults, root=root)


def failed(res):
    return [k for k, v in res["checks"].items()
            if v["limit"] is not None and v["value"] is not None
            and v["value"] > v["limit"]]


def identity_rig(cell):
    """The program's rig pose replaced by the identity: its stereo edges
    project every pixel onto itself."""
    fcfg = cell.fcfg
    cell.fcfg = dataclasses.replace(
        fcfg, stereo_rel=(0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0))
    return lambda: setattr(cell, "fcfg", fcfg)


def left_for_right(cell):
    """Each keyframe's right features replaced by its left ones where the
    tracker stores them: the stereo edges correlate the left view with
    itself."""
    from nerf_slam_tpu_torch.tracking.frontend import RaftVisualFrontend
    orig = RaftVisualFrontend._ingest

    def ingest(self, k, slot, batch, with_motion):
        mag = orig(self, k, slot, batch, with_motion)
        self.state.features1[slot] = self.state.features[slot]
        return mag
    RaftVisualFrontend._ingest = ingest
    return lambda: setattr(RaftVisualFrontend, "_ingest", orig)


def sensed_scaled(cell):
    """The sensed inverse depths 5% high where the tracker derives them
    from the packet's depths."""
    from nerf_slam_tpu_torch.tracking.frontend import RaftVisualFrontend
    orig = RaftVisualFrontend._ingest

    def ingest(self, k, slot, batch, with_motion):
        if batch.get("idepths_sensed") is not None:
            batch = dict(batch, idepths_sensed=batch["idepths_sensed"] * 1.05)
        return orig(self, k, slot, batch, with_motion)
    RaftVisualFrontend._ingest = ingest
    return lambda: setattr(RaftVisualFrontend, "_ingest", orig)


@pytest.mark.parametrize("sensor,fault,caught_by", [
    ("rgbd", None, None),
    ("stereo", None, None),
    ("stereo", identity_rig, ("round_flow_px", "dba_gap")),
    ("stereo", left_for_right, ("round_flow_px",)),
    ("rgbd", sensed_scaled, ("dba_gap",)),
    ("rgbd", "control", None),
    ("stereo", "control", None),
])
def test_rig_runs_from_data_and_its_faults_are_caught(tmp_path, sensor,
                                                      fault, caught_by):
    write_root(tmp_path)
    workload = f"{rig_configs()[sensor]['name']}.orbit"
    restore = []

    def install(cell):
        assert cell.sensor == sensor
        restore.append(fault(cell))
    try:
        res = measure(tmp_path, workload, control=fault == "control",
                      faults=install if callable(fault) else None)
    finally:
        for undo in restore:
            undo()
    if fault is None:
        assert res["correct"] is True, res["checks"]
        kinds = res["frames_by_kind"]
        assert kinds["kept"] + kinds["rejected"] > 0
    else:
        assert res["correct"] is False
        assert failed(res), res["checks"]
        if caught_by is not None:
            assert set(caught_by) & set(failed(res)), res["checks"]
