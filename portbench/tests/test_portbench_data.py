"""BENCHMARK.json against the benchmark's contract, the harness finding
everything by name, the result line's keys, and the isolation checks."""
import argparse
import ast
import json
import re
import shutil
import sys
import time
from pathlib import Path

import pytest

from portbench import harness
from portbench import run as prun

REPO = Path(__file__).resolve().parents[2]
PKG = REPO / "portbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(BENCH["command"]) <= 32
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word


def test_names_units_and_entry_keys():
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
        assert (REPO / c["file"]).exists()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] == 1
        assert len(w["why"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in names
        names.add(m["name"])
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        cells = e2e[m["moves"]].get("workloads")
        for w in m["workloads"]:
            assert cells is None or w in cells


def test_every_cell_reports_setup_another_e2e_and_a_layer_metric():
    for w in BENCH["workloads"]:
        e2e = [m["name"] for m in harness.metrics_for(BENCH, w["name"],
                                                      False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.metrics_for(BENCH, w["name"], True)


def test_harness_finds_everything_by_name():
    for w in BENCH["workloads"]:
        _, cell, config, traffic = harness.load_cell(w["name"])
        assert config["name"] == w["config"]
        assert traffic["session_frames"] > 0
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(harness.load_reader(m["name"]))


def test_contended_metrics_read_as_their_bases():
    """A ``.contended`` metric is its base's reader, reported per layer in
    the cells that leave the base out of their end-to-end metrics."""
    orbit = "ngp_mono_344x616.orbit"
    e2e = [m["name"] for m in harness.metrics_for(BENCH, orbit, False)]
    assert e2e == ["map_rays_per_s", "setup_s"]
    contended = [m for m in BENCH["per_layer"]
                 if m["name"].endswith(".contended")]
    assert contended
    for m in contended:
        base = m["name"][:-len(".contended")]
        read = harness.load_reader(m["name"])
        assert read.__module__ == "portbench_metric_" + base.replace(".", "_")
        assert m["moves"] == "map_rays_per_s" and m["workloads"] == [orbit]


def test_new_files_are_found_without_editing(tmp_path):
    """A configuration, a traffic mix and a metric added as new files (and
    entries in BENCHMARK.json) are found by name."""
    pkg = tmp_path / "portbench"
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(PKG / sub, pkg / sub)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cfg = json.loads((PKG / "configs" / "ngp_mono_344x616.json").read_text())
    cfg["name"] = "ngp_new"
    (pkg / "configs" / "ngp_new.json").write_text(json.dumps(cfg))
    (pkg / "traffic" / "zigzag.json").write_text(json.dumps(
        {"deg_per_frame": 3.0, "session_frames": 60}))
    (pkg / "metrics" / "new_metric.py").write_text(
        "def read(run):\n    return 42.0\n")
    bench["configs"].append({"name": "ngp_new", "source": "x",
                             "file": "portbench/configs/ngp_new.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "ngp_new.zigzag", "config": "ngp_new",
                               "traffic": "zigzag", "chips": 1, "why": "x"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    _, _, config, traffic = harness.load_cell("ngp_new.zigzag", tmp_path)
    assert config["name"] == "ngp_new" and traffic["deg_per_frame"] == 3.0
    assert harness.load_reader("new_metric", tmp_path)(None) == 42.0


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_reference_imports_nothing_of_the_program():
    for path in (PKG / "reference").glob("*.py"):
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("nerf_slam_tpu_torch", "nerf_slam_tpu", "jax",
                               "jaxlib", "flax"), (path.name, mod)


def test_nothing_imports_jax_or_reads_the_jax_era_bench():
    for path in PKG.rglob("*.py"):
        for mod in _imports(path):
            assert mod.split(".")[0] not in ("nerf_slam_tpu", "jax",
                                             "jaxlib", "flax"), (path, mod)
        if path.parent.name != "tests":
            text = path.read_text()
            assert "BENCH_" not in text and "bench.py" not in text \
                and '"bench"' not in text, path


def test_forbidden_modules_compare_whole_top_level_names():
    fake = "nerf_slam_tpu.portbench_probe"
    sys.modules[fake] = type(sys)("probe")
    try:
        assert fake in harness.loaded_forbidden()
    finally:
        del sys.modules[fake]
    assert not [m for m in harness.loaded_forbidden()
                if m.startswith("nerf_slam_tpu_torch")]


def test_no_gpu_exits_nonzero_without_a_result(capsys, monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    rc = prun.main(["--workload", "sigma_mono_384x512.orbit", "--seed",
                    "1", "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_keys_on_a_tiny_cpu_run(trace):
    wl = "sigma_mono_384x512.orbit"
    bench, entry, config, _ = harness.load_cell(wl)
    args = argparse.Namespace(workload=wl, seed=2 ** 31 + 77, seconds=6.0,
                              trace=trace, control=False)
    res = prun.measure(args, bench, entry, config, time.perf_counter(),
                       device="cpu", overrides=harness.tiny_overrides(config))
    keys = list(res)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    if trace:
        assert "breakdown" in res and "window_s" in res["device"]
        assert "track_ms.keyframe" in res["metrics"]
    else:
        assert set(res["metrics"]) == {"frames_per_s", "pose_latency_p90_ms",
                                       "setup_s"}
    assert set(res["checks"]) == {"motion_gap", "round_flow_px",
                                  "dba_gap", "tsdf_gap"}
    json.dumps(res)
