"""The port's ``slam_demo`` CLI and ``FusionModule`` modes on the CPU at a
tiny size: the CLI runs the synthetic room through tracking and each map
backend, with ``--stereo``, ``--rgbd`` and ``--profile``, and TUM and
EuRoC fixtures, and prints the JSON keys the JAX package's CLI prints;
``--gui`` (with ``--viewer_port``), ``--device_split`` and
``--edge_shards`` run; the fusion stage's modes end as the JAX stage's
do, and its commands act on the map."""
import json
import os

import numpy as np
import pytest
import torch

from nerf_slam_tpu.pipeline import modules as jmod
from nerf_slam_tpu_torch import fusion as tfusion
from nerf_slam_tpu_torch.cli import slam_demo
from nerf_slam_tpu_torch.pipeline import modules as tmod

WEIGHTS = os.path.join(os.path.dirname(__file__), "..",
                       "weights_synthetic.npz")
# 10 frames leave the 8-keyframe warm-up behind, so the map gets depths
TINY = ["--device", "cpu", "--height", "48", "--width", "64",
        "--n_frames", "10", "--buffer", "12", "--weights", WEIGHTS]
# the keys the JAX CLI prints (nerf_slam_tpu/cli/slam_demo.py:run)
BASE_KEYS = {"wall_s", "n_keyframes", "kf_per_s", "data_mean_ms",
             "slam_mean_ms", "eval_mean_ms", "ate_rmse_m"}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several test processes on a
    few cores, where many threads a process contend and slow every test
    far more than one thread does."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(capsys, argv):
    res = slam_demo.run(slam_demo.parse_args(argv))
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(printed) == set(res)
    return res


def test_cli_sigma_fusion_eval(capsys, monkeypatch):
    """``--fusion sigma --eval``: the TSDF integrates the tracked
    keyframes, and the run prints the tracking keys and the TSDF's
    ``fusion_psnr`` / ``fusion_depth_l1_cm`` row."""
    built = []
    build = slam_demo.build_fusion
    monkeypatch.setattr(slam_demo, "build_fusion",
                        lambda args: built.append(build(args)) or built[-1])
    res = _run(capsys, TINY + ["--fusion", "sigma", "--eval"])
    assert set(res) == BASE_KEYS | {"fusion_mean_ms", "fusion_psnr",
                                    "fusion_depth_l1_cm"}
    assert res["n_keyframes"] > 8 and np.isfinite(res["ate_rmse_m"])
    tsdf, mode = built[0]
    assert mode == "sigma" and tsdf.cfg.depth_mask_type == "weighted"
    assert len(tsdf.history) > 8
    assert int((tsdf.volume.weight > 0).sum()) > 1000


def test_cli_nerf_fusion(capsys, monkeypatch, tmp_path):
    """``--fusion nerf --eval``: the NeRF trains (a narrow field, 32 rays
    a batch and few samples, to keep the CPU run short), rows are written
    to ``--out``, and the evaluation row's keys are the JAX CLI's."""
    small = tfusion.NerfFusionConfig
    ngp = tfusion.NGPConfig(pe_hidden=32, hidden=16, n_uniform=16,
                            n_depth=8)

    def config(**kw):
        return small(batch_rays=32, ngp=ngp, render_samples=16, occ_res=16,
                     **kw)

    monkeypatch.setattr(tfusion, "NerfFusionConfig", config)
    out = tmp_path / "results.csv"
    res = _run(capsys, TINY + ["--fusion", "nerf", "--eval", "--eval_every",
                               "200", "--eval_views", "2", "--out",
                               str(out)])
    assert set(res) == BASE_KEYS | {
        "fusion_mean_ms", "fusion_iteration", "fusion_wall_s", "fusion_psnr",
        "fusion_depth_l1_cm", "fusion_depth_l1_aligned_cm"}
    assert res["fusion_iteration"] >= 200 and np.isfinite(res["fusion_psnr"])
    lines = out.read_text().splitlines()
    assert lines[0] == ("iteration,wall_s,psnr,depth_l1_cm,"
                        "depth_l1_aligned_cm")
    assert len(lines) >= 3


@pytest.mark.parametrize("flag", ["--stereo", "--rgbd"])
def test_cli_stereo_and_rgbd_run(capsys, monkeypatch, flag):
    """``--stereo`` tracks with the synthetic room's right camera and the
    rig pose its packets carry; ``--rgbd`` seeds sensed inverse depths
    from the packets' depths.  Both run to the end and print the JAX
    CLI's keys."""
    built = []
    build = slam_demo.build_frontend
    monkeypatch.setattr(slam_demo, "build_frontend", lambda *a: built.append(
        build(*a)) or built[-1])
    res = _run(capsys, TINY + ["--fusion", "none", flag])
    assert set(res) == BASE_KEYS
    assert res["n_keyframes"] > 8 and np.isfinite(res["ate_rmse_m"])
    fe = built[0]
    n = fe.kf_idx + 1
    assert torch.isfinite(fe.state.cam_T_world[:n]).all()
    assert torch.isfinite(fe.state.idepths[:n]).all()
    if flag == "--stereo":
        assert fe.cfg.stereo and not fe.cfg.rgbd
        np.testing.assert_array_equal(                  # the packets' f32
            np.float32(fe.cfg.stereo_rel), np.float32([-0.1, 0, 0, 0, 0, 0,
                                                        1]))
        assert int((fe.graph.ii == fe.graph.jj).sum()) > 0
        assert float(fe.state.features1.abs().sum()) > 0
    else:
        assert fe.cfg.rgbd and not fe.cfg.stereo
        assert bool((fe.state.idepths_sensed[:n - 1] > 0).all())


def _small_nerf(monkeypatch):
    """A narrow NeRF map (32 rays a batch, few samples; its mesh 32^3, at
    density 1, which the barely trained field crosses) to keep the CPU
    runs short; returns the list the built maps go to."""
    small = tfusion.NerfFusionConfig
    ngp = tfusion.NGPConfig(pe_hidden=32, hidden=16, n_uniform=16,
                            n_depth=8)
    monkeypatch.setattr(tfusion, "NerfFusionConfig", lambda **kw: small(
        batch_rays=32, ngp=ngp, render_samples=16, occ_res=16, **kw))
    mesh = tfusion.NerfFusion.extract_mesh
    monkeypatch.setattr(tfusion.NerfFusion, "extract_mesh",
                        lambda self, path="fusion_mesh.obj": mesh(
                            self, path, resolution=32, iso=1.0))
    built = []
    build = slam_demo.build_fusion
    monkeypatch.setattr(slam_demo, "build_fusion",
                        lambda args: built.append(build(args)) or built[-1])
    return built


def test_cli_gui_exports_and_commands(capsys, monkeypatch, tmp_path):
    """``--gui``: the headless GUI stage writes its clouds, trajectory and
    heatmaps under ``--viz_out``, and its end commands reach the fusion
    stage, which writes the mesh into the working directory and
    evaluates."""
    _small_nerf(monkeypatch)
    monkeypatch.chdir(tmp_path)
    viz = tmp_path / "viz"
    res = slam_demo.run(slam_demo.parse_args(
        TINY + ["--fusion", "nerf", "--gui", "--viz_out", str(viz)]))
    out = capsys.readouterr().out
    assert json.loads(out.strip().splitlines()[-1]) == res
    assert res["n_keyframes"] > 8 and "gui_mean_ms" in res
    files = os.listdir(viz)
    assert "trajectory.json" in files
    for prefix in ("cloud_", "depth_", "sigma_"):
        assert any(f.startswith(prefix) for f in files), (prefix, files)
    traj = json.loads((viz / "trajectory.json").read_text())
    assert {t["kf"] for t in traj} == set(range(res["n_keyframes"]))
    assert "[fusion] eval:" in out
    assert (tmp_path / "fusion_mesh.obj").read_text().startswith("v ")


def test_cli_gui_live_viewer(capsys, monkeypatch, tmp_path):
    """``--gui --viewer_port``: a live viewer on that port serves the run's
    trajectory, one entry a keyframe packet."""
    import socket

    from nerf_slam_tpu_torch import gui
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    viewers = []
    cls = gui.LiveViewer
    monkeypatch.setattr(gui, "LiveViewer", lambda *a, **k: viewers.append(
        cls(*a, **k)) or viewers[-1])
    res = slam_demo.run(slam_demo.parse_args(
        TINY + ["--fusion", "none", "--gui", "--viewer_port", str(port),
                "--viz_out", str(tmp_path)]))
    v = viewers[0]
    try:
        assert v.port == port
        assert f"live viewer at http://localhost:{port}/" in \
            capsys.readouterr().out
        import urllib.request
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/state.json",
                                    timeout=10) as r:
            state = json.loads(r.read())
        assert {t["kf"] for t in state["trajectory"]} == \
            set(range(res["n_keyframes"]))
    finally:
        v.close()


def test_cli_device_split_parallel(capsys, monkeypatch):
    """``--device_split --parallel_run`` with one device of the type
    (the CPU): JAX's fallback line, and mapping stays on that device
    while its NGP iterations advance beside tracking."""
    built = _small_nerf(monkeypatch)
    res = slam_demo.run(slam_demo.parse_args(
        TINY + ["--fusion", "nerf", "--device_split", "--parallel_run"]))
    assert ("device_split requested but only one device visible; falling "
            "back to shared-device scheduling") in capsys.readouterr().out
    fusion, _ = built[0]
    assert fusion.device == torch.device("cpu") and fusion.iteration > 0
    assert res["n_keyframes"] > 8


def test_cli_edge_shards(capsys, monkeypatch):
    """``--edge_shards 2``: the tracker splits its 64 + 64 edge slots into
    2 shards on the CPU and tracks the room."""
    built = []
    build = slam_demo.build_frontend
    monkeypatch.setattr(slam_demo, "build_frontend", lambda *a: built.append(
        build(*a)) or built[-1])
    res = _run(capsys, TINY + ["--fusion", "none", "--edge_shards", "2"])
    assert built[0].cfg.edge_shards == 2
    assert res["n_keyframes"] > 8 and np.isfinite(res["ate_rmse_m"])


def test_cli_edge_shards_must_divide():
    """``--edge_shards 5`` does not divide the 64 edge slots: the tracker
    raises, where JAX's asserts."""
    with pytest.raises(ValueError,
                       match="e_active/e_inactive must divide edge_shards=5"):
        slam_demo.run(slam_demo.parse_args(TINY + ["--edge_shards", "5"]))


def test_cli_profile_writes_a_trace(capsys, monkeypatch, tmp_path):
    """``--profile`` wraps the run in a torch.profiler trace, written as a
    Chrome trace to the temporary directory, and still prints the JAX
    CLI's keys."""
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    res = slam_demo.run(slam_demo.parse_args(TINY + ["--fusion", "none",
                                                     "--profile"]))
    out = capsys.readouterr().out
    assert "trace written to" in out
    assert set(json.loads(out.strip().splitlines()[-1])) == set(res)
    assert set(res) == BASE_KEYS and np.isfinite(res["ate_rmse_m"])
    trace_dir = tmp_path / "nerf_slam_tpu_torch_trace"
    files = list(trace_dir.iterdir())
    assert len(files) == 1
    assert "aten::" in files[0].read_text()


def test_cli_tum_rgbd_runs(capsys, monkeypatch, tmp_path):
    """``--dataset_name tum --rgbd`` on a TUM-layout fixture of the
    synthetic room (the loader's 384x512 target cut to 48x64 for the
    CPU): it tracks with the sensed depths and prints the JAX CLI's
    keys."""
    import functools

    from nerf_slam_tpu.datasets import SyntheticConfig, SyntheticDataset
    from nerf_slam_tpu_torch.datasets import tum_dataset
    from test_torch_datasets import write_tum
    synth = SyntheticDataset(SyntheticConfig(n_frames=10, height=48,
                                             width=64))
    d = write_tum(tmp_path / "rgbd_dataset_freiburg3_synth", synth, n=10)
    monkeypatch.setattr(tum_dataset, "TumDataset", functools.partial(
        tum_dataset.TumDataset, target_hw=(48, 64)))
    built = []
    build = slam_demo.build_frontend
    monkeypatch.setattr(slam_demo, "build_frontend", lambda *a: built.append(
        build(*a)) or built[-1])
    res = _run(capsys, TINY + ["--dataset_name", "tum", "--dataset_dir", d,
                               "--fusion", "none", "--rgbd"])
    assert set(res) == BASE_KEYS
    assert res["n_keyframes"] > 8 and np.isfinite(res["ate_rmse_m"])
    fe = built[0]
    assert fe.cfg.rgbd
    assert bool((fe.state.idepths_sensed[:fe.kf_idx] > 0).all())


def test_cli_euroc_stereo_runs(capsys, monkeypatch, tmp_path):
    """``--dataset_name euroc --stereo`` on the EuRoC-layout fixture: the
    loader rectifies the pair at --height x --width, the rig pose rides
    the packets, and stereo (i, i) edges enter the graph."""
    from test_torch_euroc import BASELINE, write_euroc
    root = write_euroc(tmp_path / "V9_synth", n=10)
    built = []
    build = slam_demo.build_frontend
    monkeypatch.setattr(slam_demo, "build_frontend", lambda *a: built.append(
        build(*a)) or built[-1])
    res = _run(capsys, TINY + ["--dataset_name", "euroc", "--dataset_dir",
                               root, "--fusion", "none", "--stereo"])
    assert set(res) == BASE_KEYS
    assert res["n_keyframes"] > 8 and np.isfinite(res["ate_rmse_m"])
    fe = built[0]
    assert fe.cfg.stereo
    assert abs(-fe.cfg.stereo_rel[0] - BASELINE) < 1e-4
    assert int((fe.graph.ii == fe.graph.jj).sum()) > 0


def test_cli_flags_and_defaults_match_the_jax_cli():
    from nerf_slam_tpu.cli import slam_demo as jcli
    j = vars(jcli.parse_args([]))
    t = vars(slam_demo.parse_args([]))
    assert t.pop("device") == "cuda"
    assert t == j


class _Fusion:
    """A stand-in map that records what the stage asks of it."""

    def __init__(self):
        self.calls, self.iteration = [], 0

    def fuse(self, pkt):
        self.calls.append("fuse")
        return bool(pkt.get("is_last_frame"))

    def fuse_and_fit(self, pkt, iters):
        self.calls.append("fuse_and_fit")
        self.iteration += iters
        return pkt is not None and bool(pkt.get("is_last_frame"))

    def fit_volume(self, iters):
        self.calls.append("fit_volume")
        self.iteration += iters


@pytest.mark.parametrize("mode", ["nerf", "sigma", "tsdf"])
def test_fusion_module_modes_end_as_the_jax_stage(mode):
    """The TSDF modes fuse each packet and stop at the last one; the NeRF
    mode trains on every spin and stops ``extra_spins_after_done`` spins
    after it; the JAX stage makes the same calls."""
    pkts = [{"slam": {"k": 0}}, None, {"slam": {"is_last_frame": True}},
            None, None, None]
    runs = []
    for mod in (tmod, jmod):
        f = _Fusion()
        m = mod.FusionModule(f, mode=mode, parallel_run=False,
                             extra_spins_after_done=3)
        spins = 0
        for p in pkts:
            if m.shutdown:
                break
            m.spin_once(p)
            spins += 1
        runs.append((f.calls, spins, f.iteration))
    assert runs[0] == runs[1]
    calls, spins, _ = runs[0]
    if mode == "nerf":
        assert calls == ["fuse_and_fit"] * 5 and spins == 5
    else:
        assert calls == ["fuse", "fuse"] and spins == 3


def test_fusion_module_commands(tmp_path, capsys):
    """mesh, sigma_thresh and rebuild on a TSDF map; eval, sigma_thresh
    and toggle_mask on a NeRF map, as the JAX stage applies them."""
    tsdf = tfusion.TsdfFusion(tfusion.TsdfFusionConfig(grid_size=16),
                              device="cpu")
    w2c = np.eye(4, dtype=np.float32)
    w2c[2, 3] = 1.0
    depth = np.full((12, 16), 1.5, np.float32)
    tsdf.integrate_frame(w2c, [10.0, 10.0, 8.0, 6.0], depth,
                         np.full((12, 16), 0.01, np.float32),
                         np.full((12, 16, 3), 128, np.uint8))
    m = tmod.FusionModule(tsdf, mode="sigma", parallel_run=False)
    path = tmp_path / "tsdf.obj"
    m.spin_once({"slam": None, "gui": {"gui_commands": [
        {"cmd": "mesh", "path": str(path)},
        {"cmd": "sigma_thresh", "value": 0.05},
        {"cmd": "rebuild"}]}})
    assert path.read_text().startswith("v ")
    assert tsdf.sigma_thresh == 0.05
    assert int((tsdf.volume.weight > 0).sum()) == 0   # 0.1 > 0.05: masked
    m.handle_command({"cmd": "rebuild", "value": 1.0})
    assert int((tsdf.volume.weight > 0).sum()) > 0

    nerf = tfusion.NerfFusion(tfusion.NerfFusionConfig(
        buffer=2, height=8, width=8, batch_rays=16), device="cpu")
    m = tmod.FusionModule(nerf, mode="nerf", parallel_run=False)
    seen = []
    for _ in range(5):
        m.handle_command({"cmd": "toggle_mask"})
        seen.append(nerf.cfg.mask_type)
    assert seen == ["raw", "ours_w_thresh", "no_depth", "ours", "raw"]
    m.handle_command({"cmd": "sigma_thresh", "value": 0.3})
    assert nerf.sigma_thresh == 0.3
    m.handle_command({"cmd": "eval"})                 # no data: no row
    assert "[fusion] eval: None" in capsys.readouterr().out
    with pytest.raises(ValueError):
        tmod.FusionModule(nerf, mode="mesh")
    assert torch.equal(nerf.train_set.valid, torch.zeros(2))
