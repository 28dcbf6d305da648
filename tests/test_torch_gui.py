"""The port's ``gui/`` against the JAX package's: the point-cloud
back-projection, the headless GUI's exports, and the live viewer's HTTP
protocol (tests/test_viewer.py's, run against the port), on the CPU.

The JAX GUI writes its PNGs and JPEGs through OpenCV; the port writes
PNGs with its own encoder and JPEGs through OpenCV where it imports (as
here), so its JPEG bytes equal JAX's and its PNGs decode to JAX's pixels.
"""
import json
import os
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from nerf_slam_tpu.gui import HeadlessGui as JaxGui
from nerf_slam_tpu.gui import LiveViewer as JaxViewer
from nerf_slam_tpu.gui import backproject_packet as jax_backproject
from nerf_slam_tpu_torch.datasets.image_io import read_png
from nerf_slam_tpu_torch.gui import (HeadlessGui, LiveViewer,
                                     backproject_packet, viewer)


def _packet(n=2, H=32, W=40, seed=0, last=True):
    """tests/test_viz.py's packet (fronto-parallel cameras at depth 2)."""
    rng = np.random.RandomState(seed)
    return {
        "viz_idx": np.arange(n),
        "viz_count": n,
        "cam0_poses": np.tile(np.array([0, 0, 0, 0, 0, 0, 1.0],
                                       np.float32), (n, 1)),
        "world_T_body_cov": np.tile(0.01 * np.eye(6, dtype=np.float32),
                                    (n, 1, 1)),
        "cam0_images": rng.randint(0, 255, (n, H, W, 3)).astype(np.uint8),
        "cam0_idepths_up": np.full((n, H, W), 0.5, np.float32),
        "cam0_depths_cov_up": np.full((n, H, W), 0.01, np.float32),
        "cam0_intrinsics": np.tile(
            np.array([4.0, 4.0, 2.5, 2.0], np.float32), (n, 1)),
        "is_last_frame": last,
    }


def _random_packet(n=3, H=24, W=32, seed=1):
    """Posed cameras, varied inverse depths (some below 1e-3) and depth
    variances spanning the sigma threshold; 16 rows, as the tracker pads."""
    from nerf_slam_tpu_torch.geometry import se3
    rng = np.random.RandomState(seed)
    xi = np.concatenate([rng.randn(16, 3) * 0.3, rng.randn(16, 3) * 0.2], -1)
    pkt = _packet(16, H, W, seed)
    pkt.update(viz_idx=np.arange(n) + 4, viz_count=n,
               cam0_poses=se3.exp(torch.from_numpy(xi.astype(np.float32)))
               .numpy(),
               cam0_idepths_up=rng.uniform(-0.1, 2.0, (16, H, W))
               .astype(np.float32),
               cam0_depths_cov_up=(10.0 ** rng.uniform(-3, 3, (16, H, W)))
               .astype(np.float32),
               cam0_intrinsics=np.tile(np.array([3.0, 3.2, 2.1, 1.4],
                                                np.float32), (16, 1)))
    cov = rng.randn(16, 6, 6).astype(np.float32)
    pkt["world_T_body_cov"] = cov @ cov.transpose(0, 2, 1) * 1e-3
    return pkt


def _tensors(pkt):
    """The packet as the port's tracker emits it: tensor fields."""
    return {k: torch.from_numpy(v) if isinstance(v, np.ndarray)
            and k != "viz_idx" else v for k, v in pkt.items()}


@pytest.mark.parametrize("make", [_packet, _random_packet])
@pytest.mark.parametrize("thresh", [10.0, 1.0])
def test_backproject_matches_jax(make, thresh):
    pkt = make()
    pj, cj = jax_backproject(pkt, sigma_thresh=thresh)
    for p in (pkt, _tensors(pkt)):
        pt, ct = backproject_packet(p, sigma_thresh=thresh)
        assert pt.shape == pj.shape and pt.shape[0] > 0
        np.testing.assert_allclose(pt, pj, atol=1e-4)
        np.testing.assert_array_equal(ct, cj)
    if make is _packet:
        np.testing.assert_allclose(pt[:, 2], 2.0, atol=1e-4)
    pkt["cam0_depths_cov_up"] = np.full_like(pkt["cam0_depths_cov_up"],
                                             1e6)
    assert backproject_packet(pkt, sigma_thresh=thresh)[0].shape[0] == 0


@pytest.mark.parametrize("make", [_packet, _random_packet])
def test_headless_gui_exports_match_jax(tmp_path, make):
    """Two packets through HeadlessGui(export_every=1) on both sides: the
    same files, trajectories within 1e-5, the same PLY vertex counts, PNGs
    of the same pixels, and the end commands after the last packet."""
    dirs = {}
    for name, cls in (("jax", JaxGui), ("port", HeadlessGui)):
        gui = cls(out_dir=str(tmp_path / name), export_every=1)
        gui.visualize(dict(make(), is_last_frame=False))
        gui.visualize(make())
        assert [c["cmd"] for c in gui.pop_commands()] == ["mesh", "eval"]
        dirs[name] = tmp_path / name
    files = sorted(os.listdir(dirs["jax"]))
    assert sorted(os.listdir(dirs["port"])) == files
    assert {f.split("_")[0] for f in files} == {"cloud", "depth", "sigma",
                                                "trajectory.json"}
    tj, tt = (json.loads((dirs[k] / "trajectory.json").read_text())
              for k in ("jax", "port"))
    assert len(tt) == len(tj) == 2 * (make().get("viz_count"))
    for a, b in zip(tt, tj):
        assert a["kf"] == b["kf"]
        for key in ("c2w", "cov_radii", "cov_axes"):
            np.testing.assert_allclose(a[key], b[key], atol=1e-5)
    for f in files:
        if f.endswith(".ply"):
            heads = [(dirs[k] / f).read_text().split("end_header")[0]
                     for k in ("jax", "port")]
            assert heads[0] == heads[1] and "element vertex" in heads[0]
        elif f.endswith(".png"):
            np.testing.assert_array_equal(read_png(str(dirs["port"] / f)),
                                          read_png(str(dirs["jax"] / f)))


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        return r.status, r.read()


def _viewer_packet(n=2, H=16, W=24, last=False):
    """tests/test_viewer.py's packet."""
    pkt = _packet(n, H, W, seed=0, last=last)
    pkt["cam0_intrinsics"] = np.tile(np.array([2.0, 2.0, W / 16, H / 16],
                                              np.float32), (n, 1))
    pkt["world_T_body_cov"] = np.tile(np.eye(6, dtype=np.float32) * 1e-4,
                                      (n, 1, 1))
    return pkt


def test_viewer_serves_stream_and_commands(tmp_path):
    """tests/test_viewer.py's protocol against the port's LiveViewer:
    nothing before the first packet, JPEGs and state after it, commands
    over /cmd merged into pop_commands, the cloud after the last packet;
    the JPEGs equal JAX's byte for byte (both through OpenCV)."""
    ours = LiveViewer(HeadlessGui(out_dir=str(tmp_path / "port")), port=0)
    theirs = JaxViewer(JaxGui(out_dir=str(tmp_path / "jax")), port=0)
    try:
        status, body = _get(ours.port, "/")
        assert status == 200 and b"live viewer" in body
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(ours.port, "/kf.jpg")
        assert e.value.code == 404
        for v in (ours, theirs):
            v.visualize(_tensors(_viewer_packet()) if v is ours
                        else _viewer_packet())
        for name in ("kf", "depth", "sigma"):
            status, body = _get(ours.port, f"/{name}.jpg")
            assert status == 200 and body[:2] == b"\xff\xd8"
            assert body == _get(theirs.port, f"/{name}.jpg")[1]
        state = json.loads(_get(ours.port, "/state.json")[1])
        assert state["stats"]["n_keyframes"] == 2
        assert len(state["trajectory"]) == 2

        _get(ours.port, "/cmd?name=mesh")
        _get(ours.port, "/cmd?name=sigma_thresh&value=3.5")
        names = [c["cmd"] for c in ours.pop_commands()]
        assert "mesh" in names and "sigma_thresh" in names
        assert ours.gui.sigma_thresh == 3.5
        assert ours.pop_commands() == []

        for v in (ours, theirs):
            v.gui.sigma_thresh = 3.5
            v.visualize(_viewer_packet(last=True))
        status, body = _get(ours.port, "/cloud.ply")
        assert status == 200 and body.startswith(b"ply")
        assert body == _get(theirs.port, "/cloud.ply")[1]
        status, body = _get(ours.port, "/cloud.json")
        cj = json.loads(body)
        assert status == 200 and len(cj["pts"]) == len(cj["cols"]) > 0
        assert cj == json.loads(_get(theirs.port, "/cloud.json")[1])
        tr = json.loads(_get(ours.port, "/state.json")[1])["trajectory"]
        assert "cov_radii" in tr[0] and "cov_axes" in tr[0]
        page = _get(ours.port, "/")[1]
        assert b'id="scene"' in page and b"cov_radii" in page
        assert [c["cmd"] for c in ours.pop_commands()] == ["mesh", "eval"]
    finally:
        ours.close()
        theirs.close()


def test_viewer_encodes_with_pillow_or_refuses(monkeypatch, tmp_path):
    """Without OpenCV the JPEGs come from Pillow (where it imports);
    without either the constructor raises, naming both."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    try:
        import PIL  # noqa: F401
        have_pil = True
    except ImportError:
        have_pil = False
    if have_pil:
        jpg = viewer.jpeg_encoder(85)(np.zeros((8, 8, 3), np.uint8))
        assert jpg[:2] == b"\xff\xd8"
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError, match=r"cv2.*PIL"):
        LiveViewer(HeadlessGui(out_dir=str(tmp_path)), port=0)
