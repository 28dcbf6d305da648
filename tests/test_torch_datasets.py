"""The port's NeRF, TUM and Replica loaders, ``export_nerf_format`` and
the dataset factory against the JAX package's on the same directories:
fixtures written as tests/test_datasets.py writes them (48x64, 4-6
frames), and the in-repo 30-frame scene
``convergence_results/object_scene_nerf``.

Tolerances: depths, poses, intrinsics, lengths, ``t_cams`` and
``is_last_frame`` equal to the bit; images equal where no resize happens
(PNG is lossless; Replica's JPEGs go through the same OpenCV decoder here)
and within 1 gray level where the loader resizes (``INTER_AREA``)."""
import json
import os

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from nerf_slam_tpu.datasets import SyntheticConfig, SyntheticDataset
from nerf_slam_tpu.datasets import data_module as jdm
from nerf_slam_tpu.datasets import nerf_dataset as jnerf
from nerf_slam_tpu.datasets.replica_dataset import ReplicaDataset as JReplica
from nerf_slam_tpu.datasets.tum_dataset import TumDataset as JTum
from nerf_slam_tpu_torch.datasets import data_module as tdm
from nerf_slam_tpu_torch.datasets import nerf_dataset as tnerf
from nerf_slam_tpu_torch.datasets import replica_dataset as treplica
from nerf_slam_tpu_torch.datasets.tum_dataset import TumDataset as TTum

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SCENE = os.path.join(ROOT, "convergence_results", "object_scene_nerf")


@pytest.fixture(scope="module")
def synth():
    return SyntheticDataset(SyntheticConfig(n_frames=4, height=48, width=64))


def _compare(t, j, image_tol=0):
    """Every packet of port dataset ``t`` against JAX dataset ``j``."""
    assert len(t) == len(j)
    for k in range(len(j)):
        a, b = t[k], j[k]
        assert set(a) == set(b)
        assert a["k"] == b["k"] and a["t_cams"] == b["t_cams"]
        assert a["is_last_frame"] == b["is_last_frame"]
        for key in ("poses", "intrinsics", "depths"):
            if b[key] is None:
                assert a[key] is None
            else:
                assert a[key].dtype == b[key].dtype, key
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        assert a["images"].shape == b["images"].shape
        assert a["images"].dtype == np.uint8
        diff = np.abs(a["images"].astype(int) - b["images"].astype(int))
        assert diff.max() <= image_tol


@pytest.mark.parametrize("kw", [{}, dict(initial_k=3, final_k=20,
                                         img_stride=4)])
def test_nerf_scene_reads_as_the_jax_loader(kw):
    """The in-repo 336x640 scene: 8-bit RGB and 16-bit depth PNGs written
    by OpenCV, the slice before the digit sort."""
    t, j = tnerf.NeRFDataset(SCENE, **kw), jnerf.NeRFDataset(SCENE, **kw)
    assert t.out_hw == j.out_hw == (336, 640)
    _compare(t, j)


def test_nerf_format_with_resize(tmp_path, synth):
    """A 50x70 scene: the loader plans 48x64, area-resizes the images and
    nearest-resizes the depths, and rescales the intrinsics."""
    out = tmp_path / "scene"
    jnerf.export_nerf_format(synth, str(out))
    meta = json.loads((out / "transforms.json").read_text())
    for fr in meta["frames"]:
        for key in ("file_path", "depth_path"):
            p = str(out / fr[key])
            img = cv2.imread(p, cv2.IMREAD_UNCHANGED)
            cv2.imwrite(p, cv2.resize(img, (70, 50),
                                      interpolation=cv2.INTER_NEAREST))
    meta["w"], meta["h"] = 70, 50
    (out / "transforms.json").write_text(json.dumps(meta))
    t, j = tnerf.NeRFDataset(str(out)), jnerf.NeRFDataset(str(out))
    assert t.out_hw == j.out_hw == (48, 64)
    _compare(t, j, image_tol=1)


def test_export_nerf_format_round_trips(tmp_path, synth):
    """The port's exporter (its own PNG encoder) writes what both
    packages read back: images exact, depths quantized at 1 mm."""
    out = tnerf.export_nerf_format(synth, str(tmp_path / "scene"))
    t, j = tnerf.NeRFDataset(out), jnerf.NeRFDataset(out)
    _compare(t, j)
    for k in range(4):
        p, s = t[k], synth[k]
        np.testing.assert_array_equal(p["images"], s["images"])
        np.testing.assert_allclose(p["poses"], s["poses"], atol=1e-5)
        np.testing.assert_allclose(p["depths"], s["depths"], atol=2e-3)
    assert t[3]["is_last_frame"]
    # the JAX exporter writes the same files' content
    jout = jnerf.export_nerf_format(synth, str(tmp_path / "jscene"))
    _compare(tnerf.NeRFDataset(jout), t)


def write_tum(d, synth, n=4):
    """tests/test_datasets.py's TUM layout; quaternions from the port's
    se3 (xyzw)."""
    import torch

    from nerf_slam_tpu_torch.geometry import se3
    (d / "rgb").mkdir(parents=True)
    (d / "depth").mkdir()
    rgb_lines, depth_lines, gt_lines = ["# rgb"], ["# depth"], ["# gt"]
    for k in range(n):
        pkt = synth[k]
        t = 1000.0 + k * 0.1
        cv2.imwrite(str(d / "rgb" / f"{t:.6f}.png"),
                    cv2.cvtColor(pkt["images"], cv2.COLOR_RGB2BGR))
        cv2.imwrite(str(d / "depth" / f"{t:.6f}.png"),
                    (pkt["depths"] * 5000).astype(np.uint16))
        # the depth camera a few ms late, as TUM's are
        rgb_lines.append(f"{t:.6f} rgb/{t:.6f}.png")
        depth_lines.append(f"{t + 0.004:.6f} depth/{t:.6f}.png")
        pose7 = se3.from_matrix(torch.as_tensor(pkt["poses"])).numpy()
        gt_lines.append(f"{t:.6f} " + " ".join(f"{v:.8f}" for v in pose7))
    (d / "rgb.txt").write_text("\n".join(rgb_lines))
    (d / "depth.txt").write_text("\n".join(depth_lines))
    (d / "groundtruth.txt").write_text("\n".join(gt_lines))
    return str(d)


@pytest.mark.parametrize("target_hw", [(48, 64), (40, 56)])
def test_tum_matches_the_jax_loader(tmp_path, synth, target_hw):
    d = write_tum(tmp_path / "rgbd_dataset_freiburg1_test", synth)
    t, j = TTum(d, target_hw=target_hw), JTum(d, target_hw=target_hw)
    assert t.out_hw == j.out_hw
    _compare(t, j, image_tol=0 if target_hw == (48, 64) else 1)
    # freiburg1's intrinsics, picked from the path
    assert t.calib.camera_model.fx == j.calib.camera_model.fx
    np.testing.assert_allclose(t[2]["poses"][:3, 3],
                               synth[2]["poses"][:3, 3], atol=1e-5)


def write_replica(d, synth, n=4):
    """tests/test_datasets.py's Replica layout (cam_params.json one level
    up, as Replica's own export puts it)."""
    (d / "results").mkdir(parents=True)
    traj = []
    for k in range(n):
        pkt = synth[k]
        cv2.imwrite(str(d / "results" / f"frame{k:06d}.jpg"),
                    cv2.cvtColor(pkt["images"], cv2.COLOR_RGB2BGR))
        d16 = (pkt["depths"] / 6553.5 * 65535 / 10).astype(np.uint16)
        cv2.imwrite(str(d / "results" / f"depth{k:06d}.png"), d16)
        gl = pkt["poses"].copy()
        gl[:3, 1] *= -1
        gl[:3, 2] *= -1
        traj.append(gl.reshape(-1))
    np.savetxt(str(d / "traj.txt"), np.stack(traj))
    with open(d.parent / "cam_params.json", "w") as f:
        json.dump({"camera": {
            "fx": float(synth.K[0]), "fy": float(synth.K[1]),
            "cx": float(synth.K[2]), "cy": float(synth.K[3]),
            "w": 64, "h": 48, "scale": 6553.5}}, f)
    return str(d)


def test_replica_matches_the_jax_loader(tmp_path, synth):
    d = write_replica(tmp_path / "room0", synth)
    kw = dict(initial_k=1, final_k=4)
    _compare(treplica.ReplicaDataset(d, **kw), JReplica(d, **kw))


def test_replica_without_a_jpeg_decoder_raises(tmp_path, synth,
                                               monkeypatch):
    d = write_replica(tmp_path / "room0", synth, n=1)
    monkeypatch.setattr(treplica.image_io, "jpeg_decoder_available",
                        lambda: False)
    with pytest.raises(ImportError, match="cv2.*PIL"):
        treplica.ReplicaDataset(d)


@pytest.mark.parametrize("name", ["synthetic", "nerf", "replica", "tum",
                                  "euroc", "realsense"])
def test_factory_dispatch_matches_jax(tmp_path, synth, name):
    """A None dataset_dir is the synthetic room whatever the name; a
    directory goes to the loader of that name with the JAX factory's
    keyword filtering; an unknown name raises ValueError."""
    kw = dict(n_frames=3, height=48, width=64, initial_k=0, final_k=-1,
              buffer=8, stereo=False)
    t, j = tdm.build_dataset(name, None, **kw), jdm.build_dataset(
        name, None, **kw)
    assert type(t).__name__ == type(j).__name__ == "SyntheticDataset"
    assert len(t) == len(j) == 3
    dirs = {"nerf": lambda: tnerf.export_nerf_format(
        synth, str(tmp_path / "n")),
        "replica": lambda: write_replica(tmp_path / "r" / "room0", synth),
        "tum": lambda: write_tum(tmp_path / "fr3", synth)}
    if name in dirs:
        d = dirs[name]()
        t, j = tdm.build_dataset(name, d, **kw), jdm.build_dataset(
            name, d, **kw)
        assert type(t).__name__ == type(j).__name__
        assert (t.buffer, t.initial_k, len(t)) == (j.buffer, j.initial_k,
                                                   len(j))
    if name == "realsense":
        with pytest.raises(ImportError, match="pyrealsense2"):
            jdm.build_dataset(name, "cam")
        with pytest.raises(ImportError, match="pyrealsense2"):
            tdm.build_dataset(name, "cam")
    with pytest.raises(ValueError):
        tdm.build_dataset("bogus", str(tmp_path))
