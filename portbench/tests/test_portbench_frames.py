"""The benchmark's frozen frame generator against the port's synthetic
room, at a small size; the monocular cells' frames as they were before
the generator learned depths and right views; the configuration's rig
checked where it is loaded."""
import hashlib
import json

import numpy as np
import pytest

from portbench import frames, harness
from nerf_slam_tpu_torch.datasets.synthetic import (SyntheticConfig,
                                                    SyntheticDataset)


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5])
def test_frames_equal_the_synthetic_room(seed):
    n, h, w = 5, 48, 64
    images, poses, K, _, _ = frames.render(n, h, w, 70.0, 12.0, seed, "cpu")
    ds = SyntheticDataset(SyntheticConfig(n_frames=n, height=h, width=w,
                                          deg_per_frame=12.0,
                                          start_deg=frames.start_deg(seed)))
    ref = np.stack([ds[k]["images"] for k in range(n)])
    assert images.dtype == np.uint8 and images.shape == (n, h, w, 3)
    np.testing.assert_array_equal(images, ref)
    np.testing.assert_allclose(poses, np.stack([ds[k]["poses"]
                                                for k in range(n)]),
                               atol=1e-6)
    np.testing.assert_allclose(K, ds.K)


def test_seed_moves_the_start_not_the_motion():
    a, pa = frames.render(3, 32, 48, 70.0, 0.5, 11, "cpu")[:2]
    b, pb = frames.render(3, 32, 48, 70.0, 0.5, 12, "cpu")[:2]
    assert (a != b).any() and not np.allclose(pa, pb)
    for p in (pa, pb):
        ang = np.degrees(np.arctan2(p[:, 1, 3], p[:, 0, 3]))
        np.testing.assert_allclose(np.diff(ang), 0.5, atol=1e-3)


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 9])
def test_depths_and_right_views_equal_the_synthetic_room(seed):
    """The RGB-D sensor's z-depths and the stereo rig's right views: the
    synthetic dataset's ``depths`` and ``images_right``, frame by frame;
    asking for them leaves the left images as they were."""
    n, h, w, b = 5, 48, 64, 0.11
    got = frames.render(n, h, w, 70.0, 12.0, seed, "cpu", chunk=2,
                        depths=True, baseline=b)
    ds = SyntheticDataset(SyntheticConfig(n_frames=n, height=h, width=w,
                                          deg_per_frame=12.0, stereo=True,
                                          baseline=b,
                                          start_deg=frames.start_deg(seed)))
    ref = [ds[k] for k in range(n)]
    mono = frames.render(n, h, w, 70.0, 12.0, seed, "cpu")
    assert mono.depths is None and mono.images_right is None
    np.testing.assert_array_equal(got.images, mono.images)
    assert got.depths.dtype == np.float32 and got.depths.shape == (n, h, w)
    np.testing.assert_array_equal(got.depths,
                                  np.stack([r["depths"] for r in ref]))
    np.testing.assert_array_equal(got.images_right,
                                  np.stack([r["images_right"] for r in ref]))
    np.testing.assert_allclose(harness.rig_pose(b), ref[0]["stereo_rel"])


# sha256 of the images of one seed a cell, computed on the CPU from the
# generator as it was before it rendered depths and right views
MONO_DIGESTS = [
    ("ngp_mono_344x616.orbit", 101,
     "6a1484a56f7a0a4f7e3b0fc7885bbbfc7efc4cef020f4331e3e8438a06bfd73e"),
    ("sigma_mono_384x512.orbit", 102,
     "864847fb5aab76781136b875fbe95e69a28fe84750a7394d03643d8a08b0ef8f"),
    ("ngp_mono_344x616.handheld", 103,
     "9beaef992ffba99344570382bea0789fb0ce4f54cb0f963f1ee6540c0d33fd00"),
    ("sigma_mono_384x512.handheld", 2 ** 31 + 104,
     "9320a72e33527dcfa3f18c53551857632d437eacba06d40ed93b404890023bdb"),
]


@pytest.mark.parametrize("workload,seed,digest", MONO_DIGESTS)
def test_monocular_cells_render_the_same_images(workload, seed, digest):
    _, _, config, traffic = harness.load_cell(workload)
    got = frames.render(traffic["session_frames"], config["height"],
                        config["width"], config["fov_deg"],
                        traffic["deg_per_frame"], seed, "cpu")
    assert hashlib.sha256(got.images.tobytes()).hexdigest() == digest


def _bench_with(tmp_path, config):
    """A BENCHMARK.json under ``tmp_path`` naming one cell of ``config``
    under the orbit traffic."""
    (tmp_path / "portbench" / "configs").mkdir(parents=True)
    (tmp_path / "portbench" / "traffic").mkdir()
    (tmp_path / "portbench" / "configs" / "c.json").write_text(
        json.dumps(config))
    (tmp_path / "portbench" / "traffic" / "orbit.json").write_text(
        (harness.ROOT / "traffic" / "orbit.json").read_text())
    (tmp_path / "BENCHMARK.json").write_text(json.dumps({
        "configs": [{"name": "c", "file": "portbench/configs/c.json"}],
        "workloads": [{"name": "c.orbit", "config": "c",
                       "traffic": "orbit", "chips": 1}]}))


def _sigma():
    return harness.load_json(harness.ROOT / "configs"
                             / "sigma_mono_384x512.json")


@pytest.mark.parametrize("change,named", [
    ({"tracker": {"edge_shards": 2}}, "tracker.edge_shards"),
    ({"tracker": {"stereo": True}}, "tracker.stereo"),
    ({"tracker": {"sensor": "stereo"}}, "tracker.stereo_baseline_m"),
    ({"tracker": {"stereo_baseline_m": 0.11}}, "tracker.stereo_baseline_m"),
    ({"tracker": {"sensor": "stereo", "stereo_baseline_m": 0}},
     "tracker.stereo_baseline_m"),
    ({"tracker": {"sensor": "lidar"}}, "tracker.sensor"),
    ({"multi_gpu": True}, "multi_gpu"),
])
def test_a_rig_the_harness_would_not_run_as_stated_raises(tmp_path, change,
                                                         named):
    config = _sigma()
    for key, val in change.items():
        config[key] = dict(config[key], **val) if key == "tracker" else val
    _bench_with(tmp_path, config)
    with pytest.raises(ValueError, match=named):
        harness.load_cell("c.orbit", tmp_path)


@pytest.mark.parametrize("change,sensor", [
    ({}, "mono"), ({"multi_gpu": False}, "mono"),
    ({"tracker": {"sensor": "rgbd"}}, "rgbd"),
    ({"tracker": {"sensor": "stereo", "stereo_baseline_m": 0.11}},
     "stereo"),
])
def test_a_stated_rig_loads(tmp_path, change, sensor):
    config = _sigma()
    for key, val in change.items():
        config[key] = dict(config[key], **val) if key == "tracker" else val
    _bench_with(tmp_path, config)
    _, _, loaded, _ = harness.load_cell("c.orbit", tmp_path)
    assert harness.rig(loaded)[0] == sensor
