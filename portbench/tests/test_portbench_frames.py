"""The benchmark's frozen frame generator against the port's synthetic
room, at a small size."""
import numpy as np
import pytest

from portbench import frames
from nerf_slam_tpu_torch.datasets.synthetic import (SyntheticConfig,
                                                    SyntheticDataset)


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 5])
def test_frames_equal_the_synthetic_room(seed):
    n, h, w = 5, 48, 64
    images, poses, K = frames.render(n, h, w, 70.0, 12.0, seed, "cpu")
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
    a, pa, _ = frames.render(3, 32, 48, 70.0, 0.5, 11, "cpu")
    b, pb, _ = frames.render(3, 32, 48, 70.0, 0.5, 12, "cpu")
    assert (a != b).any() and not np.allclose(pa, pb)
    for p in (pa, pb):
        ang = np.degrees(np.arctan2(p[:, 1, 3], p[:, 0, 3]))
        np.testing.assert_allclose(np.diff(ang), 0.5, atol=1e-3)
