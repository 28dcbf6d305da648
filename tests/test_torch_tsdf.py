"""The port's Sigma-TSDF fusion and mesher against the JAX package's
(``fusion/tsdf_fusion.py``, ``fusion/mesher.py``): integration of three
frames of the synthetic room into a 32^3 grid under both mask types, the
sigma mask, the history rebuild, the ray cast and the mesh, on the same
numpy inputs."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nerf_slam_tpu.datasets import SyntheticConfig, SyntheticDataset
from nerf_slam_tpu.fusion import mesher as jmesh
from nerf_slam_tpu.fusion import tsdf_fusion as jtsdf
from nerf_slam_tpu_torch.fusion import mesher as tmesh
from nerf_slam_tpu_torch.fusion import tsdf_fusion as ttsdf

H, W, G = 24, 32, 32
# voxels whose projection lands within float rounding of a .5 pixel
# boundary may round to the neighbouring pixel in one framework: at most
# this share of the grid may differ beyond 1e-5
ROUNDING_SHARE = 1e-3


@pytest.fixture(scope="module")
def frames():
    """Three frames of the synthetic room (GT depth, images) with a depth
    variance whose sigma straddles the thresholds used below."""
    ds = SyntheticDataset(SyntheticConfig(n_frames=12, height=H, width=W,
                                          seed=21, n_objects=4))
    rng = np.random.RandomState(0)
    out = []
    for k in (0, 4, 8):
        p = ds[k]
        cov = rng.uniform(0.0, 40.0, (H, W)).astype(np.float32)
        out.append((np.linalg.inv(p["poses"]).astype(np.float32),
                    np.asarray(p["intrinsics"], np.float32),
                    np.asarray(p["depths"], np.float32), cov,
                    np.asarray(p["images"]), p["poses"]))
    return out


def _cfg(mod, mask="weighted"):
    return mod.TsdfFusionConfig(grid_size=G, depth_mask_type=mask)


def _fused(frames, mask):
    jf = jtsdf.TsdfFusion(_cfg(jtsdf, mask))
    tf = ttsdf.TsdfFusion(_cfg(ttsdf, mask), device="cpu")
    for w2c, intr, depth, cov, img, _ in frames:
        jf.integrate_frame(w2c, intr, depth, cov, img)
        tf.integrate_frame(w2c, intr, depth, cov, img)
    return jf, tf


def _volume_np(vol):
    return [np.asarray(v) if not isinstance(v, torch.Tensor) else v.numpy()
            for v in vol]


@pytest.mark.parametrize("mask", ["weighted", "uniform"])
def test_integrate_matches(frames, mask):
    """tsdf, weight and color to 1e-5 after three frames, but for the few
    voxels a .5 pixel rounding moves (counted, at most 0.1% of the grid)."""
    jf, tf = _fused(frames, mask)
    tj, wj, cj = _volume_np(jf.volume)
    tt, wt, ct = _volume_np(tf.volume)
    assert ct.shape == cj.shape == (3, G, G, G)
    assert (wt > 0).sum() > 0.05 * G ** 3         # the frames were fused
    bad = (np.abs(tt - tj) > 1e-5) | (np.abs(wt - wj) > 1e-5 * np.maximum(
        1.0, np.abs(wj))) | (np.abs(ct - cj) > 1e-5).any(axis=0)
    assert bad.sum() <= ROUNDING_SHARE * G ** 3, int(bad.sum())


def test_mask_weight_matches_under_a_new_threshold(frames):
    jf, tf = _fused(frames[:1], "weighted")
    _, _, depth, cov, _, _ = frames[0]
    for thr in (5.0, 2.0):
        jf.set_sigma_thresh(thr)
        tf.set_sigma_thresh(thr)
        want = np.asarray(jf._mask_weight(jnp.asarray(depth),
                                          jnp.asarray(cov)))
        got = tf._mask_weight(torch.from_numpy(depth),
                              torch.from_numpy(cov)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6)
        assert (got == 0).any() and (got > 0).any()
    uni = ttsdf.TsdfFusion(_cfg(ttsdf, "uniform"), device="cpu")
    assert (uni._mask_weight(torch.from_numpy(depth),
                             torch.from_numpy(cov)) == 1).all()


def test_rebuild_equals_a_fresh_integration(frames):
    """Replaying the history at threshold 2 gives the volume that
    integrating the frames at threshold 2 gives, bit for bit."""
    _, tf = _fused(frames, "weighted")
    before = tf.volume.weight.clone()
    tf.rebuild(2.0)
    assert not torch.equal(before, tf.volume.weight)
    fresh = ttsdf.TsdfFusion(_cfg(ttsdf), device="cpu")
    fresh.set_sigma_thresh(2.0)
    for w2c, intr, depth, cov, img, _ in frames:
        fresh.integrate_frame(w2c, intr, depth, cov, img)
    for a, b in zip(tf.volume, fresh.volume):
        assert torch.equal(a, b)
    assert len(tf.history) == 3


def test_history_ring_is_bounded(frames):
    tf = ttsdf.TsdfFusion(ttsdf.TsdfFusionConfig(grid_size=8,
                                                 history_size=2),
                          device="cpu")
    for w2c, intr, depth, cov, img, _ in frames:
        tf.integrate_frame(w2c, intr, depth, cov, img)
    tf.integrate_frame(*frames[0][:5], record=False)
    assert len(tf.history) == 2
    assert torch.equal(tf.history[-1][2], torch.from_numpy(frames[2][2]))


def test_raycast_matches(frames):
    """Both ray casts on the same (JAX-fused) volume: depth within 1e-4 m
    and rgb within 1e-5, but for pixels whose nearest voxel flips at a
    rounding boundary (at most 1% of the pixels)."""
    jf, _ = _fused(frames, "weighted")
    tf = ttsdf.TsdfFusion(_cfg(ttsdf), device="cpu")
    tf.volume = ttsdf.TsdfVolume(*[torch.from_numpy(np.array(v))
                                   for v in jf.volume])
    for _, intr, _, _, _, c2w in frames[:2]:
        rgb_j, d_j = jf.render(c2w, intr, (H, W))
        rgb_t, d_t = tf.render(c2w, intr, (H, W))
        assert rgb_t.shape == (H, W, 3) and d_t.shape == (H, W)
        assert (d_j > 0).mean() > 0.5
        bad = (np.abs(d_t - d_j) > 1e-4) | \
            (np.abs(rgb_t - rgb_j) > 1e-5).any(-1)
        assert bad.mean() <= 0.01, int(bad.sum())
    gt_img = [f[4] for f in frames]
    gt_d = [f[2] for f in frames]
    c2ws = [f[5] for f in frames]
    intrs = [f[1] for f in frames]
    ej = jf.evaluate(gt_img, gt_d, c2ws, intrs, max_views=2)
    et = tf.evaluate(gt_img, gt_d, c2ws, intrs, max_views=2)
    np.testing.assert_allclose([et["psnr"], et["depth_l1_cm"]],
                               [ej["psnr"], ej["depth_l1_cm"]], rtol=1e-2)


def test_extract_mesh_matches(frames):
    """The same volume gives the same vertex and face counts (and
    vertices, colors) through both."""
    jf, _ = _fused(frames, "uniform")
    tf = ttsdf.TsdfFusion(_cfg(ttsdf, "uniform"), device="cpu")
    tf.volume = ttsdf.TsdfVolume(*[torch.from_numpy(np.array(v))
                                   for v in jf.volume])
    vj, fj, cj = jf.extract_mesh(weight_thresh=0.5)
    vt, ft, ct = tf.extract_mesh(weight_thresh=0.5)
    assert vt.shape == vj.shape and ft.shape == fj.shape
    assert vt.shape[0] > 100
    np.testing.assert_allclose(vt, vj, atol=1e-9)
    np.testing.assert_array_equal(ft, fj)
    np.testing.assert_allclose(ct, cj, atol=1e-7)
    pj, colj = jf.extract_surface_points(max_points=50)
    pt, colt = tf.extract_surface_points(max_points=50)
    np.testing.assert_allclose(pt, pj, atol=1e-9)
    np.testing.assert_allclose(colt, colj, atol=1e-7)


def test_marching_tetrahedra_matches(tmp_path):
    """The port's copy gives the JAX package's mesh, exactly, on a random
    field with a validity mask; write_obj writes the same file."""
    rng = np.random.RandomState(1)
    sdf = rng.randn(9, 10, 11)
    mask = rng.rand(9, 10, 11) > 0.1
    vj, fj = jmesh.marching_tetrahedra(sdf, mask, origin=(1, 2, 3),
                                       voxel_size=0.5, level=0.2)
    vt, ft = tmesh.marching_tetrahedra(sdf, mask, origin=(1, 2, 3),
                                       voxel_size=0.5, level=0.2)
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(ft, fj)
    jmesh.write_obj(str(tmp_path / "j.obj"), vj[:30], fj[:10], vj[:30])
    tmesh.write_obj(str(tmp_path / "t.obj"), vt[:30], ft[:10], vt[:30])
    assert (tmp_path / "j.obj").read_text() == (tmp_path / "t.obj").read_text()
    v0, f0 = tmesh.marching_tetrahedra(np.ones((4, 4, 4)))
    assert v0.shape == (0, 3) and f0.shape == (0, 3)


def test_fuse_consumes_a_packet(frames):
    """A SLAM viz packet (cam_T_world 7-vectors, inverse depths at the
    packet's resolution, intrinsics at 1/8) integrates like the frames
    one by one; the end-of-sequence marker alone returns True."""
    from nerf_slam_tpu_torch.geometry import se3
    w2cs = torch.from_numpy(np.stack([f[0] for f in frames]))
    poses7 = se3.from_matrix(w2cs.double()).float()
    depth = np.stack([f[2] for f in frames])
    pkt = {"viz_idx": np.arange(3), "viz_count": 3,
           "cam0_poses": poses7.numpy(),
           "cam0_idepths_up": np.where(depth > 0, 1.0 / np.maximum(
               depth, 1e-6), 0.0).astype(np.float32),
           "cam0_depths_cov_up": np.stack([f[3] for f in frames]),
           "cam0_images": np.stack([f[4] for f in frames]),
           "cam0_intrinsics": np.stack([f[1] for f in frames]) / 8.0,
           "is_last_frame": True}
    tf = ttsdf.TsdfFusion(_cfg(ttsdf), device="cpu")
    assert tf.fuse(pkt) is True
    assert len(tf.history) == 3
    jf = jtsdf.TsdfFusion(_cfg(jtsdf))
    assert jf.fuse(pkt) is True
    tt, wt, _ = _volume_np(tf.volume)
    tj, wj, _ = _volume_np(jf.volume)
    bad = (np.abs(tt - tj) > 1e-4) | (np.abs(wt - wj) > 1e-4 * wj.max())
    assert bad.sum() <= 5 * ROUNDING_SHARE * G ** 3, int(bad.sum())
    assert ttsdf.TsdfFusion(_cfg(ttsdf), device="cpu").fuse(
        {"is_last_frame": True}) is True
    assert tf.fuse(None) is False
