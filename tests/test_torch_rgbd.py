"""The port's RGB-D tracker (``FrontendConfig.rgbd``) and its tracker
without marginal covariances (``compute_covariances=False``) against the
JAX tracker, frame by frame in tests/test_torch_frontend.py's harness
(trained weights in f32, 48x64 synthetic frames, each frame from the JAX
tracker's state), and the step of an RGB-D session at which its metric
scale is lost."""
import numpy as np
import pytest
import torch

from nerf_slam_tpu_torch.datasets import SyntheticConfig, SyntheticDataset
from nerf_slam_tpu_torch.tracking import frontend as tfe
from nerf_slam_tpu_torch.utils.evaluation import (_pose_to_c2w_translation,
                                                  ate_rmse, umeyama_alignment)
from test_torch_frontend import (H, N_FRAMES, SMALL, W, _check_state,  # noqa: F401
                                 _np, _run, exact_lookup, weights)

torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several test processes on a
    few cores, where many threads a process contend and slow every test
    far more than one thread does."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rounds(weights, **extra):
    rounds = []

    def check(k, jf, tf, out_j, out_t, was_init):
        if was_init:
            _check_state(jf, tf)
            rounds.append(k)
        return False

    jf, tf = _run(weights, -1.0, -1.0, check, **extra)
    assert rounds == list(range(5, N_FRAMES))
    return jf, tf


def test_rgbd_frontend_matches_jax(weights, exact_lookup):
    """``rgbd=True``: the sensed inverse depths (one pixel of each 8x8
    block of the packets' depths) equal the JAX tracker's to the bit, and
    the keyframes, graph, poses, inverse depths and covariances match at
    the harness's tolerances.  The sensed depths anchor the gauge: the
    inverse depths come out metric, within 20% of the sensed ones on
    average."""
    jf, tf = _rounds(weights, rgbd=True)
    n = tf.kf_idx                 # the frames stored (kf_idx: the next)
    sensed = _np(tf.state.idepths_sensed[:n])
    np.testing.assert_array_equal(sensed, _np(jf.state.idepths_sensed[:n]))
    assert (sensed > 0).all()
    ratio = float(np.mean(_np(tf.state.idepths[:n]) / sensed))
    assert abs(ratio - 1.0) < 0.2, ratio


def test_rgbd_seeds_the_new_keyframe_from_sensed_depths(weights):
    """The per-keyframe round starts the new keyframe's inverse depths
    from its sensed ones (the port alone, 7 frames, filters off): with
    zero iterations the round leaves them as seeded, and a round without
    a seed slot leaves the keyframe's inverse depths as they were."""
    _, tnet, frames = weights
    cfg = tfe.FrontendConfig(**dict(SMALL, motion_filter_thresh=-1.0,
                                    keyframe_thresh=-1.0, rgbd=True))
    tf = tfe.RaftVisualFrontend(tnet, cfg, (H, W), device="cpu")
    for k, pkt in enumerate(frames[:7]):
        tf(k, pkt)
    k, st = tf.kf_idx - 1, tf.state            # the newest keyframe
    st.idepths[k] = 0.5
    tf.update(n_iters=0, seed_sensed_slot=-1)
    assert (st.idepths[k] == 0.5).all()
    tf.update(n_iters=0, seed_sensed_slot=k)
    assert (st.idepths_sensed[k] > 0).all()
    assert torch.equal(st.idepths[k], st.idepths_sensed[k])


def test_frontend_without_covariances_matches_jax(weights, exact_lookup):
    """``compute_covariances=False``: both trackers skip the marginal
    covariances and export 1e-4 I pose covariances and unit inverse-depth
    variances for the keyframes of each round; poses and depths match at
    the harness's tolerances."""
    jf, tf = _rounds(weights, compute_covariances=False)
    n = tf.kf_idx + 1
    np.testing.assert_array_equal(_np(tf.state.pose_cov[:n]),
                                  _np(jf.state.pose_cov[:n]))
    np.testing.assert_array_equal(_np(tf.state.idepths_cov[:n]),
                                  _np(jf.state.idepths_cov[:n]))
    assert (_np(tf.state.idepths_cov[:n]) == 1.0).all()


def _initialized(tnet, frames, rgbd: bool):
    """A tracker at the end of its initialization (16 update iterations
    over the first 9 keyframes) on ``frames``, under the settings of
    scripts/compare_tracker_modes.py (the plain lookup, the production
    filters)."""
    cfg = tfe.FrontendConfig(
        buffer=24, e_active=64, e_inactive=48, p_window=24, k_depth=28,
        motion_filter_thresh=2.4, keyframe_thresh=4.0, corr_impl="onehot",
        damping_scale=1.0, damping_offset=1e-4, rgbd=rgbd)
    fe = tfe.RaftVisualFrontend(tnet, cfg, frames[0]["images"].shape[:2],
                                device="cpu")
    for k, f in enumerate(frames):
        fe(k, f)
        if fe.is_initialized:
            return fe
    raise AssertionError("the tracker did not initialize")


def _trajectory(fe):
    n = fe.kf_idx
    return (_pose_to_c2w_translation(_np(fe.state.cam_T_world[:n])),
            _np(fe.state.gt_poses[:n, :3, 3]))


def test_rgbd_initialization_makes_depths_metric_and_translations_long(
        weights):
    """Pins where an RGB-D session loses its metric scale: in the
    initialization, under the sensed-depth prior.  On
    96x128 frames of the room's orbit (12 deg a frame), the RGB-D
    tracker's 16 iterations end with the keyframes' inverse depths metric
    (the median ratio to the true ones within 5% of 1) and their
    translations too long: the Sim(3) scale that maps the trajectory onto
    the ground truth is below 0.85 (0.55 here; JAX at 168x320 gives 0.69
    at this step, as the port).  The monocular tracker on the same
    frames, with its inverse depths free, keeps the trajectory's shape
    (Sim(3) ATE under 0.1 m) where the RGB-D one is more than 2x off
    without a scale.  The prior pins every pixel's depth, and the flow
    targets' errors, which the monocular solve absorbs into the depths,
    go into the poses instead; a repair has to make this test fail."""
    _, tnet, _ = weights
    ds = SyntheticDataset(SyntheticConfig(n_frames=30, height=96, width=128))
    frames = [ds[k] for k in range(9)]
    fe = _initialized(tnet, frames, rgbd=True)
    n = fe.kf_idx
    true = np.stack([1.0 / frames[fe.kf_idx_to_f_idx[i]]["depths"][4::8, 4::8]
                     for i in range(n)])
    ratio = float(np.median(_np(fe.state.idepths[:n]) / true))
    est, gt = _trajectory(fe)
    scale = umeyama_alignment(est, gt)[2]
    assert abs(ratio - 1.0) < 0.05, ratio
    assert scale < 0.85, scale
    mono_est, mono_gt = _trajectory(_initialized(tnet, frames, rgbd=False))
    mono_ate = ate_rmse(mono_est, mono_gt)
    assert mono_ate < 0.1, mono_ate
    assert ate_rmse(est, gt, align_scale=False) > 2 * mono_ate
