"""The port's RGB-D tracker (``FrontendConfig.rgbd``) and its tracker
without marginal covariances (``compute_covariances=False``) against the
JAX tracker, frame by frame in tests/test_torch_frontend.py's harness
(trained weights in f32, 48x64 synthetic frames, each frame from the JAX
tracker's state)."""
import numpy as np
import pytest
import torch

from nerf_slam_tpu_torch.tracking import frontend as tfe
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
