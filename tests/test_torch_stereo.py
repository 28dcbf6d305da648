"""Stereo geometry and stereo dense BA of the port against the JAX
package: the rig-pinned (i, i) edges of ``projective_transform`` (NHWC,
with Jacobians, and the DBA's channel-major layout), their linearization
(depth blocks only) and relinearized Gauss-Newton steps, on the graph of
tests/test_stereo.py (5 keyframes at 12x16, a stereo self-edge per
keyframe and the mono edges within 2 frames), all in f32."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nerf_slam_tpu.geometry import camera as jcam
from nerf_slam_tpu.geometry import se3 as jse3
from nerf_slam_tpu.solver import dba as jdba
from nerf_slam_tpu_torch.geometry import camera as tcam
from nerf_slam_tpu_torch.solver import dba as tdba

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

REL = np.array([-0.1, 0, 0, 0, 0, 0, 1.0], np.float32)
N, h, w = 5, 12, 16
E = 32


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _scene():
    """tests/test_stereo.py's metric scene: GT poses with substantial
    translations, inverse depths in [0.6, 1], and the stereo graph."""
    ks = jax.random.split(jax.random.PRNGKey(0), 3)
    xi = 0.08 * jax.random.normal(ks[0], (N, 6), dtype=jnp.float32)
    xi = xi.at[0].set(0.0).at[:, :3].mul(3.0)
    poses = np.asarray(jse3.exp(xi))
    disps = np.asarray(0.6 + 0.4 * jax.random.uniform(
        ks[1], (N, h, w), dtype=jnp.float32))
    intr = np.tile(np.array([[25.0, 25.0, w / 2, h / 2]], np.float32),
                   (N, 1))
    ii, jj = [], []
    for a in range(N):
        ii.append(a)
        jj.append(a)
        for b in range(N):
            if a != b and abs(a - b) <= 2:
                ii.append(a)
                jj.append(b)
    return poses, disps, intr, np.array(ii), np.array(jj)


@pytest.mark.parametrize("rig", [True, False])
def test_stereo_projective_transform_matches(rig):
    """Coordinates, validity and the three Jacobians, NHWC and
    channel-major, with and without the rig pose: within 1e-4 relative
    to each output's largest entry (the f32 rounding of the pose
    algebra, done in another order)."""
    poses, disps, intr, ii, jj = _scene()
    rel = REL if rig else None
    J = [jnp.asarray(a) for a in (poses, disps, intr, ii, jj)]
    T = [torch.from_numpy(np.array(a)) for a in (poses, disps, intr,
                                                   ii, jj)]
    cj, vj, jac_j = jcam.projective_transform(
        *J, jacobian=True,
        stereo_rel=None if rel is None else jnp.asarray(rel))
    ct, vt, jac_t = tcam.projective_transform(
        *T, jacobian=True,
        stereo_rel=None if rel is None else torch.from_numpy(rel))
    np.testing.assert_array_equal(_np(vt), _np(vj))
    for a, b in zip((cj,) + tuple(jac_j), (ct,) + tuple(jac_t)):
        np.testing.assert_allclose(_np(b), _np(a), rtol=0,
                                   atol=1e-4 * np.abs(_np(a)).max())
    out_j = jcam.projective_transform_cm(
        *J, stereo_rel=None if rel is None else jnp.asarray(rel))
    out_t = tcam.projective_transform_cm(*T, stereo_rel=rel)
    for a, b in zip(out_j, out_t):
        np.testing.assert_allclose(_np(b), _np(a), rtol=0,
                                   atol=1e-4 * np.abs(_np(a)).max())
    if rig:
        # a stereo edge maps a pixel at inverse depth d by 0.1 * fx * d
        # to the left, as the rig's -0.1 m baseline says
        st = ii == jj
        shift = _np(ct)[st][..., 0] - tcam.coords_grid(h, w).numpy()[..., 0]
        np.testing.assert_allclose(shift, -2.5 * disps[ii[st]], rtol=1e-5,
                                   atol=1e-5)


def _problem(seed):
    """Targets from the GT scene through the rig, weights, and a start
    perturbed off it: a step that moves poses and depths."""
    poses, disps, intr, ii, jj = _scene()
    n = ii.shape[0]
    rng = np.random.RandomState(seed)
    tgt, valid, _ = jcam.projective_transform(
        jnp.asarray(poses), jnp.asarray(disps), jnp.asarray(intr),
        jnp.asarray(ii), jnp.asarray(jj), stereo_rel=jnp.asarray(REL))
    targets = np.zeros((E, h, w, 2), np.float32)
    targets[:n] = np.asarray(tgt) + rng.randn(n, h, w, 2) * 0.05
    weights = np.zeros((E, h, w, 2), np.float32)
    weights[:n] = np.asarray(valid) * rng.uniform(0.3, 1.0, (n, h, w, 2))
    pert = np.concatenate([rng.randn(N, 3) * 0.02, rng.randn(N, 3) * 0.01],
                          -1).astype(np.float32)
    pert[0] = 0.0
    poses0 = np.asarray(jse3.retr(jnp.asarray(poses), jnp.asarray(pert)))
    disps0 = (disps * rng.uniform(0.8, 1.2, (N, h, w))).astype(np.float32)
    eta = np.full((N, h, w), 1e-4, np.float32)
    sens = np.zeros((N, h, w), np.float32)
    return ii, jj, [poses0, disps0, intr, targets, weights, eta, sens]


def _plans(ii, jj):
    jp = jdba.plan(ii, jj, 0, N, E, N, N)
    tp = tdba.plan(ii, jj, 0, N, E, N, N, device="cpu")
    no_pairs = dict(pair_a=None, pair_b=None, pair_valid=None)
    return jp._replace(**no_pairs), tp._replace(**no_pairs)


def test_stereo_linearize_matches_and_zeroes_pose_blocks():
    """The stereo linearization against the JAX package's (rtol 1e-4, the
    tolerance of the mono test in tests/test_torch_dba.py); the stereo
    edges' pose blocks are exactly 0 and their depth blocks are not."""
    ii, jj, arrs = _problem(0)
    jp, tp = _plans(ii, jj)
    J = [jnp.asarray(a) for a in arrs]
    T = [torch.from_numpy(a) for a in arrs]
    bj = jdba.linearize(*J[:5], jp, stereo_rel=jnp.asarray(REL))
    bt = tdba.linearize(*T[:5], tp, stereo_rel=torch.from_numpy(REL))
    for gj, gt in zip(bj, bt):
        for a, b in zip(gj, gt):
            np.testing.assert_allclose(_np(b), _np(a), rtol=1e-4,
                                       atol=1e-5 * np.abs(_np(a)).max())
    st = np.nonzero(ii == jj)[0]
    for blk in bt[0] + bt[1] + bt[2]:
        assert float(blk[st].abs().max()) == 0.0
    assert float(bt[3][0][st].abs().min()) > 0.0


def test_stereo_dba_iterations_match():
    """Four relinearized Gauss-Newton steps with the rig pose: poses and
    inverse depths against the JAX package's within 1e-4 (the mono
    test's tolerance, tests/test_torch_dba.py)."""
    ii, jj, arrs = _problem(1)
    jp, tp = _plans(ii, jj)
    J = [jnp.asarray(a) for a in arrs]
    T = [torch.from_numpy(a) for a in arrs]
    res = jdba.dba_iterations(*J, jp, iters=4, ep=0.01, lm=1e-4,
                              compute_covariances=False,
                              stereo_rel=jnp.asarray(REL))
    pt, dt = tdba.dba_iterations(*T, tp, iters=4, ep=0.01, lm=1e-4,
                                 stereo_rel=torch.from_numpy(REL))
    assert np.abs(_np(res.poses) - arrs[0]).max() > 1e-3   # poses moved
    np.testing.assert_allclose(_np(pt), _np(res.poses), atol=1e-4, rtol=0)
    np.testing.assert_allclose(_np(dt), _np(res.disps), atol=1e-4,
                               rtol=1e-4)


def test_stereo_dba_recovers_metric_scale():
    """tests/test_stereo.py's check on the port: from a consistently
    mis-scaled state (x2 translations, /2 inverse depths, a gauge move
    that mono edges cannot see) the stereo edges restore the metric scale
    within 10%."""
    poses, disps, intr, ii, jj = _scene()
    n = ii.shape[0]
    T = [torch.from_numpy(np.array(a)) for a in (poses, disps, intr,
                                                   ii, jj)]
    rel = torch.from_numpy(REL)
    tgt, valid, _ = tcam.projective_transform(*T, stereo_rel=rel)
    targets = torch.zeros((E, h, w, 2))
    targets[:n] = tgt
    weights = torch.zeros((E, h, w, 2))
    weights[:n] = torch.ones_like(tgt) * valid
    tp = _plans(ii, jj)[1]
    poses0 = T[0].clone()
    poses0[:, :3] *= 2.0
    pt, dt = tdba.dba_iterations(
        poses0, T[1] / 2.0, T[2], targets, weights,
        torch.full((N, h, w), 1e-4), torch.zeros((N, h, w)), tp, iters=12,
        ep=0.01, lm=1e-4, stereo_rel=rel)
    scale = float((dt / T[1]).mean())
    assert abs(scale - 1.0) < 0.1, scale


# ---------------------------------------------------------------------------
# the stereo tracker, frame by frame against the JAX tracker
# ---------------------------------------------------------------------------
from nerf_slam_tpu.datasets import SyntheticConfig, SyntheticDataset  # noqa: E402
from test_torch_frontend import (H, W, N_FRAMES, _check_state, _np as _fnp,  # noqa: E402,F401
                                 _run, exact_lookup, weights)


@pytest.fixture(scope="module")
def stereo_weights(weights):
    """The harness's weights on the same frames with the right camera
    rendered 0.1 m along +x (the rig of ``REL``)."""
    jparams, tnet, _ = weights
    ds = SyntheticDataset(SyntheticConfig(n_frames=30, height=H, width=W,
                                          stereo=True, baseline=0.1))
    return jparams, tnet, [ds[k] for k in range(N_FRAMES)]


def test_stereo_frontend_matches_jax(stereo_weights, exact_lookup):
    """``stereo=True`` with filters off, each frame from the JAX tracker's
    state (tests/test_torch_frontend.py's harness): the keyframes, the
    graph with its (i, i) stereo edges, and from the first keyframe round
    on the poses, inverse depths and covariances at that harness's
    tolerances.  The right-camera features of every keyframe agree to one
    bf16 rounding (2^-8 relative) of the largest feature: both sides
    round f32 encoder outputs that differ in the last bits."""
    rounds = []

    def check(k, jf, tf, out_j, out_t, was_init):
        if was_init:
            _check_state(jf, tf)
            rounds.append(k)
        n = jf.kf_idx + 1
        f_j = _fnp(jf.state.features1[:n])
        np.testing.assert_allclose(_fnp(tf.state.features1[:n]), f_j,
                                   rtol=0, atol=2 ** -8 * np.abs(f_j).max())
        return False

    jf, tf = _run(stereo_weights, -1.0, -1.0, check, stereo=True,
                  stereo_rel=tuple(float(v) for v in REL))
    assert rounds == list(range(5, N_FRAMES))
    n_stereo = int((tf.graph.ii == tf.graph.jj).sum())
    assert n_stereo > 0 and n_stereo == int((jf.graph.ii == jf.graph.jj)
                                            .sum())
    assert float(tf.state.features1.float().abs().sum()) > 0


def test_stereo_frontend_needs_the_right_image(weights):
    _, tnet, frames = weights
    from nerf_slam_tpu_torch.tracking import frontend as tfe
    from test_torch_frontend import SMALL
    tf = tfe.RaftVisualFrontend(tnet, tfe.FrontendConfig(**SMALL,
                                                         stereo=True),
                                (H, W), device="cpu")
    with pytest.raises(AssertionError, match="images_right"):
        tf(0, frames[0])
