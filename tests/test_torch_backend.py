"""The port's backend (global bundle adjustment at ``terminate()``) against
the JAX package: ``camera.depth_filter`` pointwise, then ``global_ba`` from
a tracked state copied out of the JAX frontend, its rollback guard, and the
one place where the port departs from the JAX code on purpose
(``_map_consistency``).

Both frontends run the trained ``weights_synthetic.npz`` in f32 on 48x64
synthetic frames, with the harness of tests/test_torch_frontend.py.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nerf_slam_tpu.geometry import camera as jcam
from nerf_slam_tpu.geometry import se3 as jse3
from nerf_slam_tpu_torch.geometry import camera as tcam
from nerf_slam_tpu_torch.solver import dba as tdba
from test_torch_frontend import _copy_state, _np, _run, weights  # noqa: F401

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False


def _scene(seed, N=9, h=12, w=16):
    """A camera sliding sideways in front of a slanted plane: neighbouring
    keyframes agree on most depths, so the counts are not all zero."""
    rng = np.random.RandomState(seed)
    xi = np.zeros((N, 6), np.float32)
    xi[:, 0] = 0.05 * np.arange(N)
    xi[:, 3:] = rng.randn(N, 3) * 0.01
    poses = np.asarray(jse3.exp(jnp.asarray(xi)))
    u = np.arange(w, dtype=np.float32)[None, None, :]
    disps = (0.5 + 0.01 * u + 0.02 * rng.rand(N, h, w)).astype(np.float32)
    intr = np.tile(np.array([[w * 0.9, h * 1.1, w / 2 - 0.3, h / 2 + 0.2]],
                            np.float32), (N, 1))
    return poses, disps, intr


@pytest.mark.parametrize("thresh", [0.05, "per_keyframe"])
def test_depth_filter_matches_jax(thresh):
    """Counts are small integers decided by f32 comparisons; a projection
    that lands within rounding of a pixel border or a depth difference
    within rounding of the threshold may flip one neighbour at one pixel,
    so at most 0.5% of the pixels may differ, and by one count."""
    poses, disps, intr = _scene(3)
    N = poses.shape[0]
    ix = np.arange(N)
    if thresh == "per_keyframe":
        thresh = np.linspace(0.02, 0.2, N).astype(np.float32)
    want = np.asarray(jcam.depth_filter(
        jnp.asarray(poses), jnp.asarray(disps), jnp.asarray(intr),
        jnp.asarray(ix), jnp.asarray(thresh)))
    got = tcam.depth_filter(
        torch.from_numpy(poses), torch.from_numpy(disps),
        torch.from_numpy(intr), torch.from_numpy(ix),
        torch.as_tensor(thresh)).numpy()
    assert got.shape == want.shape == disps.shape
    assert want.max() >= 3 and want.min() == 0     # the case says something
    diff = np.abs(got - want)
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 0.005


def test_depth_filter_ignores_neighbours_outside_the_buffer():
    """The first keyframe has no ix-1..ix-3: only ix+3..ix+5 can agree."""
    poses, disps, intr = _scene(4)
    T = torch.from_numpy
    got = tcam.depth_filter(T(poses), T(disps), T(intr), [0, 8], 1e6)
    assert float(got.max()) <= 3.0


@pytest.fixture(scope="module")
def tracked(weights):
    """Both frontends after the 9 frames, every frame a keyframe."""
    from _pytest.monkeypatch import MonkeyPatch
    from nerf_slam_tpu_torch.ops import corr_lookup
    mp = MonkeyPatch()
    # as tests/test_torch_frontend.py's exact_lookup: at W1 = 8 the JAX
    # package sends kernel #1's lookup to the exact-tap kernel #2
    mp.setattr(corr_lookup, "lookup_pyramid_grouped4",
               lambda levels, coords, dims, n_act=None:
               corr_lookup.lookup_pyramid_plain(levels, coords)
               .to(torch.bfloat16))
    try:
        jf, tf = _run(weights, -1.0, -1.0, lambda *a: False)
    finally:
        mp.undo()
    return jf, tf


def _sync_and_scale(jf, tf):
    """The port takes the JAX state; both maps then get the wrong scale so
    that the normalization has visible work (tests/test_frontend.py:84)."""
    _copy_state(jf, tf)
    jf.state = jf.state._replace(idepths=jf.state.idepths * 2.0)
    tf.state.idepths = tf.state.idepths * 2.0


def test_map_consistency_slices_to_live_keyframes(tracked):
    """The one intended divergence.  The JAX ``_map_consistency`` hands the
    full-capacity buffers to ``depth_filter``, so keyframes near the end
    count unused slots (identity pose, idepth 1) as neighbours; the port
    passes the kf_idx + 1 live keyframes only.  The port's score therefore
    equals the JAX ``depth_filter`` on the sliced buffers, not the JAX
    method's own value."""
    jf, tf = tracked
    _copy_state(jf, tf)
    n = jf.kf_idx + 1
    st = jf.state
    assert n < st.idepths.shape[0]
    med_z = 1.0 / jnp.maximum(jnp.median(st.idepths[:n]), 1e-6)
    sliced = float(jnp.mean(jcam.depth_filter(
        st.cam_T_world[:n], st.idepths[:n], st.intrinsics[:n],
        jnp.arange(n), 0.1 * med_z)))
    got = tf._map_consistency()
    assert abs(got - sliced) <= 0.01 * max(sliced, 1.0)
    # recorded, not copied: the JAX method's score counts the unused slots
    # (0.381 against 0.329 on this sequence)
    full = jf._map_consistency()
    assert full > sliced + 0.01


def test_global_ba_matches_jax(tracked, monkeypatch):
    """One backend step (tests/test_frontend.py:79 drives it the same way)
    from the same state: normalization, the backend graph, chunked GRU
    refinement with on-the-fly correlation, and two DBA iterations over all
    keyframes.  The guard's scores differ by design (see above), so both
    sides score a constant here: equal scores keep the refinement, because
    the guard's comparison is a strict ``<``.  Tolerances as the frame
    rounds of tests/test_torch_frontend.py (one GRU pass and two
    Gauss-Newton steps in f32, summed in other orders)."""
    jf, tf = tracked
    _sync_and_scale(jf, tf)
    monkeypatch.setattr(type(jf), "_map_consistency", lambda self: 1.0)
    monkeypatch.setattr(type(tf), "_map_consistency", lambda self: 1.0)
    n = jf.kf_idx + 1
    before = _np(tf.state.cam_T_world[:n]).copy()
    jf.global_ba(steps=1, chunk=8, thresh=1e6)
    tf.global_ba(steps=1, chunk=8, thresh=1e6)
    assert tf.last_gba_scores == (1.0, 1.0)
    pj, pt = _np(jf.state.cam_T_world[:n]), _np(tf.state.cam_T_world[:n])
    dj, dt = _np(jf.state.idepths[:n]), _np(tf.state.idepths[:n])
    assert np.isfinite(pt).all() and np.isfinite(dt).all()
    assert np.abs(pt - before).max() > 1e-3          # the backend moved it
    assert 0.5 < dt.mean() < 1.5                     # rescaled towards 1
    np.testing.assert_allclose(pt, pj, atol=2e-3)
    np.testing.assert_allclose(dt, dj, atol=5e-3, rtol=5e-3)
    assert tf.viz_idx[:n].all()


def test_global_ba_rolls_back_a_wrecked_map(tracked, monkeypatch):
    """A refinement that wrecks the map (translations x6, depths x0.1, the
    signature of a divergent backend) lowers the consistency score and is
    undone: the state returns to the normalized snapshot.  As
    tests/test_frontend.py:97, with the map seeded from ground truth so
    that the score before is high."""
    jf, tf = tracked
    _copy_state(jf, tf)
    st, n = tf.state, tf.kf_idx + 1
    gt_w2c = torch.from_numpy(np.asarray(jse3.from_matrix(
        jnp.linalg.inv(jnp.asarray(st.gt_poses[:n].numpy())))))
    st.cam_T_world = st.cam_T_world.clone()
    st.idepths = st.idepths.clone()
    st.cam_T_world[:n] = gt_w2c
    st.idepths[:n] = 1.0 / torch.clamp(st.gt_depths[:n, ::8, ::8], min=0.1)
    poses0, disps0 = _np(st.cam_T_world[:n]), _np(st.idepths[:n])

    real = tdba.dba_iterations

    def wrecking(poses, disps, *a, **kw):
        poses, disps = real(poses, disps, *a, **kw)
        poses = poses.clone()
        poses[:, :3] *= 6.0
        return poses, disps * 0.1

    monkeypatch.setattr(tdba, "dba_iterations", wrecking)
    tf.global_ba(steps=1, chunk=8, thresh=1e6)
    pre, post = tf.last_gba_scores
    assert post < pre                      # the wreck was detected
    disps1, poses1 = _np(tf.state.idepths[:n]), _np(tf.state.cam_T_world[:n])
    s = disps0.mean() / disps1.mean()
    np.testing.assert_allclose(disps1 * s, disps0, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(poses1[:, :3] / s, poses0[:, :3], rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_allclose(poses1[:, 3:], poses0[:, 3:], rtol=1e-5,
                               atol=1e-6)


def test_terminate_runs_the_backend_when_asked(tracked, monkeypatch):
    """``FrontendConfig.global_ba`` makes ``terminate()`` run the backend
    twice (7 and 12 steps, as the reference); off, it runs nothing."""
    import dataclasses
    _, tf = tracked
    calls = []
    monkeypatch.setattr(type(tf), "global_ba",
                        lambda self, steps: calls.append(steps))
    tf.terminate()
    assert calls == [] and tf.stop
    monkeypatch.setattr(tf, "cfg", dataclasses.replace(tf.cfg,
                                                       global_ba=True))
    tf.terminate()
    assert calls == [7, 12]
