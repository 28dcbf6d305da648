"""The port's tracking frontend against the JAX frontend, frame by frame.

Both run the trained ``weights_synthetic.npz`` in f32 on 48x64 synthetic
frames with the small configuration of tests/test_frontend.py.

Each frame starts both frontends from the same state: before frame k the
JAX frontend's host and device state is copied into the port, so every
comparison covers exactly one frame's work (ingest, motion filter, graph
edits, update iterations, accept/reject) and not the amplified rounding
of the frames before it.  At this size tracking is chaotic: the JAX
frontend alone moves its poses by ~0.2 after 8 iterations when its
intrinsics are perturbed by 1e-6 (relative), so a free-running
comparison of two f32 implementations says nothing after the
initialization.  For the same reason the initialization's 16 iterations
from the identity state are checked for their decisions and graph only.

At W1 = 8 the JAX package sends kernel #1's lookup to its fallback, the
exact-tap kernel #2 (corr_pallas.py:520-528); the port has no fallback,
so the test routes the port's update-loop lookup to kernel #2's plain
version, rounded to bf16 as the JAX update rounds it.  Kernel #1 itself is
tested in tests/test_torch_corr_lookup.py.
"""
import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nerf_slam_tpu.datasets import SyntheticConfig, SyntheticDataset
from nerf_slam_tpu.models import DroidNet as JaxDroidNet
from nerf_slam_tpu.tracking import frontend as jfe
from nerf_slam_tpu.utils.checkpoint import load_arrays, unflatten_into
from nerf_slam_tpu_torch.models import DroidNet, load_flax_weights
from nerf_slam_tpu_torch.ops import corr_lookup
from nerf_slam_tpu_torch.tracking import frontend as tfe
from nerf_slam_tpu_torch.tracking import graph as tgraph

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

H, W = 48, 64
N_FRAMES = 9
WEIGHTS = os.path.join(os.path.dirname(__file__), "..",
                       "weights_synthetic.npz")
SMALL = dict(buffer=12, e_active=24, e_inactive=16, p_window=12,
             k_depth=14, keyframe_warmup=4, max_factors=20, iters1=1,
             iters2=1, gn_iters=1, damping_scale=1.0, damping_offset=1e-4)


class _JaxF32(jfe.RaftVisualFrontend):
    """The JAX frontend with its network and GRU hidden state in f32."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.net = JaxDroidNet(dtype=jnp.float32)

    def _alloc_edges(self):
        e = super()._alloc_edges()
        return e._replace(hidden=e.hidden.astype(jnp.float32))


@pytest.fixture(scope="module")
def weights():
    flat, _ = load_arrays(WEIGHTS)
    jparams = unflatten_into(JaxDroidNet(dtype=jnp.float32).init_params(
        jax.random.PRNGKey(0), H, W), flat)
    tnet = load_flax_weights(DroidNet(dtype=torch.float32), flat)
    frames = SyntheticDataset(SyntheticConfig(n_frames=30, height=H,
                                              width=W))
    return jparams, tnet, [frames[k] for k in range(N_FRAMES)]


@pytest.fixture
def exact_lookup(monkeypatch):
    def lookup(levels, coords, dims, n_act=None):
        return corr_lookup.lookup_pyramid_plain(levels, coords) \
            .to(torch.bfloat16)
    monkeypatch.setattr(corr_lookup, "lookup_pyramid_grouped4", lookup)


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(jnp.asarray(x).astype(jnp.float32)
                                  if jnp.asarray(x).dtype == jnp.bfloat16
                                  else np.asarray(x)))
    return t if dtype is None else t.to(dtype)


def _copy_state(jf, tf):
    """JAX frontend state -> port frontend (host and device)."""
    st = jf.state
    for f in dataclasses.fields(tf.state):
        setattr(tf.state, f.name,
                _t(getattr(st, f.name), getattr(tf.state, f.name).dtype))
    ed = jf.edges
    tf.edges = tfe.EdgeState(
        hidden=_t(ed.hidden, tf.edges.hidden.dtype), flow=_t(ed.flow),
        flow_weight=_t(ed.flow_weight),
        corr_levels=[_t(lv, torch.bfloat16) for lv in ed.corr_levels])
    tf.inactive = tfe.InactiveState(flow=_t(jf.inactive.flow),
                                    flow_weight=_t(jf.inactive.flow_weight))
    g = jf.graph
    tf.graph = tgraph.CovisibilityGraph(
        max_factors=g.max_factors,
        **{k: np.array(getattr(g, k)) for k in
           ("ii", "jj", "age", "ii_inactive", "jj_inactive", "ii_bad",
            "jj_bad")})
    for k in ("kf_idx", "last_kf_idx", "last_k", "is_initialized", "stop",
              "_pending_app_n_old"):
        setattr(tf, k, getattr(jf, k))
    tf.viz_idx = jf.viz_idx.copy()
    tf.kf_idx_to_f_idx = dict(jf.kf_idx_to_f_idx)
    tf.f_idx_to_kf_idx = dict(jf.f_idx_to_kf_idx)
    tf._pending_gather = (None if jf._pending_gather is None
                          else jf._pending_gather.copy())
    tf._pending_app = [a.copy() for a in jf._pending_app]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _run(weights, mft, kft, check_frame, **extra):
    """Both frontends over the frames, re-synced before each; returns
    early from a frame's checks when ``check_frame`` says its decision
    lay within tolerance of a threshold.  ``extra``: further
    ``FrontendConfig`` fields, the same on both sides."""
    jparams, tnet, frames = weights
    cfg = dict(SMALL, motion_filter_thresh=mft, keyframe_thresh=kft, **extra)
    jf = _JaxF32(jparams, jfe.FrontendConfig(**cfg), (H, W))
    tf = tfe.RaftVisualFrontend(tnet, tfe.FrontendConfig(**cfg), (H, W),
                                device="cpu")
    for k, pkt in enumerate(frames):
        if k:
            _copy_state(jf, tf)
        jf.last_motion_mag = tf.last_motion_mag = None
        jf.last_kf_dist = tf.last_kf_dist = None
        was_init = jf.is_initialized
        out_j, out_t = jf(k, pkt), tf(k, pkt)
        if check_frame(k, jf, tf, out_j, out_t, was_init):
            continue        # a decision at its threshold: next frame
        assert (out_j is None) == (out_t is None), k
        assert jf.kf_idx == tf.kf_idx, k
        assert jf.is_initialized == tf.is_initialized, k
        np.testing.assert_array_equal(tf.graph.ii, jf.graph.ii)
        np.testing.assert_array_equal(tf.graph.jj, jf.graph.jj)
        np.testing.assert_array_equal(tf.graph.age, jf.graph.age)
        np.testing.assert_array_equal(tf.graph.ii_inactive,
                                      jf.graph.ii_inactive)
    return jf, tf


def _check_state(jf, tf):
    """One keyframe round from the same state (2 GRU + DBA iterations).
    The f32 convolutions and the DBA's sums run in different orders on the
    two sides; measured differences are up to 2.5e-4 in poses and 1.3e-3
    in idepths (of ~1), and the tolerances leave a factor of ~4-8."""
    n = jf.kf_idx + 1
    st_j, st_t = jf.state, tf.state
    np.testing.assert_allclose(_np(st_t.cam_T_world[:n]),
                               _np(st_j.cam_T_world[:n]), atol=2e-3)
    np.testing.assert_allclose(_np(st_t.idepths[:n]), _np(st_j.idepths[:n]),
                               atol=5e-3, rtol=5e-3)
    np.testing.assert_allclose(_np(st_t.idepths_up[:n]),
                               _np(st_j.idepths_up[:n]), atol=5e-3,
                               rtol=5e-3)
    # covariances are ratios of the damped system's pivots: 2% relative
    for name in ("pose_cov", "idepths_cov"):
        a, b = _np(getattr(st_j, name)[:n]), _np(getattr(st_t, name)[:n])
        np.testing.assert_allclose(b, a, rtol=2e-2,
                                   atol=2e-2 * np.abs(a).max())


def _filters_off(weights, **extra):
    """Filters off: every frame is a keyframe; the keyframe count, the
    graph and, from the first keyframe round on, the poses, idepths and
    covariances match."""
    rounds = []

    def check(k, jf, tf, out_j, out_t, was_init):
        if was_init:
            _check_state(jf, tf)
            rounds.append(k)
        if out_t is not None and "cam0_poses" in out_t:
            assert out_t["viz_count"] == out_j["viz_count"]
            np.testing.assert_array_equal(out_t["viz_idx"], out_j["viz_idx"])
        return False

    jf, tf = _run(weights, -1.0, -1.0, check, **extra)
    assert tf.kf_idx == N_FRAMES and tf.is_initialized
    assert rounds == list(range(5, N_FRAMES))
    return jf, tf


def test_frontend_filters_off_matches_jax(weights, exact_lookup):
    _filters_off(weights)


@pytest.mark.parametrize("corr_impl,n_levels,lookup", [
    ("pallas", 1, "lookup_pyramid_l0"),
    ("pallas_grouped", 4, "lookup_level"),
    ("onehot", 4, None)])
def test_frontend_corr_impl_matches_jax(weights, monkeypatch, corr_impl,
                                        n_levels, lookup):
    """The tracker's other lookup configurations, frame by frame against
    the JAX tracker built with the same ``corr_impl``, at the tolerances of
    the default configuration.  "pallas" stores and copies ONE level per
    edge and looks up through the level-0 function (kernel #4);
    "pallas_grouped" at W1 = 8 goes to the single-level function (kernel
    #3) on both sides, since the grouped TPU kernel needs W1 % 16 == 0;
    "onehot" uses the plain reference lookup and no kernel function."""
    calls = {}
    for name in ("lookup_pyramid_grouped4", "lookup_pyramid_l0",
                 "lookup_level", "lookup_level_grouped"):
        real = getattr(corr_lookup, name)
        monkeypatch.setattr(
            corr_lookup, name, lambda *a, _n=name, _r=real:
            (calls.__setitem__(_n, calls.get(_n, 0) + 1), _r(*a))[1])
    jf, tf = _filters_off(weights, corr_impl=corr_impl)
    assert len(jf.edges.corr_levels) == len(tf.edges.corr_levels) == n_levels
    assert [tuple(v.shape) for v in tf.edges.corr_levels] == \
        [tuple(v.shape) for v in jf.edges.corr_levels]
    assert set(calls) == ({lookup} if lookup else set())


def test_frontend_sparse_schur_matches_jax(weights, exact_lookup):
    """``schur_impl="sparse"``: both trackers build the interaction list
    and assemble the Schur complement from it, in the update iterations
    and in the export tail's covariances."""
    seen = []
    real = tfe.dba._sparse_schur

    def spy(*a, **k):
        seen.append(1)
        return real(*a, **k)

    tfe.dba._sparse_schur = spy
    try:
        _filters_off(weights, schur_impl="sparse")
    finally:
        tfe.dba._sparse_schur = real
    assert seen


def test_frontend_rejects_unknown_impls(weights):
    _, tnet, _ = weights
    for bad in (dict(corr_impl="pallas5"), dict(schur_impl="banded")):
        with pytest.raises(ValueError):
            tfe.RaftVisualFrontend(tnet, tfe.FrontendConfig(**SMALL, **bad),
                                   (H, W), device="cpu")


def test_frontend_production_thresholds_match_jax(weights, exact_lookup):
    """Motion filter 2.4 px and keyframe rejection 4.0: the motion
    magnitudes agree to 1e-3 relative (they depend on the features of two
    frames only) and the keyframe distances to 2e-2 relative; every
    accept/reject decision is identical unless a value lies within that
    tolerance of its threshold (the frame is then skipped)."""
    decisions, mags = [], []

    def check(k, jf, tf, out_j, out_t, was_init):
        near = False
        # the JAX frontend reports the magnitude of frames whose motion
        # decision rides its fused update, i.e. once it is initialized
        mj, mt = jf.last_motion_mag, tf.last_motion_mag
        if mj is not None and mt is not None and was_init:
            mj = float(mj)
            assert abs(mt - mj) <= 1e-3 * abs(mj) + 1e-4, (k, mt, mj)
            mags.append(mt)
            near = abs(mj - 2.4) <= 1e-3 * 2.4 + 1e-4
        dj, dt = jf.last_kf_dist, tf.last_kf_dist
        if dj is not None and dt is not None and was_init:
            dj, dt = float(dj), float(dt)
            assert abs(dt - dj) <= 2e-2 * abs(dj) + 1e-3, (k, dt, dj)
            near = near or abs(dj - 4.0) <= 2e-2 * 4.0 + 1e-3
            decisions.append((k, dj >= 4.0, dt >= 4.0, near))
            if dj >= 4.0 and dt >= 4.0:
                _check_state(jf, tf)
        return near

    _run(weights, 2.4, 4.0, check)
    assert decisions, "no keyframe round ran"
    assert mags, "no motion magnitude was compared"
    for k, acc_j, acc_t, near in decisions:
        assert acc_j == acc_t or near, (k, acc_j, acc_t)


def test_last_frame_rejected_as_keyframe_still_terminates(weights,
                                                          exact_lookup):
    """A sequence whose last frame fails the keyframe-distance test must
    still end: the tracker terminates on the keyframes it has and emits
    the final packet.  (The JAX tracker returns None there and never
    stops, which leaves a pipeline waiting; the port does not copy that.)"""
    _, tnet, frames = weights
    cfg = tfe.FrontendConfig(**dict(SMALL, motion_filter_thresh=-1.0,
                                    keyframe_thresh=1e9))
    tf = tfe.RaftVisualFrontend(tnet, cfg, (H, W), device="cpu")
    outs = []
    for k, pkt in enumerate(frames[:7]):
        outs.append(tf(k, dict(pkt, is_last_frame=(k == 6))))
    assert tf.is_initialized and tf.stop_condition()
    assert tf.kf_idx == SMALL["keyframe_warmup"]       # frames 5, 6 rejected
    assert outs[5] is None
    assert outs[6] is not None and outs[6]["is_last_frame"]
    assert outs[6]["viz_count"] == tf.kf_idx + 1
    assert torch.isfinite(outs[6]["cam0_poses"]).all()


def test_has_enough_motion_matches_jax(weights):
    """From the same state after the warm-up, each further frame's motion
    test against the last keyframe: the port's magnitude within 1e-3
    relative of JAX's, and the same decision at thresholds 10% either
    side of it."""
    jparams, tnet, frames = weights
    cfg = dict(SMALL, motion_filter_thresh=-1.0, keyframe_thresh=-1.0)
    jf = _JaxF32(jparams, jfe.FrontendConfig(**cfg), (H, W))
    tf = tfe.RaftVisualFrontend(tnet, tfe.FrontendConfig(**cfg), (H, W),
                                device="cpu")
    for k, pkt in enumerate(frames[:6]):
        jf(k, pkt)
    _copy_state(jf, tf)
    for pkt in frames[6:]:
        img = pkt["images"][..., :3]
        feat_j = jf.net.apply(jf.params, jf._normalize_dev(
            jnp.asarray(img)), method=JaxDroidNet.features)[0]
        feat_t = tf.net.features(tf._normalize(torch.from_numpy(
            np.ascontiguousarray(img))))[0]
        st = jf.state
        mag_j = float(jf._motion_mag(
            jf.params, st.features[jf.last_kf_idx].astype(jnp.float32),
            feat_j, st.contexts[jf.last_kf_idx],
            st.cst_contexts[jf.last_kf_idx]))
        mag_t = float(tf._motion_mag(feat_t, tf.last_kf_idx))
        assert abs(mag_t - mag_j) <= 1e-3 * mag_j, (mag_t, mag_j)
        for f in (0.9, 1.1):
            for fe in (jf, tf):
                fe.cfg = dataclasses.replace(fe.cfg,
                                             motion_filter_thresh=f * mag_j)
            want = jf.has_enough_motion(feat_j)
            assert want == (f < 1)
            assert tf.has_enough_motion(feat_t) == want
