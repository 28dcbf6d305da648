"""The port's NerfFusion options that are off by default, as in the JAX
package, against the JAX package on the PE field and packet of
tests/test_torch_nerf.py, with the JAX side's random draws handed to the
port: mapping-time pose refinement (``optimize_extrinsics``: the
coordinate-descent schedule, one refined step's loss, pose gradient and
deltas, and the two Adams' state across a pose-only phase), the
depth-annealing multiplier, the plain render (``render_accel=False``) and
the dynamic render resolution (``_pick_render_scale``)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nerf_slam_tpu.fusion.nerf_fusion import (NerfFusion as JaxFusion,
                                              NerfFusionConfig as JaxCfg)
from nerf_slam_tpu_torch.fusion import nerf_fusion as tnf
from nerf_slam_tpu_torch.fusion import ngp as tngp
from nerf_slam_tpu_torch.fusion.nerf_fusion import (Batch, NerfFusion,
                                                    NerfFusionConfig)
from test_torch_nerf import H, N_VIEWS, RAYS, W, _np, _packet

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


def _pair(**kw):
    """A JAX and a port NerfFusion with the same field, both fed _packet()."""
    cfg_kw = dict(buffer=N_VIEWS + 2, height=H, width=W, batch_rays=RAYS,
                  **kw)
    jf = JaxFusion(JaxCfg(**cfg_kw), seed=0)
    tf = NerfFusion(NerfFusionConfig(**cfg_kw), seed=0, device="cpu")
    tngp.load_ngp_params(tf.field, jf.params.table, jf.params.mlp)
    pkt = _packet()
    jf.fuse(pkt)
    tf.fuse(pkt)
    return jf, tf


def _draws(jf, key):
    """The port's Batch of the draws JAX's _step_body makes from ``key``."""
    kimg, kuv, ksamp = jax.random.split(key, 3)
    ts = jf.train_set
    p = ts.valid / jnp.maximum(ts.valid.sum(), 1.0)
    img_idx = jax.random.choice(kimg, jf.cfg.buffer, (RAYS,), p=p)
    uv = jax.random.uniform(kuv, (RAYS, 2))
    k1, k2 = jax.random.split(ksamp)
    ngp = jf.cfg.ngp
    draws = (jax.random.uniform(k1, (RAYS, ngp.n_uniform)),
             jax.random.normal(k2, (RAYS, ngp.n_depth)),
             jax.random.uniform(k2, (RAYS, ngp.n_depth)))
    return Batch(torch.from_numpy(np.asarray(img_idx).astype(np.int64)),
                 torch.from_numpy(_np(uv)),
                 tuple(torch.from_numpy(_np(x)) for x in draws))


def _jax_schedule(jf, it):
    """(pose_enable, field_enable, depth_mult) of iteration ``it`` as the
    JAX package's scan hands them to its step (read by a stand-in step)."""
    def record(params, deltas, opt_state, pose_opt_state, train_set, key,
               pose_enable, field_enable, depth_mult=1.0):
        rec = jnp.stack([jnp.float32(pose_enable), jnp.float32(field_enable),
                         jnp.float32(depth_mult)])
        return params, deltas, opt_state, pose_opt_state, rec, 0.0, 0.0

    jf._step_body = record
    try:
        out = jf._scan_steps(jf.params, jf.pose_deltas, jf.opt_state,
                             jf.pose_opt_state, jf.train_set, jf.key, 1,
                             jnp.int32(it))
    finally:
        del jf._step_body
    return tuple(float(v) for v in np.asarray(out[-1]))


def test_schedule_and_anneal_multiplier_match_jax():
    """The coordinate-descent phases (pose-only at the end of each cycle
    from extrinsics_start on) equal the JAX scan's at the phase
    boundaries, and the depth-annealing multiplier (1 -> floor over
    depth_anneal_iters, then the floor) its f32 value within 1e-6
    relative, a few f32 roundings (XLA divides by the ramp length as a
    product with its f32 reciprocal, the port divides)."""
    kw = dict(optimize_extrinsics=True, extrinsics_start=500,
              extrinsics_period=100, extrinsics_pose_iters=25,
              depth_anneal_iters=1000, depth_anneal_floor=0.25)
    jf = JaxFusion(JaxCfg(buffer=2, height=H, width=W, **kw), seed=0)
    tf = NerfFusion(NerfFusionConfig(buffer=2, height=H, width=W, **kw),
                    seed=0, device="cpu")
    its = [0, 1, 333, 499, 500, 574, 575, 599, 600, 674, 675, 999, 1000,
           1500]
    for it in its:
        got, want = tf._schedule(it), _jax_schedule(jf, it)
        assert got[:2] == want[:2], it
        np.testing.assert_allclose(got[2], want[2], rtol=1e-6, atol=0)
    assert [tf._schedule(it)[0] for it in (574, 575, 599, 600)] == \
        [0.0, 1.0, 1.0, 0.0]
    plain = NerfFusion(NerfFusionConfig(buffer=2, height=H, width=W),
                       seed=0, device="cpu")
    assert plain._schedule(700) == (0.0, 1.0, 1.0)


@pytest.mark.parametrize("start", ["zero", "random"])
def test_refined_step_matches_jax(start):
    """One pose-only step of ``optimize_extrinsics`` on JAX's draws, from
    zero deltas (where se3.exp takes its small-angle branch) and from
    random ones: the loss within 2e-2 relative (the bf16 field, as in
    test_fuse_and_train_step_match); the pose gradient (JAX's: Adam's
    first moment over 1 - b1) within 10% of its largest entry and aligned
    (cosine > 0.99), finite, view 0's pinned to 0; the deltas' first Adam
    step, -lr * g / (|g| + eps), within 1e-3 lr wherever |g| exceeds a
    fifth of the largest (elsewhere the sign may differ); the field's
    parameters keep their bits."""
    kw = dict(optimize_extrinsics=True, extrinsics_start=0,
              extrinsics_period=1, extrinsics_pose_iters=1)
    jf, tf = _pair(**kw)
    d0 = np.zeros((N_VIEWS + 2, 6), np.float32)
    if start == "random":
        d0 = (np.random.RandomState(9).randn(N_VIEWS + 2, 6) * 0.01) \
            .astype(np.float32)
    with torch.no_grad():
        tf.pose_deltas.copy_(torch.from_numpy(d0))
    field0 = [p.detach().clone() for p in tf.field.parameters()]
    key = jax.random.PRNGKey(21)
    assert _jax_schedule(jf, 0) == tf._schedule(0) == (1.0, 0.0, 1.0)
    _, dj, _, pose_state, loss_j, _, _ = jf._step_body(
        jf.params, jnp.asarray(d0), jf.opt_state, jf.pose_opt_state,
        jf.train_set, key, 1.0, 0.0)
    loss_t = tf.train_step(_draws(jf, key))
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=2e-2)
    gj = _np(pose_state[0].mu) / 0.1
    gt = _np(tf.pose_deltas.grad)
    assert np.isfinite(gt).all() and (gt[0] == 0).all() and (gj[0] == 0).all()
    np.testing.assert_allclose(gt, gj, rtol=0, atol=0.1 * np.abs(gj).max())
    assert (gt * gj).sum() / np.sqrt((gt * gt).sum() * (gj * gj).sum()) \
        > 0.99
    lr = tf.cfg.extrinsics_lr
    big = np.abs(gj) > 0.2 * np.abs(gj).max()
    step_t = _np(tf.pose_deltas) - d0
    step_j = _np(dj) - d0
    assert big.sum() >= 4
    np.testing.assert_allclose(step_t[big], step_j[big], rtol=0,
                               atol=1e-3 * lr)
    np.testing.assert_allclose(np.abs(step_t[big]), lr, rtol=1e-3)
    assert (step_t[0] == 0).all()
    assert all(torch.equal(a, b) for a, b in zip(tf.field.parameters(),
                                                 field0))


def test_adam_state_across_a_pose_only_phase_matches_jax():
    """Six steps with refinement from iteration 2 and 4-iteration cycles
    ending in 2 pose-only steps (iterations 4 and 5), each on JAX's draws
    and with the same schedule.  As in JAX, both Adams count every step: the
    field's moments keep moving in the pose-only steps while its
    parameters keep their bits, and the poses' Adam has counted the
    field steps' zero gradients, so its first real step, at count 5, is
    -lr * (1 - b1^5)^-1 / (1 - b2^5)^-1/2 * 0.1 / 0.001^1/2 = 0.5455 lr
    per component (a fresh Adam would step lr): the port's deltas agree
    with JAX's within 1e-3 lr wherever |g| exceeds a fifth of the
    largest."""
    kw = dict(optimize_extrinsics=True, extrinsics_start=2,
              extrinsics_period=4, extrinsics_pose_iters=2)
    jf, tf = _pair(**kw)
    params, deltas = jf.params, jf.pose_deltas
    opt_state, pose_state = jf.opt_state, jf.pose_opt_state
    keys = jax.random.split(jax.random.PRNGKey(5), 6)
    step = jax.jit(jf._step_body)
    snaps, gj4 = [], None
    for it in range(6):
        # (the schedule itself is held against JAX's above)
        pe, fe, dm = tf._schedule(it)
        assert (pe, fe, dm) == (float(it in (4, 5)), float(it not in (4, 5)),
                                1.0)
        d_before = _np(deltas)
        params, deltas, opt_state, pose_state, _, _, _ = step(
            params, deltas, opt_state, pose_state, jf.train_set, keys[it],
            pe, fe, dm)
        tf.iteration = it
        tf.train_step(_draws(jf, keys[it]))
        snaps.append(([p.detach().clone() for p in tf.field.parameters()],
                      [tf.opt.state[p]["exp_avg"].clone()
                       for p in tf.field.parameters()],
                      tf.pose_deltas.detach().clone()))
        if it == 4:
            gj4 = _np(pose_state[0].mu) / 0.1          # mu = 0.1 g
            step_j = _np(deltas) - d_before
    # step counts: JAX's optax counts, the port's Adam states
    assert int(opt_state[0].count) == int(pose_state[0].count) == 6
    assert all(int(tf.opt.state[p]["step"]) == 6
               for p in tf.field.parameters())
    assert int(tf.pose_opt.state[tf.pose_deltas]["step"]) == 6
    # the field froze in the pose-only steps, its moments did not
    for a, b in zip(snaps[3][0], snaps[5][0]):
        assert torch.equal(a, b)
    assert not all(torch.equal(a, b) for a, b in zip(snaps[3][1],
                                                     snaps[5][1]))
    assert not all(torch.equal(a, b) for a, b in zip(snaps[2][0],
                                                     snaps[3][0]))
    # the poses waited for iteration 4, and view 0 never moves
    assert (snaps[3][2] == 0).all() and (snaps[4][2] != 0).any()
    assert (snaps[5][2][0] == 0).all()
    lr = tf.cfg.extrinsics_lr
    step_t = _np(snaps[4][2])
    big = np.abs(gj4) > 0.2 * np.abs(gj4).max()
    assert big.sum() >= 4
    np.testing.assert_allclose(step_t[big], step_j[big], rtol=0,
                               atol=1e-3 * lr)
    np.testing.assert_allclose(np.abs(step_t[big]), 0.5455 * lr, rtol=1e-3)


def test_depth_annealing_scales_the_depth_terms():
    """The annealed step's loss is rgb + mult * depth terms, with the JAX
    step's multiplier: against JAX's _step_body with the same draws and
    depth_mult (2e-2 relative, the bf16 field)."""
    jf, tf = _pair(depth_anneal_iters=100, depth_anneal_floor=0.25)
    key = jax.random.PRNGKey(31)
    batch = _draws(jf, key)
    _, _, mult = tf._schedule(60)
    np.testing.assert_allclose(mult, _jax_schedule(jf, 60)[2], rtol=1e-6)
    assert 0.25 < mult < 1.0
    out_j = jf._step_body(jf.params, jf.pose_deltas, jf.opt_state,
                          jf.pose_opt_state, jf.train_set, key, 0.0, 1.0,
                          mult)
    with torch.no_grad():
        lt, lrgb, _ = tf.loss(batch, depth_mult=mult)
        l1, _, _ = tf.loss(batch)
    np.testing.assert_allclose(float(lt), float(out_j[4]), rtol=2e-2)
    rgb = tf.cfg.ngp.rgb_weight * float(lrgb)
    np.testing.assert_allclose(float(lt) - rgb, mult * (float(l1) - rgb),
                               rtol=1e-5)


def test_plain_render_matches_jax(monkeypatch):
    """``render_accel=False`` on a trained map (iteration > 0, where the
    default would take the occupancy-bounded path): the 128-sample render
    at a training view against the JAX package's, with the JAX draws
    (PRNGKey(0) for every block of rows) handed to the port: rgb within
    1e-2 (sRGB of a bf16 field), depth within 1e-2 normalized units, as
    test_sampling_and_render_match."""
    jf, tf = _pair(render_accel=False, render_rows_per_chunk=8)
    jf.iteration = tf.iteration = 5
    ngp = jf.cfg.ngp
    R = 8 * W
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    draws = tuple(torch.from_numpy(_np(x)) for x in (
        jax.random.uniform(k1, (R, ngp.n_uniform)),
        jax.random.normal(k2, (R, ngp.n_depth)),
        jax.random.uniform(k2, (R, ngp.n_depth))))
    monkeypatch.setattr(tnf, "draw_ray_samples",
                        lambda n, *a: (draws if n == R else None))
    monkeypatch.setattr(tnf, "ray_occ_interval", None)   # must not run
    rgb_j, d_j = jf._render_normalized(np.asarray(jf.train_set.c2w[1]),
                                       np.asarray(jf.train_set.intrinsics[1]))
    rgb_t, d_t = tf.render_training_view(1)
    assert rgb_t.shape == (H, W, 3) and d_t.shape == (H, W)
    np.testing.assert_allclose(_np(rgb_t), rgb_j, atol=1e-2)
    np.testing.assert_allclose(_np(d_t), d_j, atol=1e-2)


@pytest.mark.parametrize("dynamic,times", [
    (False, {1: 500.0}), (True, {}), (True, {1: 50.0}), (True, {1: 100.0}),
    (True, {1: 300.0}), (True, {2: 80.0}), (True, {1: 90.0, 2: 70.0}),
    (True, {4: 500.0})])
def test_pick_render_scale_matches_jax(dynamic, times):
    """The dynamic render resolution picks JAX's scale from the same
    measured times (extrapolated quadratically from the first measured
    scale where one is missing)."""
    kw = dict(buffer=2, height=H, width=W, dynamic_render_res=dynamic)
    jf = JaxFusion(JaxCfg(**kw), seed=0)
    tf = NerfFusion(NerfFusionConfig(**kw), seed=0, device="cpu")
    jf._render_ms, tf._render_ms = dict(times), dict(times)
    assert tf._pick_render_scale() == jf._pick_render_scale()


def test_scaled_render_and_its_timing():
    """A render at scale 2 covers the full frame with 2x2 blocks of equal
    pixels, and each render updates that scale's time (first value, then
    0.8 old + 0.2 new)."""
    _, tf = _pair(dynamic_render_res=True)
    ts = tf.train_set
    rgb, depth = tf._render_normalized(ts.c2w[0], ts.intrinsics[0], scale=2)
    assert rgb.shape == (H, W, 3) and depth.shape == (H, W)
    assert torch.equal(rgb[0::2, 0::2], rgb[1::2, 1::2])
    first = tf._render_ms[2]
    tf._render_normalized(ts.c2w[0], ts.intrinsics[0], scale=2)
    assert set(tf._render_ms) == {2}
    assert tf._render_ms[2] != first and tf._render_ms[2] > 0.0
