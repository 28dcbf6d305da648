"""Dense bundle adjustment of the port against the JAX package on one
synthetic graph: plan, linearization, assembly, the dense Schur solve,
covariances and several Gauss-Newton iterations, all in f32.

The JAX plan is used without its sparse-Schur interaction list, which
selects the dense Schur path the frontend runs by default
(``FrontendConfig.schur_impl="dense"``).
"""
import numpy as np
import jax.numpy as jnp
import torch

from nerf_slam_tpu.geometry import camera as jcam
from nerf_slam_tpu.geometry import se3 as jse3
from nerf_slam_tpu.solver import dba as jdba
from nerf_slam_tpu_torch.solver import dba as tdba

torch.backends.cuda.matmul.allow_tf32 = False

N, h, w = 6, 6, 8
E, P, K = 24, 8, 8


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _graph(seed=0):
    """GT trajectory + depths, flow targets from GT with pixel noise, and
    a perturbed starting point."""
    rng = np.random.RandomState(seed)
    xi = np.zeros((N, 6), np.float32)
    xi[:, 0] = np.arange(N) * 0.08
    xi[1:, :] += rng.randn(N - 1, 6).astype(np.float32) * 0.02
    gt = np.asarray(jse3.exp(jnp.asarray(xi)))
    disps_gt = rng.uniform(0.5, 1.5, (N, h, w)).astype(np.float32)
    intr = np.tile(np.array([[7.0, 7.0, 4.0, 3.0]], np.float32), (N, 1))
    ii, jj = [], []
    for i in range(N):
        for j in range(N):
            if i != j and abs(i - j) <= 2:
                ii.append(i)
                jj.append(j)
    ii, jj = np.array(ii), np.array(jj)
    n = ii.shape[0]
    tgt, _, _ = jcam.projective_transform(
        jnp.asarray(gt), jnp.asarray(disps_gt), jnp.asarray(intr),
        jnp.asarray(ii), jnp.asarray(jj))
    targets = np.zeros((E, h, w, 2), np.float32)
    targets[:n] = np.asarray(tgt) + rng.randn(n, h, w, 2) * 0.05
    weights = np.zeros((E, h, w, 2), np.float32)
    weights[:n] = rng.uniform(0.3, 1.0, (n, h, w, 2))
    pert = np.concatenate([rng.randn(N, 3) * 0.02, rng.randn(N, 3) * 0.01],
                          -1).astype(np.float32)
    pert[0] = 0.0
    poses0 = np.asarray(jse3.retr(jnp.asarray(gt), jnp.asarray(pert)))
    disps0 = (disps_gt * rng.uniform(0.8, 1.2, (N, h, w))).astype(
        np.float32)
    eta = rng.uniform(1e-3, 1e-2, (K, h, w)).astype(np.float32)
    sens = np.zeros((K, h, w), np.float32)
    return ii, jj, poses0, disps0, intr, targets, weights, eta, sens


def _plans(ii, jj):
    jp = jdba.plan(ii, jj, 0, N, E, P, K)._replace(
        pair_a=None, pair_b=None, pair_valid=None)
    tp = tdba.plan(ii, jj, 0, N, E, P, K, device="cpu")
    for name in tp._fields:
        np.testing.assert_array_equal(_np(getattr(jp, name)),
                                      _np(getattr(tp, name)), err_msg=name)
    return jp, tp


def test_compute_pairs_matches():
    """The sparse-Schur interaction list equals the JAX package's, on the
    window plan and on one with edges outside the window (exact: integer
    bookkeeping)."""
    ii, jj = _graph()[:2]
    for kf0, kf1 in ((0, N), (2, N - 1)):
        jp = jdba.plan(ii, jj, kf0, kf1, E, P, K)
        args = [np.asarray(jp.pi), np.asarray(jp.pj), np.asarray(jp.kk),
                np.asarray(jp.edge_valid) > 0]
        for got, want in zip(tdba.compute_pairs(*args),
                             (jp.pair_a, jp.pair_b, jp.pair_valid)):
            np.testing.assert_array_equal(got, np.asarray(want))
        assert np.asarray(jp.pair_valid).sum() > 0


def _both(arrs):
    return [jnp.asarray(a) for a in arrs], [torch.from_numpy(a) for a in arrs]


def test_plan_linearize_assemble_solve_covariances_match():
    """One linearization and solve: the assembled system sums f32 blocks
    of magnitude up to ~1e3 in different orders, so it agrees to
    rtol 1e-4; the step and the covariances inherit that (rtol 1e-3, the
    system's condition number amplifying the assembly's rounding)."""
    ii, jj, poses, disps, intr, tgt, wts, eta, sens = _graph()
    jp, tp = _plans(ii, jj)
    (J_po, J_d, J_in, J_t, J_w, J_eta, J_s), \
        (T_po, T_d, T_in, T_t, T_w, T_eta, T_s) = _both(
            [poses, disps, intr, tgt, wts, eta, sens])
    bj = jdba.linearize(J_po, J_d, J_in, J_t, J_w, jp)
    bt = tdba.linearize(T_po, T_d, T_in, T_t, T_w, tp)
    for gj, gt in zip(bj, bt):
        for a, b in zip(gj, gt):
            np.testing.assert_allclose(_np(b), _np(a), rtol=1e-4,
                                       atol=1e-5 * np.abs(_np(a)).max())
    sj = jdba.assemble(bj, jp, J_d, J_eta, J_s)
    st = tdba.assemble(bt, tp, T_d, T_eta, T_s)
    for a, b in zip(sj, st):
        np.testing.assert_allclose(_np(b), _np(a), rtol=1e-4,
                                   atol=1e-5 * np.abs(_np(a)).max())
    dxj, dzj, Lj, Qj = jdba.solve_system(*sj, jp)
    dxt, dzt, Lt, Qt = tdba.solve_system(*st, tp)
    assert np.abs(_np(dxj)).max() > 1e-3          # a real step
    for a, b in ((dxj, dxt), (dzj, dzt), (Lj, Lt), (Qj, Qt)):
        np.testing.assert_allclose(_np(b), _np(a), rtol=1e-3,
                                   atol=1e-4 * np.abs(_np(a)).max())
    pcj, zcj = jdba.covariances(Lj, sj[2], Qj, jp)
    pct, zct = tdba.covariances(Lt, st[2], Qt, tp)
    np.testing.assert_allclose(_np(pct), _np(pcj), rtol=1e-3,
                               atol=1e-4 * np.abs(_np(pcj)).max())
    np.testing.assert_allclose(_np(zct), _np(zcj), rtol=1e-3, atol=0)


def test_dba_iterations_match():
    """Three relinearized Gauss-Newton steps, then the covariances of the
    final state: poses and inverse depths agree to 1e-4 (the per-step
    rounding of the test above, carried through three steps)."""
    ii, jj, poses, disps, intr, tgt, wts, eta, sens = _graph(1)
    jp, tp = _plans(ii, jj)
    J, T = _both([poses, disps, intr, tgt, wts, eta, sens])
    res = jdba.dba_iterations(*J[:5], J[5], J[6], jp, iters=3)
    pt, dt = tdba.dba_iterations(*T[:5], T[5], T[6], tp, iters=3)
    assert np.abs(_np(res.poses) - poses).max() > 1e-3   # poses moved
    np.testing.assert_allclose(_np(pt), _np(res.poses), atol=1e-4, rtol=0)
    np.testing.assert_allclose(_np(dt), _np(res.disps), atol=1e-4,
                               rtol=1e-4)
    blocks = tdba.linearize(pt, dt, T[2], T[3], T[4], tp)
    sys_t = tdba.assemble(blocks, tp, dt, T[5], T[6])
    _, _, L, Q = tdba.solve_system(*sys_t, tp)
    pose_cov, z_cov = tdba.covariances(L, sys_t[2], Q, tp)
    np.testing.assert_allclose(_np(pose_cov), _np(res.pose_cov), rtol=1e-2,
                               atol=1e-3 * np.abs(_np(res.pose_cov)).max())
    np.testing.assert_allclose(_np(z_cov).reshape(K, h, w),
                               _np(res.z_cov), rtol=1e-2, atol=0)


def test_kx_scatter_drops_padded_slots():
    buf = torch.arange(5.0)
    out = tdba.kx_scatter(buf, torch.tensor([3, 0, 0]),
                          torch.tensor([1.0, 1.0, 0.0]),
                          torch.tensor([30.0, 10.0, 99.0]))
    np.testing.assert_array_equal(out.numpy(), [10.0, 1, 2, 30, 4])
    want = jdba.kx_scatter(jnp.arange(5.0), jnp.array([3, 0, 0]),
                           jnp.array([1.0, 1.0, 0.0]),
                           jnp.array([30.0, 10.0, 99.0]))
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))
