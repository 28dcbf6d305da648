"""Dense bundle adjustment of the port against the JAX package on one
synthetic graph: plan, linearization, assembly, the Schur solve (dense and
sparse), covariances and several Gauss-Newton iterations, all in f32.

Both plans carry the sparse-Schur interaction list; the dense tests strip
it from both, which selects the dense Schur path the frontend runs by
default (``FrontendConfig.schur_impl="dense"``).
"""
import numpy as np
import jax.numpy as jnp
import pytest
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


def _plans(ii, jj, sparse=False, kf0=0, kf1=N):
    jp = jdba.plan(ii, jj, kf0, kf1, E, P, K)
    tp = tdba.plan(ii, jj, kf0, kf1, E, P, K, device="cpu")
    for name in tp._fields:
        np.testing.assert_array_equal(_np(getattr(jp, name)),
                                      _np(getattr(tp, name)), err_msg=name)
    if not sparse:
        no_pairs = dict(pair_a=None, pair_b=None, pair_valid=None)
        jp, tp = jp._replace(**no_pairs), tp._replace(**no_pairs)
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


@pytest.mark.parametrize("kf0,kf1", [(0, N), (2, N - 1)])
def test_sparse_schur_matches_dense_and_jax(kf0, kf1):
    """The interaction-list Schur assembly against the dense contraction
    of the same system and against the JAX package's sparse path, on the
    full window and on one with edges and poses outside it.  The two sum
    the same products pair by pair instead of depth slot by depth slot:
    S has entries up to ~1e3, so rtol 1e-4 with atol 1e-5 of its maximum;
    the step inherits it as in the dense test."""
    ii, jj, poses, disps, intr, tgt, wts, eta, sens = _graph(2)
    jp, tp = _plans(ii, jj, sparse=True, kf0=kf0, kf1=kf1)
    assert float(tp.pair_valid.sum()) > 0
    J, T = _both([poses, disps, intr, tgt, wts, eta, sens])
    bt = tdba.linearize(*T[:5], tp)
    st = tdba.assemble(bt, tp, T[1], T[5], T[6])
    Q = 1.0 / st[3]
    _, _, fm = tdba._gauge_mask(st[0], st[1], tp)
    S, vs = tdba._sparse_schur(bt[2], Q, st[4], tp, fm, P, 6)
    Eh = st[2] * fm.reshape(P, 6)[:, None, :, None]
    EQ = Eh * Q[None, :, None, :]
    S_d = torch.einsum("pkdh,qkeh->pdqe", EQ, Eh).reshape(P * 6, P * 6)
    vs_d = torch.einsum("pkdh,kh->pd", EQ, st[4]).reshape(P * 6)
    assert float(S_d.abs().max()) > 1.0
    np.testing.assert_allclose(_np(S), _np(S_d), rtol=1e-4,
                               atol=1e-5 * float(S_d.abs().max()))
    np.testing.assert_allclose(_np(vs), _np(vs_d), rtol=1e-4,
                               atol=1e-5 * float(vs_d.abs().max()))

    bj = jdba.linearize(*J[:5], jp)
    sj = jdba.assemble(bj, jp, J[1], J[5], J[6])
    dxj, dzj, _, _ = jdba.solve_system(*sj, jp, E_blocks=bj[2])
    dxt, dzt, _, _ = tdba.solve_system(*st, tp, E_blocks=bt[2])
    dxd, dzd, _, _ = tdba.solve_system(
        *st, tp._replace(pair_a=None, pair_b=None, pair_valid=None))
    assert np.abs(_np(dxj)).max() > 1e-3
    for a, b in ((dxj, dxt), (dzj, dzt), (dxd, dxt), (dzd, dzt)):
        np.testing.assert_allclose(_np(b), _np(a), rtol=1e-3,
                                   atol=1e-4 * np.abs(_np(a)).max())


def test_dba_iterations_sparse_match():
    """Three Gauss-Newton steps through the sparse Schur path on both
    sides (a plan with its interaction list selects it): same tolerance
    as the dense iterations."""
    ii, jj, poses, disps, intr, tgt, wts, eta, sens = _graph(1)
    jp, tp = _plans(ii, jj, sparse=True)
    J, T = _both([poses, disps, intr, tgt, wts, eta, sens])
    res = jdba.dba_iterations(*J[:5], J[5], J[6], jp, iters=3,
                              compute_covariances=False)
    pt, dt = tdba.dba_iterations(*T[:5], T[5], T[6], tp, iters=3)
    assert np.abs(_np(res.poses) - poses).max() > 1e-3
    np.testing.assert_allclose(_np(pt), _np(res.poses), atol=1e-4, rtol=0)
    np.testing.assert_allclose(_np(dt), _np(res.disps), atol=1e-4,
                               rtol=1e-4)



def _two_shards(tp, tgt, wts):
    """The edges as two EdgeShards of half the slots each."""
    half = tp.ii.shape[0] // 2
    return [tdba.EdgeShard(tp._replace(**{
                k: getattr(tp, k)[sl] for k in
                ("ii", "jj", "pi", "pj", "kk", "edge_valid")}),
                tgt[sl], wts[sl])
            for sl in (slice(0, half), slice(half, None))]


@pytest.mark.parametrize("case", ["cpu", "shards", "requires_grad"])
def test_dba_iterations_eager_off_the_card(case):
    """Calls that cannot replay a CUDA graph (tensors on the CPU, the
    edges in shards, an input that requires grad) take the eager path:
    one more eager solve, no capture or replay, and the JAX package's
    steps to the tolerance of the iterations test above."""
    ii, jj, poses, disps, intr, tgt, wts, eta, sens = _graph(1)
    jp, tp = _plans(ii, jj)
    J, T = _both([poses, disps, intr, tgt, wts, eta, sens])
    kw = {}
    if case == "shards":
        kw["shards"] = _two_shards(tp, T[3], T[4])
    if case == "requires_grad":
        T[0] = T[0].clone().requires_grad_(True)
    before = dict(tdba.GRAPH_COUNTS)
    pt, dt = tdba.dba_iterations(*T[:5], T[5], T[6], tp, iters=3, **kw)
    assert tdba.GRAPH_COUNTS == dict(before, eager=before["eager"] + 1)
    assert pt.requires_grad == (case == "requires_grad")
    res = jdba.dba_iterations(*J[:5], J[5], J[6], jp, iters=3,
                              compute_covariances=False)
    np.testing.assert_allclose(_np(pt), _np(res.poses), atol=1e-4, rtol=0)
    np.testing.assert_allclose(_np(dt), _np(res.disps), atol=1e-4,
                               rtol=1e-4)

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
