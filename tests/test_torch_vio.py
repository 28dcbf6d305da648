"""The port's visual-inertial chain against the JAX package on the CPU:
factor residuals and autodiff Jacobians, the dense and incremental
solvers, IMU preintegration, ``VioSLAM`` with a stub visual frontend, and
the ``slam_demo`` CLI's ``--vio``.

The same inputs, made from a numpy seed, go through the JAX function and
its port.  Residuals and Jacobians are f32 on both sides (x64 is off in
the JAX package), so they agree to f32 rounding; the preintegration is
host float64 on both sides."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_slam_tpu.datasets.base import ImuCalibration as JCalib
from nerf_slam_tpu.datasets.synthetic import (SyntheticConfig as JSynCfg,
                                              SyntheticDataset as JSyn)
from nerf_slam_tpu.geometry import se3 as jse3
from nerf_slam_tpu.slam import imu as jimu
from nerf_slam_tpu.slam.meta_slam import VioSLAM as JVioSLAM
from nerf_slam_tpu.solver import factor_graph as jfg
from nerf_slam_tpu.solver import nonlinear as jnl
from nerf_slam_tpu_torch.cli import slam_demo
from nerf_slam_tpu_torch.datasets import SyntheticConfig, SyntheticDataset
from nerf_slam_tpu_torch.datasets.base import ImuCalibration
from nerf_slam_tpu_torch.geometry import se3
from nerf_slam_tpu_torch.pipeline import (DataModule, EvalSink, SlamModule,
                                          connect, run_sequential)
from nerf_slam_tpu_torch.slam import imu as timu
from nerf_slam_tpu_torch.slam.meta_slam import VioSLAM
from nerf_slam_tpu_torch.solver import factor_graph as tfg
from nerf_slam_tpu_torch.solver import nonlinear as tnl
from nerf_slam_tpu_torch.solver import schur as tschur

# f32 residuals and Jacobians: equal up to f32 rounding of O(1) values
TOL = 1e-5
# host float64 on both sides
TOL_F64 = 1e-9
# an f32 quaternion: one ulp of a unit value
TOL_Q = 1.2e-7


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _pose_chain(n, seed, scale=0.3):
    """n f32 poses, each a random step from the last (host numpy)."""
    rng = np.random.RandomState(seed)
    poses = [np.asarray(jse3.identity())]
    for _ in range(1, n):
        xi = jnp.asarray(scale * rng.randn(6), jnp.float32)
        poses.append(np.asarray(jse3.mul(jse3.exp(xi), poses[-1])))
    return poses


def _perturb(pose, rng, s):
    return np.asarray(jse3.retr(jnp.asarray(pose),
                                jnp.asarray(s * rng.randn(6), jnp.float32)))


def _pose_graph(fg, poses):
    """The pose graph of tests/test_factor_graph.py: a prior, the chain's
    between factors and one loop closure, in package ``fg``."""
    g = fg.FactorGraph()
    g.add(fg.PriorFactor(fg.Key("x", 0), poses[0], fg.SE3_VAR, sigma=1e-3))
    rel = [(i, i + 1) for i in range(len(poses) - 1)] + \
        [(0, len(poses) - 1)]
    for i, j in rel:
        meas = np.asarray(jse3.mul(jnp.asarray(poses[j]),
                                   jse3.inv(jnp.asarray(poses[i]))))
        g.add(fg.BetweenFactorSE3(fg.Key("x", i), fg.Key("x", j), meas,
                                  sigma=0.01))
    return g


def _vars(fg, values):
    v = fg.Variables()
    for i, p in enumerate(values):
        v.insert(fg.Key("x", i), p, fg.SE3_VAR)
    return v


def _assert_vars_close(jv, tv, keys, tol=TOL):
    for k in keys:
        np.testing.assert_allclose(
            _np(tv.at(tfg.Key(k.name, k.idx))), np.asarray(jv.at(k)),
            rtol=0, atol=tol, err_msg=repr(k))


# -- factors -----------------------------------------------------------------

def _imu_pim(pkg, calib):
    pim = pkg.PreintegratedImuMeasurements(calib)
    for _ in range(50):
        pim.integrate(np.array([0.8, 0.2, 9.81]),
                      np.array([0.1, -0.2, 0.3]), 0.005)
    return pim


def _factor_case(kind, rng):
    """(make(pkg, fg) -> factor, [(key name, index, value, vtype)])"""
    pa, pb = _pose_chain(2, 11)
    pa, pb = _perturb(pa, rng, 0.05), _perturb(pb, rng, 0.05)
    if kind == "prior_se3":
        prior = _perturb(pa, rng, 0.2)
        return (lambda pkg, fg: fg.PriorFactor(fg.Key("x", 0), prior,
                                               fg.SE3_VAR, sigma=0.1),
                [("x", 0, pa, "se3")])
    if kind == "prior_vec":
        prior, x = rng.randn(3), rng.randn(3)
        return (lambda pkg, fg: fg.PriorFactor(fg.Key("v", 0), prior,
                                               fg.VECTOR(3), sigma=0.5),
                [("v", 0, x, 3)])
    if kind == "between":
        meas = _perturb(np.asarray(jse3.mul(jnp.asarray(pb), jse3.inv(
            jnp.asarray(pa)))), rng, 0.1)
        return (lambda pkg, fg: fg.BetweenFactorSE3(
            fg.Key("x", 0), fg.Key("x", 1), meas, sigma=0.2),
            [("x", 0, pa, "se3"), ("x", 1, pb, "se3")])
    if kind == "imu":
        va, vb = rng.randn(3), rng.randn(3)
        return (lambda pkg, fg: pkg.ImuFactor(
            fg.Key("x", 0), fg.Key("v", 0), fg.Key("x", 1), fg.Key("v", 1),
            _imu_pim(pkg, (JCalib if pkg is jimu else ImuCalibration)())),
            [("x", 0, pa, "se3"), ("v", 0, va, 3), ("x", 1, pb, "se3"),
             ("v", 1, vb, 3)])
    ba, bb = rng.randn(6), rng.randn(6)
    return (lambda pkg, fg: pkg.BiasBetweenFactor(
        fg.Key("b", 0), fg.Key("b", 1), 0.25,
        (JCalib if pkg is jimu else ImuCalibration)()),
        [("b", 0, ba, 6), ("b", 1, bb, 6)])


@pytest.mark.parametrize("loss", ["trivial", "cauchy", "geman_mcclure"])
@pytest.mark.parametrize("kind", ["prior_se3", "prior_vec", "between",
                                  "imu", "bias_between"])
def test_factor_linearization_matches_jax(kind, loss):
    """r and every J of each factor type under each robust loss, scaled
    by the factor's sigma, within 1e-5 (absolute) of the JAX package's
    jacfwd."""
    build, values = _factor_case(kind, np.random.RandomState(3))
    out = {}
    for pkg, fg in ((jimu, jfg), (timu, tfg)):
        f = build(pkg, fg)
        f.loss = {"trivial": fg.TrivialLoss(), "cauchy": fg.CauchyLoss(0.7),
                  "geman_mcclure": fg.GemanMcClureLoss(0.7)}[loss]
        v = fg.Variables()
        for name, idx, val, t in values:
            v.insert(fg.Key(name, idx), val,
                     fg.SE3_VAR if t == "se3" else fg.VECTOR(t))
        r, Js = f.linearize(v)
        # times sigma, the same float on both sides: the whitened values
        # reach 1e4 (the IMU factor's sigma), beyond f32's 1e-5 absolute
        out[fg] = (_np(r) * f.sigma, [_np(J) * f.sigma for J in Js])
    (rj, Jj), (rt, Jt) = out[jfg], out[tfg]
    assert np.abs(rj).max() > 1e-2            # the case is not trivial
    np.testing.assert_allclose(rt, rj, rtol=0, atol=TOL)
    assert len(Jt) == len(Jj)
    for a, b in zip(Jt, Jj):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL)


def test_linearize_dense_matches_jax():
    """(H, b) of the pose graph at a perturbed point: f32 on both sides,
    within 1e-5 of the largest entry (H scales with sigma^-2 = 1e6)."""
    poses = _pose_chain(5, 0)
    rng = np.random.RandomState(2)
    x = [p if i == 0 else _perturb(p, rng, 0.05) for i, p in
         enumerate(poses)]
    Hj, bj = _pose_graph(jfg, poses).linearize_dense(_vars(jfg, x))
    Ht, bt = _pose_graph(tfg, poses).linearize_dense(_vars(tfg, x))
    Hj, bj = np.asarray(Hj), np.asarray(bj)
    np.testing.assert_allclose(_np(Ht), Hj, rtol=0,
                               atol=TOL * np.abs(Hj).max())
    np.testing.assert_allclose(_np(bt), bj, rtol=0,
                               atol=TOL * np.abs(bj).max())


@pytest.mark.parametrize("solver", ["gauss_newton", "lm"])
def test_batch_solvers_match_jax(solver):
    """GaussNewton and LevenbergMarquardt from the same start: the same
    solution within 1e-5, both at the truth (error below 1e-6)."""
    poses = _pose_chain(5 if solver == "gauss_newton" else 4, 3)
    rng = np.random.RandomState(4)
    x = [p if i == 0 else _perturb(p, rng, 0.05) for i, p in
         enumerate(poses)]
    mk = {"gauss_newton": lambda nl: nl.GaussNewton(max_iters=15),
          "lm": lambda nl: nl.LevenbergMarquardt()}[solver]
    rj = mk(jnl).solve(_pose_graph(jfg, poses), _vars(jfg, x))
    rt = mk(tnl).solve(_pose_graph(tfg, poses), _vars(tfg, x))
    assert rt.error < 1e-6 and rj.error < 1e-6, (rt.error, rj.error)
    assert rt.iterations == rj.iterations
    _assert_vars_close(rj.variables, rt.variables, rj.variables.keys())


def test_robust_loss_fit_matches_jax():
    """The line fit with one outlier of tests/test_factor_graph.py under
    the Cauchy loss: the same (a, b) within 1e-5, and the outlier
    rejected (the fit near y = 2x + 1)."""
    rng = np.random.RandomState(0)
    xs = np.linspace(0, 1, 20)
    ys = 2.0 * xs + 1.0 + 0.01 * rng.randn(20)
    ys[7] += 5.0

    def fit(fg, nl, stack):
        class PointFactor(fg.Factor):
            def __init__(self, key, x, y, loss=None):
                super().__init__([key], loss, sigma=0.1)
                self.x, self.y = x, y

            def residual(self, ab):
                return stack([ab[0] * self.x + ab[1] - self.y])

        g = fg.FactorGraph()
        for x, y in zip(xs, ys):
            g.add(PointFactor(fg.Key("ab"), float(x), float(y),
                              loss=fg.CauchyLoss(k=0.5)))
        v = fg.Variables().insert(fg.Key("ab"), np.zeros(2), fg.VECTOR(2))
        return _np(nl.GaussNewton(max_iters=20).solve(g, v).variables.at(
            fg.Key("ab")))

    ab_j = fit(jfg, jnl, jnp.stack)
    ab_t = fit(tfg, tnl, torch.stack)
    np.testing.assert_allclose(ab_t, ab_j, rtol=0, atol=TOL)
    assert abs(ab_t[0] - 2.0) + abs(ab_t[1] - 1.0) < 0.1, ab_t


def _incremental(fg, nl, poses, start):
    solver = nl.IncrementalSolver()
    g = fg.FactorGraph()
    g.add(fg.PriorFactor(fg.Key("x", 0), poses[0], fg.SE3_VAR, sigma=1e-3))
    solver.update(g, fg.Variables().insert(fg.Key("x", 0), poses[0],
                                           fg.SE3_VAR))
    iters = []
    for i in range(1, len(poses)):
        meas = np.asarray(jse3.mul(jnp.asarray(poses[i]),
                                   jse3.inv(jnp.asarray(poses[i - 1]))))
        g.add(fg.BetweenFactorSE3(fg.Key("x", i - 1), fg.Key("x", i), meas,
                                  sigma=0.01))
        res = solver.update(g, fg.Variables().insert(fg.Key("x", i),
                                                     start[i], fg.SE3_VAR))
        iters.append(res.iterations)
    return solver, res, iters


def test_incremental_solver_matches_jax():
    """The growing chain of tests/test_factor_graph.py through the
    incremental solver: every estimate within 1e-5 of JAX's, the same
    relinearization and reuse counts, and the JAX tests' own checks."""
    poses = _pose_chain(6, 7)
    start = [np.asarray(jse3.retr(jnp.asarray(p), 0.05 * jnp.ones(6)))
             for p in poses]
    sj, rj, ij = _incremental(jfg, jnl, poses, start)
    st, rt, it = _incremental(tfg, tnl, poses, start)
    assert st.stats == sj.stats, (st.stats, sj.stats)
    assert it == ij
    assert st.stats["reused"] > st.stats["relinearized"], st.stats
    _assert_vars_close(rj.variables, rt.variables, rj.variables.keys())
    for i, p in enumerate(poses):
        err = se3.log(se3.mul(rt.variables.at(tfg.Key("x", i)),
                              se3.inv(torch.as_tensor(p))))
        assert float(err.abs().max()) < 1e-3, (i, err)


def test_incremental_fetches_once_per_inner_iteration(monkeypatch):
    """The fresh linearizations of an inner iteration come back in one
    transfer (one ``_fetch`` call), however many factors are fresh."""
    calls = []
    fetch = tnl.IncrementalSolver._fetch
    monkeypatch.setattr(tnl.IncrementalSolver, "_fetch", staticmethod(
        lambda pending: calls.append(len(pending)) or fetch(pending)))
    poses = _pose_chain(4, 1)
    solver = tnl.IncrementalSolver(inner_iters=2)
    solver.update(_pose_graph(tfg, poses), _vars(tfg, poses))
    assert calls[0] == len(poses) + 1 and len(calls) <= 2, calls


@pytest.mark.parametrize("weighted", [False, True])
def test_linear_ls_matches_jax(weighted):
    rng = np.random.RandomState(0)
    A = rng.randn(3, 30, 4).astype(np.float32)
    x_true = rng.randn(3, 4).astype(np.float32)
    b = np.einsum("bij,bj->bi", A, x_true)
    w = None
    if weighted:
        b[:, 0] += 100.0
        w = np.ones((3, 30), np.float32)
        w[:, 0] = 0.0
    xj = jnl.LinearLS.solve_cholesky(jnp.asarray(A), jnp.asarray(b),
                                     None if w is None else jnp.asarray(w))
    xt = tnl.LinearLS.solve_cholesky(torch.as_tensor(A), torch.as_tensor(b),
                                     None if w is None else
                                     torch.as_tensor(w))
    np.testing.assert_allclose(_np(xt), np.asarray(xj), rtol=0, atol=1e-4)
    np.testing.assert_allclose(_np(xt), x_true, rtol=0, atol=1e-4)


def test_cholesky_failure_is_nan_as_in_jax():
    """A matrix that is not positive definite: JAX's cho_factor gives NaN,
    and so does the port's solve (no exception)."""
    from jax.scipy.linalg import cho_factor, cho_solve
    H = np.diag([1.0, -1.0, 2.0]).astype(np.float32)
    b = np.ones(3, np.float32)
    xj = cho_solve(cho_factor(jnp.asarray(H)), jnp.asarray(b))
    xt = tschur.cho_solve(torch.as_tensor(H), torch.as_tensor(b))
    assert not np.isfinite(np.asarray(xj)).all()
    assert torch.isnan(xt).all()


def test_batched_graph_error_equals_the_factor_sum():
    """The graph's error evaluates the factors of each batchable class in
    one residual call: it equals the sum over factors evaluated one by
    one (the JAX package's loop) within f32 rounding, factors of a class
    without ``stacked`` included."""
    n = 6
    ds = JSyn(JSynCfg(n_frames=n, height=24, width=32, imu=True,
                      deg_per_frame=3.0))
    slam = _run_vio(timu, VioSLAM, ImuCalibration(), ds, n, device="cpu")
    graph, est = slam.graph, slam.backend.estimate

    class Square(tfg.Factor):
        def residual(self, v):
            return v * v

    graph.add(Square([tfg.Key("v", 2)], sigma=0.3))
    one_by_one = sum(float(torch.sum((f.residual(*[est.at(k) for k in
                                                   f.keys]) / f.sigma) ** 2))
                     for f in graph.factors.values())
    assert len({f.batch_key() for f in graph.factors.values()}) == 6
    np.testing.assert_allclose(graph.error(est), one_by_one, rtol=1e-6)


# -- IMU ---------------------------------------------------------------------

def _imu_rows(n=6):
    ds = JSyn(JSynCfg(n_frames=n, height=24, width=32, imu=True,
                      deg_per_frame=3.0))
    return ds, [ds[k]["imu_t0_t1"] for k in range(1, n)]


def test_simulated_imu_matches_jax():
    """The port's synthetic IMU rows and velocities equal the JAX
    dataset's (the simulation is host float64 on both sides)."""
    jds, rows = _imu_rows()
    tds = SyntheticDataset(SyntheticConfig(n_frames=6, height=24, width=32,
                                           imu=True, deg_per_frame=3.0))
    for k in range(1, 6):
        np.testing.assert_array_equal(tds[k]["imu_t0_t1"], rows[k - 1])
    np.testing.assert_array_equal(tds.velocity_at(0.1), jds.velocity_at(0.1))


def test_preintegration_matches_jax():
    """dR, dv, dp, dt, cov and predict's position and velocity over the
    simulated IMU windows within 1e-9 (host float64); predict's quaternion
    within one f32 ulp (its rotation conversions are f32 on both
    sides)."""
    jds, rows = _imu_rows()
    pose0 = np.asarray(jse3.from_matrix(np.asarray(jds.poses[0],
                                                   np.float64)))
    sj = jimu.NavState(pose=pose0, vel=jds.velocity_at(0.0))
    bias = dict(acc=np.array([0.01, -0.02, 0.005]),
                gyr=np.array([1e-3, 0.0, -2e-3]))
    for r in rows:
        pj = jimu.PreintegratedImuMeasurements(JCalib(), jimu.ImuBias(**bias))
        pt = timu.PreintegratedImuMeasurements(ImuCalibration(),
                                               timu.ImuBias(**bias))
        pj.integrate_batch(r)
        pt.integrate_batch(r)
        for name in ("dR", "dv", "dp", "cov"):
            np.testing.assert_allclose(getattr(pt, name), getattr(pj, name),
                                       rtol=0, atol=TOL_F64, err_msg=name)
        assert pt.dt == pj.dt
        # predict from the same state on both sides
        nj, nt = pj.predict(sj), pt.predict(timu.NavState(
            pose=sj.pose.copy(), vel=sj.vel.copy()))
        np.testing.assert_allclose(nt.pose[:3], nj.pose[:3], rtol=0,
                                   atol=TOL_F64)
        np.testing.assert_allclose(nt.vel, nj.vel, rtol=0, atol=TOL_F64)
        # the quaternion is f32 in both packages (matrix_to_quat in f32;
        # the norms' last bit differs): one f32 ulp of a unit value
        np.testing.assert_allclose(nt.pose[3:], nj.pose[3:], rtol=0,
                                   atol=TOL_Q)
        sj = nj


def _integrate(acc, gyr, n, dt, bias=None):
    pim = timu.PreintegratedImuMeasurements(
        ImuCalibration(n_gravity=np.array([0.0, 0.0, -9.81])), bias)
    for _ in range(n):
        pim.integrate(np.asarray(acc), np.asarray(gyr), dt)
    return pim


_S0 = timu.NavState(pose=np.array([0, 0, 0, 0, 0, 0, 1.0]), vel=np.zeros(3))


@pytest.mark.parametrize("case", ["static", "accel", "rotation"])
def test_preintegration_analytic(case):
    """The analytic cases of tests/test_imu.py on the port: a static body
    stays put, 1 m/s^2 for 1 s gives p = 0.5 and v = 1, 90 deg/s about z
    for 1 s gives a quarter turn."""
    if case == "static":
        s1 = _integrate([0, 0, 9.81], np.zeros(3), 100, 0.01).predict(_S0)
        np.testing.assert_allclose(s1.pose[:3], 0.0, atol=1e-6)
        np.testing.assert_allclose(s1.vel, 0.0, atol=1e-6)
    elif case == "accel":
        s1 = _integrate([1.0, 0, 9.81], np.zeros(3), 1000, 1e-3).predict(_S0)
        np.testing.assert_allclose(s1.pose[0], 0.5, atol=1e-3)
        np.testing.assert_allclose(s1.vel[0], 1.0, atol=1e-3)
    else:
        s1 = _integrate([0, 0, 9.81], [0, 0, np.pi / 2], 1000,
                        1e-3).predict(_S0)
        R = se3.quat_to_matrix(torch.as_tensor(s1.pose[3:7],
                                               dtype=torch.float32))
        np.testing.assert_allclose(_np(R), [[0, -1, 0], [1, 0, 0],
                                            [0, 0, 1.0]], atol=1e-3)


def test_imu_factor_zero_at_truth_and_bias_moves_prediction():
    pim = _integrate([0.5, 0, 9.81], np.zeros(3), 200, 0.005)
    s0 = timu.NavState(pose=_S0.pose, vel=np.array([0.2, 0, 0]))
    s1 = pim.predict(s0)
    f = timu.ImuFactor(tfg.Key("x", 0), tfg.Key("v", 0), tfg.Key("x", 1),
                       tfg.Key("v", 1), pim)
    r = f.residual(*[tfg.as_f32(a) for a in (s0.pose, s0.vel, s1.pose,
                                             s1.vel)])
    np.testing.assert_allclose(_np(r), 0.0, atol=1e-5)
    biased = _integrate([1.0, 0, 9.81], np.zeros(3), 100, 0.01,
                        timu.ImuBias(acc=np.array([0.5, 0, 0])))
    assert biased.dp[0] < _integrate([1.0, 0, 9.81], np.zeros(3), 100,
                                     0.01).dp[0]


def test_dead_reckoning():
    """tests/test_vio.py's dead-reckoning case on the port: the simulated
    IMU preintegrated frame by frame stays within 2 mm and 0.2 deg."""
    ds = SyntheticDataset(SyntheticConfig(n_frames=8, height=24, width=32,
                                          imu=True, deg_per_frame=3.0))
    state = timu.NavState(pose=_pose_vec(ds.poses[0]),
                          vel=ds.velocity_at(0.0))
    for k in range(1, 8):
        pim = timu.PreintegratedImuMeasurements(ImuCalibration())
        pim.integrate_batch(ds[k]["imu_t0_t1"])
        state = pim.predict(state)
        gt = _pose_vec(ds.poses[k])
        assert np.linalg.norm(state.pose[:3] - gt[:3]) < 2e-3, k
        assert abs(float(np.dot(state.pose[3:7], gt[3:7]))) > \
            np.cos(np.radians(0.2)), k


# -- VioSLAM -----------------------------------------------------------------

def _pose_vec(c2w):
    return se3.from_matrix(tfg.as_f32(c2w)).numpy()


class _StubVisualFrontend:
    """The stub of tests/test_vio.py: VioSLAM's contract without the
    tracker."""

    def __init__(self, n):
        self.n = n
        self.kf_idx = -1

    def __call__(self, k, packet):
        self.kf_idx = k
        return {"k": k, "is_last_frame": bool(packet.get("is_last_frame"))}

    def stop_condition(self):
        return self.kf_idx >= self.n - 1


def _run_vio(pkg, slam_cls, calib, ds, n, **kw):
    pose0 = np.asarray(jse3.from_matrix(np.asarray(ds.poses[0], np.float64)))
    inertial = pkg.PreIntegrationInertialFrontend(
        calib, pkg.NavState(pose=pose0, vel=ds.velocity_at(0.0)))
    slam = slam_cls(_StubVisualFrontend(n), inertial, **kw)
    for k in range(n):
        pkt = ds[k]
        pkt["k"] = k
        _, viz = slam(pkt)
        assert viz["k"] == k
    return slam


def test_vioslam_matches_jax():
    """tests/test_vio.py's VioSLAM run (8 frames, the stub frontend)
    through both packages: every x, v and b estimate within 1e-5, the
    same relinearized/reused counts, and the JAX test's own checks on the
    port's result."""
    n = 8
    ds = JSyn(JSynCfg(n_frames=n, height=24, width=32, imu=True,
                      deg_per_frame=3.0))
    sj = _run_vio(jimu, JVioSLAM, JCalib(), ds, n)
    st = _run_vio(timu, VioSLAM, ImuCalibration(), ds, n, device="cpu")
    assert st.backend.stats == sj.backend.stats, (st.backend.stats,
                                                  sj.backend.stats)
    keys = sj.backend.estimate.keys()
    assert len(keys) == 3 * n
    _assert_vars_close(sj.backend.estimate, st.backend.estimate, keys)
    est = st.backend.estimate
    for k in range(n):
        x = _np(est.at(tfg.Key("x", k)))
        assert np.linalg.norm(x[:3] - ds.poses[k][:3, 3]) < 5e-3, k
    v_last = _np(est.at(tfg.Key("v", n - 1)))
    assert np.linalg.norm(v_last - ds.velocity_at((n - 1) / ds.cfg.fps)) \
        < 0.05
    assert st.backend.stats["reused"] > 0


def test_imu_factor_corrects_bad_initial_guess():
    """tests/test_vio.py's corrupted initial guess (about 7 cm and a few
    degrees) through both packages: each pulls it back within 5 mm of the
    truth, and the two solutions agree within 1e-5."""
    ds = JSyn(JSynCfg(n_frames=3, height=24, width=32, imu=True,
                      deg_per_frame=3.0))
    pose0 = np.asarray(jse3.from_matrix(np.asarray(ds.poses[0], np.float64)))
    solved = []
    for pkg, fg, nl, calib in ((jimu, jfg, jnl, JCalib()),
                               (timu, tfg, tnl, ImuCalibration())):
        fe = pkg.PreIntegrationInertialFrontend(
            calib, pkg.NavState(pose=pose0, vel=ds.velocity_at(0.0)))
        backend, graph = nl.IncrementalSolver(), fg.FactorGraph()
        x0, g0 = fe({"k": 0})
        for f in g0.factors.values():
            graph.add(f)
        backend.update(graph, x0)
        x1, g1 = fe(ds[1])
        k1 = fg.Key("x", 1)
        t = x1._types[k1]
        delta = np.array([0.05, -0.05, 0.02, 0.03, 0.02, -0.03], np.float32)
        x1._vals[k1] = t.retract(x1.at(k1), jnp.asarray(delta)
                                 if fg is jfg else torch.as_tensor(delta))
        for f in g1.factors.values():
            graph.add(f)
        backend.update(graph, x1)
        solved.append(_np(backend.estimate.at(k1)))
        assert np.linalg.norm(solved[-1][:3] - ds.poses[1][:3, 3]) < 5e-3
    np.testing.assert_allclose(solved[1], solved[0], rtol=0, atol=TOL)


def test_vioslam_production_trajectory():
    """The bench cell's trajectory (30 frames, a full orbit, 12 deg a
    frame) at 24x32, since the IMU does not depend on the image size:
    every solved position within 10 cm of the ground truth (the inertial
    chain alone drifts: the JAX package's gives 7.80 cm here, within 1e-6
    m of the port's, scripts/compare_vio_trajectory.py), and the backend
    incremental.  Prints the largest error."""
    n = 30
    ds = SyntheticDataset(SyntheticConfig(n_frames=n, height=24, width=32,
                                          imu=True))
    slam = _run_vio(timu, VioSLAM, ImuCalibration(), ds, n, device="cpu")
    est = slam.backend.estimate
    err = max(np.linalg.norm(_np(est.at(tfg.Key("x", k)))[:3]
                             - ds.poses[k][:3, 3]) for k in range(n))
    print(f"largest VIO position error over {n} frames: {err:.6e} m")
    assert err < 0.1, err
    assert slam.backend.stats["reused"] > 0


# -- pipeline and CLI --------------------------------------------------------

def test_slam_module_drives_vioslam():
    """SlamModule calls a SLAM object with the packet and passes on the
    tracker's output, as the JAX stage does."""
    n = 4
    ds = SyntheticDataset(SyntheticConfig(n_frames=n, height=24, width=32,
                                          imu=True, deg_per_frame=3.0))
    inertial = timu.PreIntegrationInertialFrontend(
        ImuCalibration(), timu.NavState(pose=_pose_vec(ds.poses[0]),
                                        vel=ds.velocity_at(0.0)))
    slam = VioSLAM(_StubVisualFrontend(n), inertial, device="cpu")
    data, slam_m, sink = DataModule(ds), SlamModule(slam), EvalSink()
    connect(data, slam_m, "data")
    connect(slam_m, sink, "slam")
    run_sequential([data, slam_m, sink])
    assert slam.inertial_frontend.k == n - 1
    assert len(slam.backend.estimate.keys()) == 3 * n


def test_cli_vio_leaves_the_tracker_untouched(capsys, monkeypatch):
    """``slam_demo --vio --device cpu`` at a small size: one inertial
    state a frame, and the tracker's keyframes, poses and depths equal,
    bit for bit, those of the same run without ``--vio`` (the inertial
    graph does not feed back into the tracker, in JAX as in the port)."""
    import os
    weights = os.path.join(os.path.dirname(__file__), "..",
                           "weights_synthetic.npz")
    argv = ["--device", "cpu", "--height", "48", "--width", "64",
            "--n_frames", "10", "--buffer", "12", "--weights", weights,
            "--fusion", "none"]
    built = []
    build = slam_demo.build_frontend
    monkeypatch.setattr(slam_demo, "build_frontend",
                        lambda *a: built.append(build(*a)) or built[-1])
    results = []
    for extra in (["--vio"], []):
        results.append(slam_demo.run(slam_demo.parse_args(argv + extra)))
        printed = json.loads(capsys.readouterr().out.strip()
                             .splitlines()[-1])
        assert set(printed) == set(results[-1])
    vio, plain = results
    assert vio["vio_states"] == 10 and vio["vio_relinearized"] > 0
    assert "vio_states" not in plain
    a, b = built
    n = a.kf_idx + 1
    assert n == b.kf_idx + 1 and n > 3
    for name in ("timestamps", "cam_T_world", "idepths"):
        assert torch.equal(getattr(a.state, name)[:n],
                           getattr(b.state, name)[:n]), name
