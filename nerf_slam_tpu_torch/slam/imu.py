"""IMU preintegration and inertial factors (host numpy + PyTorch).

On-manifold preintegration of gyro and accelerometer rows between frames
(Forster et al., TRO'17): a delta (dR, dv, dp, dt) with a first-order
covariance, a NavState predictor, and the preintegrated IMU and bias
random-walk factors of the factor-graph layer.  The integration is host
float64; the predictor's rotation conversions run in f32, as in the JAX
package.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from ..datasets.base import ImuCalibration
from ..geometry import se3
from ..solver.factor_graph import (SE3_VAR, VECTOR, Factor, FactorGraph,
                                   Key, PriorFactor, Variables, as_f32)


@dataclass
class NavState:
    """world_T_body pose (7,) + velocity (3,)."""
    pose: np.ndarray
    vel: np.ndarray


@dataclass
class ImuBias:
    acc: np.ndarray = field(default_factory=lambda: np.zeros(3))
    gyr: np.ndarray = field(default_factory=lambda: np.zeros(3))


def _exp_so3(phi: np.ndarray) -> np.ndarray:
    """so(3) -> rotation matrix (host numpy)."""
    th = np.linalg.norm(phi)
    K = np.array([[0, -phi[2], phi[1]],
                  [phi[2], 0, -phi[0]],
                  [-phi[1], phi[0], 0]])
    if th < 1e-8:
        return np.eye(3) + K
    return (np.eye(3) + np.sin(th) / th * K
            + (1 - np.cos(th)) / th ** 2 * (K @ K))


class PreintegratedImuMeasurements:
    """On-manifold preintegrated delta between two frames.

    State: dR (3,3), dv (3,), dp (3,), dt, and a 9x9 covariance over
    [dtheta, dv, dp] propagated with the first-order model.
    """

    def __init__(self, calib: ImuCalibration,
                 bias: Optional[ImuBias] = None):
        self.calib = calib
        self.bias = bias or ImuBias()
        self.reset()

    def reset(self, bias: Optional[ImuBias] = None):
        if bias is not None:
            self.bias = bias
        self.dR = np.eye(3)
        self.dv = np.zeros(3)
        self.dp = np.zeros(3)
        self.dt = 0.0
        self.cov = np.zeros((9, 9))

    def integrate(self, acc: np.ndarray, gyr: np.ndarray, dt: float):
        a = np.asarray(acc, np.float64) - self.bias.acc
        w = np.asarray(gyr, np.float64) - self.bias.gyr

        # covariance propagation (discrete first order)
        A = np.eye(9)
        ahat = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]],
                         [-a[1], a[0], 0]])
        A[3:6, 0:3] = -self.dR @ ahat * dt
        A[6:9, 0:3] = -0.5 * self.dR @ ahat * dt * dt
        A[6:9, 3:6] = np.eye(3) * dt
        A[0:3, 0:3] = _exp_so3(-w * dt)

        G = np.zeros((9, 6))
        G[0:3, 0:3] = np.eye(3) * dt           # gyro noise
        G[3:6, 3:6] = self.dR * dt             # accel noise
        G[6:9, 3:6] = 0.5 * self.dR * dt * dt
        Q = np.zeros((6, 6))
        Q[0:3, 0:3] = (self.calib.g_n ** 2 / max(dt, 1e-6)) * np.eye(3)
        Q[3:6, 3:6] = (self.calib.a_n ** 2 / max(dt, 1e-6)) * np.eye(3)
        self.cov = A @ self.cov @ A.T + G @ Q @ G.T

        # state propagation
        self.dp = self.dp + self.dv * dt + 0.5 * (self.dR @ a) * dt * dt
        self.dv = self.dv + (self.dR @ a) * dt
        self.dR = self.dR @ _exp_so3(w * dt)
        self.dt += dt

    def integrate_batch(self, imu_rows: np.ndarray,
                        timestamps_ns: bool = True):
        """rows: (N, 7) [t, wx, wy, wz, ax, ay, az] (EuRoC layout)."""
        if imu_rows is None or imu_rows.shape[0] < 2:
            return
        t = imu_rows[:, 0] * (1e-9 if timestamps_ns else 1.0)
        for i in range(imu_rows.shape[0] - 1):
            dt = float(t[i + 1] - t[i])
            if dt <= 0:
                continue
            self.integrate(imu_rows[i, 4:7], imu_rows[i, 1:4], dt)

    def predict(self, state: NavState,
                gravity: Optional[np.ndarray] = None) -> NavState:
        """Propagate a NavState through the preintegrated delta."""
        g = gravity if gravity is not None else self.calib.n_gravity
        Ri = se3.quat_to_matrix(as_f32(state.pose[3:7])).numpy()
        ti = state.pose[:3]
        dt = self.dt
        p = ti + state.vel * dt + 0.5 * g * dt * dt + Ri @ self.dp
        v = state.vel + g * dt + Ri @ self.dv
        Rj = Ri @ self.dR
        q = se3.matrix_to_quat(as_f32(Rj)).numpy()
        return NavState(pose=np.concatenate([p, q]), vel=v)


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Matrix times vector, batched over leading dims."""
    return (M @ v[..., None])[..., 0]


class ImuFactor(Factor):
    """Preintegrated IMU factor over (pose_i, vel_i, pose_j, vel_j).

    Residual: 9-vector [r_dR, r_dv, r_dp] whitened by the mean of the
    preintegration covariance's diagonal sigmas.  Poses are world_T_body
    7-vectors; the residual broadcasts over a leading batch dim.
    """

    stacked = ("g", "dR", "dv", "dp", "dt")

    def __init__(self, ki_pose: Key, ki_vel: Key, kj_pose: Key,
                 kj_vel: Key, pim: PreintegratedImuMeasurements,
                 gravity: Optional[np.ndarray] = None):
        sig = np.sqrt(np.maximum(np.diag(pim.cov), 1e-12))
        super().__init__([ki_pose, ki_vel, kj_pose, kj_vel],
                         sigma=float(np.mean(sig)))
        self.pim = pim
        self.g = as_f32(gravity if gravity is not None
                        else pim.calib.n_gravity)
        self.dR = as_f32(pim.dR)
        self.dv = as_f32(pim.dv)
        self.dp = as_f32(pim.dp)
        self.dt = pim.dt

    def residual(self, pose_i, vel_i, pose_j, vel_j):
        ti, tj = pose_i[..., :3], pose_j[..., :3]
        RiT = se3.quat_to_matrix(pose_i[..., 3:7]).transpose(-1, -2)
        Rj = se3.quat_to_matrix(pose_j[..., 3:7])
        dt = self.dt
        r_dp = _mv(RiT, tj - ti - vel_i * dt - 0.5 * self.g * dt * dt) \
            - self.dp
        r_dv = _mv(RiT, vel_j - vel_i - self.g * dt) - self.dv
        r_dR = se3.log_so3(se3.matrix_to_quat(
            self.dR.transpose(-1, -2) @ (RiT @ Rj)))
        return torch.cat([r_dR, r_dv, r_dp], dim=-1)


class BiasBetweenFactor(Factor):
    """Random-walk bias evolution between two bias states."""

    stacked = ()

    def __init__(self, ki: Key, kj: Key, dt: float,
                 calib: ImuCalibration):
        sigma = float(np.sqrt(max(dt, 1e-6))
                      * 0.5 * (calib.a_b + calib.g_b))
        super().__init__([ki, kj], sigma=sigma)

    def residual(self, bi, bj):
        return bj - bi


class PreIntegrationInertialFrontend:
    """Inertial frontend: per-frame preintegration -> factor batch.

    Consumes the packet's ``imu_t0_t1`` rows ((N, 7) [t, wx, wy, wz, ax,
    ay, az], EuRoC layout), preintegrates them, predicts the next NavState
    as the initial guess, and emits an ImuFactor and a BiasBetweenFactor
    (priors on the first state) for the backend graph.  Keys: pose
    ``x(k)``, velocity ``v(k)``, bias ``b(k)`` (6-vector [acc, gyr]).

    The bias is first order: the current estimate is baked into each
    preintegration and evolves through random-walk between-factors; the
    ImuFactor does not relinearize with respect to it.
    """

    def __init__(self, calib: ImuCalibration,
                 initial_state: Optional[NavState] = None,
                 pose_prior_sigma: float = 1e-4,
                 vel_prior_sigma: float = 1e-3,
                 bias_prior_sigma: float = 1e-2,
                 timestamps_ns: bool = True):
        self.calib = calib
        self.state = initial_state or NavState(
            pose=np.array([0, 0, 0, 0, 0, 0, 1.0]), vel=np.zeros(3))
        self.bias = ImuBias()
        self.k = -1            # index of the latest emitted state
        self.pose_prior_sigma = pose_prior_sigma
        self.vel_prior_sigma = vel_prior_sigma
        self.bias_prior_sigma = bias_prior_sigma
        self.timestamps_ns = timestamps_ns

    def _bias_vec(self) -> np.ndarray:
        return np.concatenate([self.bias.acc, self.bias.gyr])

    def __call__(self, batch):
        """-> (Variables of the NEW variables, FactorGraph of new factors),
        or (None, None) for a packet without IMU rows.

        The first call seeds state 0 with priors; later calls
        preintegrate ``imu_t0_t1`` into an (x_k, v_k) -> (x_k+1, v_k+1)
        factor."""
        x0 = Variables()
        g = FactorGraph()

        if self.k < 0:
            self.k = 0
            x0.insert(Key("x", 0), self.state.pose, SE3_VAR)
            x0.insert(Key("v", 0), self.state.vel, VECTOR(3))
            x0.insert(Key("b", 0), self._bias_vec(), VECTOR(6))
            g.add(PriorFactor(Key("x", 0), self.state.pose, SE3_VAR,
                              sigma=self.pose_prior_sigma))
            g.add(PriorFactor(Key("v", 0), self.state.vel, VECTOR(3),
                              sigma=self.vel_prior_sigma))
            g.add(PriorFactor(Key("b", 0), self._bias_vec(), VECTOR(6),
                              sigma=self.bias_prior_sigma))
            return x0, g

        imu = batch.get("imu_t0_t1")
        if imu is None or np.asarray(imu).shape[0] < 2:
            return None, None

        pim = PreintegratedImuMeasurements(self.calib, self.bias)
        pim.integrate_batch(np.asarray(imu, np.float64),
                            timestamps_ns=self.timestamps_ns)
        predicted = pim.predict(self.state)

        i, j = self.k, self.k + 1
        g.add(ImuFactor(Key("x", i), Key("v", i),
                        Key("x", j), Key("v", j), pim))
        g.add(BiasBetweenFactor(Key("b", i), Key("b", j), pim.dt,
                                self.calib))
        x0.insert(Key("x", j), predicted.pose, SE3_VAR)
        x0.insert(Key("v", j), predicted.vel, VECTOR(3))
        x0.insert(Key("b", j), self._bias_vec(), VECTOR(6))

        self.state = predicted
        self.k = j
        return x0, g
