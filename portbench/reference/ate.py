"""Absolute trajectory error after a Sim(3) alignment (Umeyama), in
NumPy float64: monocular tracking fixes neither scale nor gauge."""
from __future__ import annotations

import numpy as np


def quat_to_matrix(q: np.ndarray) -> np.ndarray:
    """(..., 4) [x, y, z, w] -> (..., 3, 3)."""
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    x, y, z, w = np.moveaxis(q, -1, 0)
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                  2 * (x * z + y * w)], -1),
        np.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                  2 * (y * z - x * w)], -1),
        np.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                  1 - 2 * (x * x + y * y)], -1)], -2)


def camera_centres(cam_T_world: np.ndarray) -> np.ndarray:
    """(N, 7) [t, q_xyzw] cam_T_world -> (N, 3) camera centres in the
    world: -R^T t."""
    p = np.asarray(cam_T_world, np.float64)
    R = quat_to_matrix(p[:, 3:])
    return -np.einsum("nji,nj->ni", R, p[:, :3])


def ate_rmse(est: np.ndarray, gt: np.ndarray) -> float:
    """RMSE of the camera centres ``est`` (N, 3) against ``gt`` (N, 3)
    after the least-squares similarity that maps est onto gt."""
    est, gt = np.asarray(est, np.float64), np.asarray(gt, np.float64)
    mu_e, mu_g = est.mean(0), gt.mean(0)
    e, g = est - mu_e, gt - mu_g
    n = est.shape[0]
    cov = g.T @ e / n
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_e = (e ** 2).sum() / n
    s = np.trace(np.diag(D) @ S) / max(var_e, 1e-300)
    aligned = s * e @ R.T + mu_g
    return float(np.sqrt(((aligned - gt) ** 2).sum(1).mean()))


def session_ate(rows: dict) -> float:
    """ATE of one session's keyframes: ``rows`` slot -> (cam_T_world 7,
    world_T_cam 4x4 ground truth)."""
    est = camera_centres(np.stack([r[0] for r in rows.values()]))
    gt = np.stack([r[1][:3, 3] for r in rows.values()])
    return ate_rmse(est, gt)
