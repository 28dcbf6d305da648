"""Trajectory evaluation: ATE-RMSE with Umeyama (Sim3/SE3) alignment."""
from __future__ import annotations

from typing import Tuple

import numpy as np


def umeyama_alignment(src: np.ndarray, dst: np.ndarray,
                      with_scale: bool = True
                      ) -> Tuple[np.ndarray, np.ndarray, float]:
    """Least-squares similarity transform with dst ~ s * R @ src + t.
    src, dst: (N, 3).  Returns (R, t, s)."""
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    U, D, Vt = np.linalg.svd(xd.T @ xs / src.shape[0])
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = 1.0
    if with_scale:
        var_s = (xs ** 2).sum() / src.shape[0]
        # a degenerate (coincident) source leaves the scale unobservable:
        # keep s = 1 so ATE reports the honest, large error, not NaN
        if var_s > 1e-12:
            s = float(np.trace(np.diag(D) @ S) / var_s)
    return R, mu_d - s * R @ mu_s, s


def ate_rmse(est_positions: np.ndarray, gt_positions: np.ndarray,
             align_scale: bool = True) -> float:
    """Absolute trajectory error (RMSE, metres) after Sim3 alignment."""
    est = np.asarray(est_positions, np.float64)
    gt = np.asarray(gt_positions, np.float64)
    if est.shape != gt.shape or est.shape[1] != 3:
        raise ValueError(f"shapes {est.shape} and {gt.shape} differ")
    R, t, s = umeyama_alignment(est, gt, with_scale=align_scale)
    err = (s * (R @ est.T)).T + t - gt
    return float(np.sqrt((err ** 2).sum(axis=1).mean()))


def _numpy(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def _pose_to_c2w_translation(poses7: np.ndarray) -> np.ndarray:
    """Camera centres of cam_T_world 7-vectors [t, q_xyzw]: -R^T t."""
    t = poses7[:, :3].astype(np.float64)
    x, y, z, w = (poses7[:, 3 + i].astype(np.float64) for i in range(4))
    R = np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(-1, 3, 3)
    return -np.einsum("nji,nj->ni", R, t)


def trajectory_from_packet(packet) -> Tuple[np.ndarray, np.ndarray]:
    """(est_positions, gt_positions) from a frontend viz packet."""
    poses = _numpy(packet["cam0_poses"])
    n = int(packet.get("viz_count", poses.shape[0]))
    return (_pose_to_c2w_translation(poses[:n]),
            _numpy(packet["gt_poses"])[:n, :3, 3])
