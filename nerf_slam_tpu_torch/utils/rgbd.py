"""RGB-D training/eval helpers: timestamp association, trajectory
interpolation, all-pairs pose/flow distance matrices, and co-visibility
frame-graph construction for the DROID trainer.

The JAX package's ``utils/rgbd.py`` (NeRF-SLAM's networks/geom/
rgbd_utils.py and graph_utils.py:36-111): the flow-distance matrix runs on
the device in chunks of frame pairs through ``geometry.camera``'s
projective transform; the greedy graph builders stay host-side numpy.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional

import numpy as np
import torch

from ..geometry import se3
from ..geometry.camera import coords_grid, iproj, proj, projective_transform

__all__ = [
    "associate_frames", "interpolate_poses", "all_pairs_distance_matrix",
    "compute_distance_matrix_flow", "build_frame_graph",
    "graph_to_edge_list",
]


def associate_frames(t_image, t_depth, t_pose=None, max_dt: float = 1.0):
    """Pair image timestamps with nearest depth (and pose) timestamps
    (rgbd_utils.py:16-33).  Returns a list of (i, j) or (i, j, k) index
    tuples for pairs within ``max_dt`` seconds."""
    t_image = np.asarray(t_image, np.float64)
    t_depth = np.asarray(t_depth, np.float64)
    out = []
    for i, t in enumerate(t_image):
        j = int(np.argmin(np.abs(t_depth - t)))
        if abs(t_depth[j] - t) >= max_dt:
            continue
        if t_pose is None:
            out.append((i, j))
        else:
            k = int(np.argmin(np.abs(np.asarray(t_pose) - t)))
            if abs(t_pose[k] - t) < max_dt:
                out.append((i, j, k))
    return out


def interpolate_poses(t_query, t_traj, poses_traj) -> np.ndarray:
    """Interpolate a [t, q_xyzw] trajectory at query times: translation
    lerps, rotation slerps between the bracketing samples (shortest arc);
    queries outside the trajectory clamp to its ends.  poses_traj: (N, 7);
    returns (Q, 7) float32."""
    t_query = np.asarray(t_query, np.float64)
    t_traj = np.asarray(t_traj, np.float64)
    poses_traj = np.asarray(poses_traj, np.float64)
    order = np.argsort(t_traj)
    t_traj, poses_traj = t_traj[order], poses_traj[order]

    hi = np.clip(np.searchsorted(t_traj, t_query), 1, len(t_traj) - 1)
    lo = hi - 1
    t0, t1 = t_traj[lo], t_traj[hi]
    a = np.where(t1 > t0, (t_query - t0) / np.maximum(t1 - t0, 1e-12), 0.0)
    a = np.clip(a, 0.0, 1.0)[:, None]

    p = (1.0 - a) * poses_traj[lo, :3] + a * poses_traj[hi, :3]

    q0 = poses_traj[lo, 3:]
    q1 = poses_traj[hi, 3:]
    dot = np.sum(q0 * q1, axis=-1, keepdims=True)
    q1 = np.where(dot < 0.0, -q1, q1)
    dot = np.abs(np.clip(dot, -1.0, 1.0))
    theta = np.arccos(dot)
    sin_t = np.sin(theta)
    # slerp, falling back to lerp for nearly parallel quaternions
    w0 = np.where(sin_t > 1e-6, np.sin((1.0 - a) * theta) / np.maximum(
        sin_t, 1e-12), 1.0 - a)
    w1 = np.where(sin_t > 1e-6, np.sin(a * theta) / np.maximum(
        sin_t, 1e-12), a)
    q = w0 * q0 + w1 * q1
    q = q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
    return np.concatenate([p, q], axis=-1).astype(np.float32)


def all_pairs_distance_matrix(poses: np.ndarray, beta: float = 2.5,
                              device="cuda") -> np.ndarray:
    """(N, N) SE(3) log-norm distances with the translation scaled by
    ``beta`` (rgbd_utils.py:91-98).  poses: (N, 7)."""
    g = torch.as_tensor(np.asarray(poses, np.float32).copy(),
                        device=device)
    g[:, :3] *= beta
    n = g.shape[0]
    rel = se3.mul(se3.inv(g[:, None, :]).expand(n, n, 7),
                  g[None, :, :].expand(n, n, 7))
    r = se3.log(rel.reshape(-1, 7)).reshape(n, n, 6)
    return torch.linalg.norm(r, dim=-1).cpu().numpy()


def _induced_flow_tonly(poses, disps, intrinsics, ii, jj):
    """Translation-only induced flow (rotation zeroed), the ``tonly``
    path of NeRF-SLAM's induced_flow."""
    ht, wd = disps.shape[-2:]
    X0 = iproj(disps[ii], intrinsics[ii])
    Gij = se3.relpose(poses[ii], poses[jj])
    X1 = X0.clone()
    X1[..., :3] = X0[..., :3] + X0[..., 3:4] * Gij[:, None, None, :3]
    coords1, _ = proj(X1, intrinsics[jj])
    grid = coords_grid(ht, wd, dtype=disps.dtype, device=disps.device)
    valid = X1[..., 2] > 0.2
    return coords1[..., :2] - grid, valid


def compute_distance_matrix_flow(poses, disps, intrinsics,
                                 beta: Optional[float] = None,
                                 chunk: int = 1024,
                                 max_flow: float = 100.0,
                                 valid_thresh: float = 0.7,
                                 device="cuda") -> np.ndarray:
    """(N, N) mean bidirectional induced-flow magnitude between all frame
    pairs (rgbd_utils.py:105-190), computed on ``device`` in blocks of
    ``chunk`` pairs.

    beta=None: full-SE(3) flow; a float: the v2 variant, translation-only
    flow + beta * full flow, with a stricter 0.8 validity threshold.
    Inputs: poses (N, 7) [t, q], disps (N, h, w) and intrinsics (N, 4) or
    (4,) at feature resolution.  Pairs below the validity threshold get
    +inf (never linked)."""
    dev = torch.device(device)
    poses = torch.as_tensor(np.array(poses, np.float32), device=dev)
    disps = torch.as_tensor(np.array(disps, np.float32), device=dev)
    intr = np.asarray(intrinsics, np.float32)
    if intr.ndim == 1:
        intr = np.broadcast_to(intr, (disps.shape[0], 4))
    intr = torch.as_tensor(np.ascontiguousarray(intr), device=dev)
    N = disps.shape[0]
    if beta is not None:
        valid_thresh = 0.8
        max_flow = 128.0
    grid = coords_grid(*disps.shape[-2:], device=dev)

    def one_dir(a, b):
        coords, val, _ = projective_transform(poses, disps, intr, a, b)
        flow = coords - grid
        val = val[..., 0]
        mag = torch.clamp(torch.linalg.norm(flow, dim=-1), max=max_flow)
        if beta is not None:
            # v2: translation-only + beta * full (a graph less dominated by
            # pure rotation, rgbd_utils.py:165-174)
            tflow, tval = _induced_flow_tonly(poses, disps, intr, a, b)
            tmag = torch.clamp(torch.linalg.norm(tflow, dim=-1),
                               max=max_flow)
            mag = tmag + beta * mag
            val = val * tval
        val = val.float()
        num = (mag * val).sum(dim=(-2, -1))
        den = val.sum(dim=(-2, -1))
        frac = den / float(mag.shape[-1] * mag.shape[-2])
        return num / torch.clamp(den, min=1e-8), frac

    ii_all, jj_all = np.meshgrid(np.arange(N), np.arange(N), indexing="ij")
    ii_all = torch.as_tensor(ii_all.reshape(-1), device=dev)
    jj_all = torch.as_tensor(jj_all.reshape(-1), device=dev)
    out = []
    for s in range(0, N * N, chunk):
        ii, jj = ii_all[s:s + chunk], jj_all[s:s + chunk]
        m1, f1 = one_dir(ii, jj)
        m2, f2 = one_dir(jj, ii)
        mag, frac = 0.5 * (m1 + m2), 0.5 * (f1 + f2)
        out.append(torch.where(frac < valid_thresh,
                               torch.full_like(mag, float("inf")), mag))
    return torch.cat(out).reshape(N, N).cpu().numpy()


def build_frame_graph(poses, disps, intrinsics, num: int = 16,
                      thresh: float = 24.0, r: int = 2,
                      nms: bool = False,
                      d: Optional[np.ndarray] = None, device="cuda"
                      ) -> "OrderedDict[int, List[int]]":
    """Co-visibility frame graph for training (graph_utils.py:36-111).

    Temporal edges within radius ``r`` always; then greedily the
    lowest-flow-distance pairs until ``num`` edges exist (or, with
    ``nms=True``, the v2 variant, until no pair is under ``thresh``,
    suppressing the 3x3 neighborhood of each accepted pair).  A
    precomputed matrix ``d`` skips the flow computation."""
    N = np.asarray(poses).shape[0]
    if d is None:
        d = compute_distance_matrix_flow(
            poses, disps, intrinsics, beta=0.4 if nms else None,
            device=device)
    d = np.array(d, np.float32)

    count = 0
    graph: "OrderedDict[int, List[int]]" = OrderedDict()
    for i in range(N):
        graph[i] = []
        d[i, i] = np.inf
        for j in range(max(0, i - r), min(N, i + r + 1)):
            if i != j:
                graph[i].append(j)
                d[i, j] = np.inf
                count += 1

    while nms or count < num:
        ix = int(np.argmin(d))
        i, j = ix // N, ix % N
        if d[i, j] >= thresh:
            break
        graph[i].append(j)
        count += 1
        if nms:
            d[max(0, i - 1):i + 2, max(0, j - 1):j + 2] = np.inf
        else:
            d[i, j] = np.inf
    return graph


def graph_to_edge_list(graph: Dict[int, List[int]]):
    """(ii, jj, kk) arrays from an adjacency dict (graph_utils.py:9-20);
    kk is the source frame's rank."""
    ii, jj, kk = [], [], []
    for s, u in enumerate(graph):
        for v in graph[u]:
            ii.append(u)
            jj.append(v)
            kk.append(s)
    return (np.asarray(ii, np.int32), np.asarray(jj, np.int32),
            np.asarray(kk, np.int32))
