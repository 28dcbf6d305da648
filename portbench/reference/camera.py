"""Frozen copy of ``nerf_slam_tpu_torch/geometry/camera.py``, the benchmark's plain
reference: later changes to the port do not reach it.

Pinhole projective geometry with analytic Jacobians (PyTorch).

All functions work on a keyframe buffer:
  poses      : (N, 7)    cam_T_world, [t, q_xyzw] (see geometry.se3)
  disps      : (N, H, W) inverse depths at feature resolution
  intrinsics : (N, 4)    [fx, fy, cx, cy] at feature resolution
  ii, jj     : (E,)      int64 edge lists (source -> target keyframe)

Jacobians follow the DROID convention: tangent [v(3), w(3)], left
retraction ``exp(xi) * cam_T_world``.
"""
from __future__ import annotations

import torch

from . import se3

MIN_DEPTH = 0.2


def coords_grid(ht: int, wd: int, dtype=torch.float32,
                device=None) -> torch.Tensor:
    """(H, W, 2) grid of pixel coordinates [x, y]."""
    y, x = torch.meshgrid(torch.arange(ht, dtype=dtype, device=device),
                          torch.arange(wd, dtype=dtype, device=device),
                          indexing="ij")
    return torch.stack([x, y], dim=-1)


def iproj(disps: torch.Tensor, intrinsics: torch.Tensor) -> torch.Tensor:
    """Inverse-project to homogeneous points [X, Y, 1, d]: (..., H, W, 4)."""
    ht, wd = disps.shape[-2:]
    fx, fy, cx, cy = intrinsics[..., None, None, :].unbind(-1)
    grid = coords_grid(ht, wd, disps.dtype, disps.device)
    X = (grid[..., 0] - cx) / fx
    Y = (grid[..., 1] - cy) / fy
    X, Y = torch.broadcast_tensors(X, Y)
    X = X.expand(disps.shape)
    Y = Y.expand(disps.shape)
    return torch.stack([X, Y, torch.ones_like(disps), disps], dim=-1)


def proj(Xs: torch.Tensor, intrinsics: torch.Tensor, jacobian: bool = False):
    """Project homogeneous points (..., H, W, 4) -> pixels (..., H, W, 2)
    and optionally the (..., H, W, 2, 4) Jacobian d(u,v)/d(X,Y,Z,D)."""
    fx, fy, cx, cy = intrinsics[..., None, None, :].unbind(-1)
    X, Y, Z, _ = Xs.unbind(-1)
    Z = torch.where(Z < 0.5 * MIN_DEPTH, torch.ones_like(Z), Z)
    d = 1.0 / Z
    coords = torch.stack([fx * (X * d) + cx, fy * (Y * d) + cy], dim=-1)
    if not jacobian:
        return coords, None
    o = torch.zeros_like(d)
    Jp = torch.stack([fx * d, o, -fx * X * d * d, o,
                      o, fy * d, -fy * Y * d * d, o], dim=-1)
    return coords, Jp.reshape(Jp.shape[:-1] + (2, 4))


def actp(Gij: torch.Tensor, X0: torch.Tensor, jacobian: bool = False):
    """SE(3) action on homogeneous point clouds; the (..., 4, 6) Jacobian
    is taken wrt a left perturbation of Gij, [v, w] order."""
    X1 = se3.act4(Gij[..., None, None, :], X0)
    if not jacobian:
        return X1, None
    X, Y, Z, d = X1.unbind(-1)
    o = torch.zeros_like(d)
    Ja = torch.stack([d, o, o, o, Z, -Y,
                      o, d, o, -Z, o, X,
                      o, o, d, Y, -X, o,
                      o, o, o, o, o, o], dim=-1)
    return X1, Ja.reshape(Ja.shape[:-1] + (4, 6))


def _edge_poses(poses, ii, jj, stereo_rel):
    """(E, 7) relative poses of the edges; with a rig pose ``stereo_rel``
    (7,) cam1_T_cam0, the STEREO edges (ii == jj) take it instead."""
    Gij = se3.relpose(poses[ii], poses[jj])
    if stereo_rel is None:
        return Gij
    rig = torch.as_tensor(stereo_rel, dtype=Gij.dtype, device=Gij.device)
    return torch.where((ii == jj)[:, None], rig[None, :], Gij)


def projective_transform(poses, disps, intrinsics, ii, jj,
                         jacobian: bool = False, stereo_rel=None):
    """Map pixels of keyframes ii into keyframes jj.

    Returns (coords (E,H,W,2), valid (E,H,W,1), (Ji, Jj, Jz)) where Ji/Jj
    are (E,H,W,2,6) Jacobians wrt left perturbations of cam_T_world[ii] /
    cam_T_world[jj] and Jz (E,H,W,2,1) is wrt the source inverse depth.
    ``stereo_rel``: optional (7,) rig pose cam1_T_cam0; edges with ii ==
    jj are stereo edges whose relative pose is pinned to it.
    """
    X0 = iproj(disps[ii], intrinsics[ii])
    Gij = _edge_poses(poses, ii, jj, stereo_rel)
    X1, Ja = actp(Gij, X0, jacobian=jacobian)
    x1, Jp = proj(X1, intrinsics[jj], jacobian=jacobian)
    valid = ((X1[..., 2] > MIN_DEPTH) & (X0[..., 2] > MIN_DEPTH))
    valid = valid.to(disps.dtype)[..., None]
    if not jacobian:
        return x1, valid, (None, None, None)
    Jj = Jp @ Ja
    Ji = -se3.adjT_apply(Gij[..., None, None, None, :], Jj)
    dX1_dd = torch.cat([Gij[..., None, None, :3].expand(X1[..., :3].shape),
                        torch.ones_like(X1[..., 3:4])], dim=-1)
    Jz = (Jp @ dX1_dd[..., None])
    return x1, valid, (Ji, Jj, Jz)


def projective_transform_cm(poses, disps, intrinsics, ii, jj,
                            stereo_rel=None):
    """Channel-major projective transform with analytic Jacobians (the DBA
    linearization's layout): returns coords (E,2,HW), valid (E,1,HW),
    Ji (E,6,2,HW), Jj (E,6,2,HW), Jz (E,2,HW).  ``stereo_rel`` as in
    :func:`projective_transform`."""
    E = ii.shape[0]
    ht, wd = disps.shape[-2:]
    HW = ht * wd
    fx_i, fy_i, cx_i, cy_i = intrinsics[ii][:, :, None].unbind(1)
    fx_j, fy_j, cx_j, cy_j = intrinsics[jj][:, :, None].unbind(1)
    grid = coords_grid(ht, wd, disps.dtype, disps.device).reshape(HW, 2)
    gx = grid[None, :, 0]
    gy = grid[None, :, 1]
    d0 = disps[ii].reshape(E, HW)
    X0x = (gx - cx_i) / fx_i
    X0y = (gy - cy_i) / fy_i

    Gij = _edge_poses(poses, ii, jj, stereo_rel)
    t = Gij[:, :3]
    R = se3.quat_to_matrix(Gij[:, 3:7])
    tc = [t[:, k][:, None] for k in range(3)]

    def row(k):
        return (R[:, k, 0][:, None] * X0x + R[:, k, 1][:, None] * X0y
                + R[:, k, 2][:, None] + d0 * tc[k])

    X1x, X1y, X1z = row(0), row(1), row(2)
    valid = (X1z > MIN_DEPTH).to(disps.dtype)[:, None, :]
    iz = 1.0 / torch.where(X1z < 0.5 * MIN_DEPTH, torch.ones_like(X1z), X1z)
    coords = torch.stack([fx_j * (X1x * iz) + cx_j,
                          fy_j * (X1y * iz) + cy_j], dim=1)
    gu = fx_j * iz
    hu = -fx_j * X1x * iz * iz
    gv = fy_j * iz
    hv = -fy_j * X1y * iz * iz
    o = torch.zeros_like(iz)
    Jj_u = [gu * d0, o, hu * d0, hu * X1y, gu * X1z - hu * X1x, -gu * X1y]
    Jj_v = [o, gv * d0, hv * d0, -gv * X1z + hv * X1y, -hv * X1x, gv * X1x]
    Jj = torch.stack([torch.stack(Jj_u, dim=1),
                      torch.stack(Jj_v, dim=1)], dim=2)     # (E, 6, 2, HW)
    A = se3.adj_matrix(Gij)                                  # (E, 6, 6)
    Ji = -torch.einsum("edc,edxh->ecxh", A, Jj)
    Jz = torch.stack([gu * tc[0] + hu * tc[2], gv * tc[1] + hv * tc[2]],
                     dim=1)
    return coords, valid, Ji, Jj, Jz


def frame_distance(poses, disps, intrinsics, ii, jj, beta: float = 0.3):
    """Mean reprojection-flow magnitude between frame pairs, blending the
    full-SE(3) flow with a translation-only flow by ``beta``; 1000 where
    fewer than 75% of pixels stay valid.  Output: (E,)."""
    ht, wd = disps.shape[-2:]
    grid = coords_grid(ht, wd, disps.dtype, disps.device)
    X0 = iproj(disps[ii], intrinsics[ii])
    Gij = se3.relpose(poses[ii], poses[jj])
    fx, fy, cx, cy = intrinsics[ii][..., None, None, :].unbind(-1)

    def flow_mag(X1):
        Z = X1[..., 2]
        u = fx * (X1[..., 0] / Z) + cx - grid[..., 0]
        v = fy * (X1[..., 1] / Z) + cy - grid[..., 1]
        return torch.sqrt(u * u + v * v), (Z > MIN_DEPTH).to(disps.dtype)

    d1, v1 = flow_mag(se3.act4(Gij[..., None, None, :], X0))
    X1t = torch.cat([X0[..., :3] + X0[..., 3:4] * Gij[..., None, None, :3],
                     X0[..., 3:4]], dim=-1)
    d2, v2 = flow_mag(X1t)
    accum = beta * (d1 * v1).sum((-2, -1)) + \
        (1 - beta) * (d2 * v2).sum((-2, -1))
    valid = beta * v1.sum((-2, -1)) + (1 - beta) * v2.sum((-2, -1))
    frac = valid / (float(ht * wd) + 1e-8)
    dist = accum / torch.clamp(valid, min=1e-8)
    return torch.where(frac < 0.75, torch.full_like(dist, 1000.0), dist)


def frame_distance_bidirectional(poses, disps, intrinsics, ii, jj,
                                 beta: float = 0.3):
    """0.5 * (d(ii->jj) + d(jj->ii))."""
    return 0.5 * (frame_distance(poses, disps, intrinsics, ii, jj, beta)
                  + frame_distance(poses, disps, intrinsics, jj, ii, beta))


def iproj_points(poses, disps, intrinsics) -> torch.Tensor:
    """Back-project inverse depths to world-frame 3D points (DROID's
    iproj kernel): poses (N, 7) cam_T_world; returns (N, H, W, 3)."""
    X = iproj(disps, intrinsics)                   # [x, y, 1, d] camera
    pts_cam = X[..., :3] / torch.clamp(X[..., 3:4], min=1e-8)
    return se3.act(se3.inv(poses)[..., None, None, :], pts_cam)


def depth_filter(poses, disps, intrinsics, ix, thresh):
    """Multi-view depth-consistency count (DROID's depth_filter_kernel).

    Each keyframe in ``ix`` is reprojected into its 6 neighbours (ix-1,
    ix-2, ix-3, ix+3, ix+4, ix+5, the CUDA kernel's schedule); a neighbour
    agrees at a pixel when the reprojected depth lies within ``thresh`` of
    the neighbour's depth at one of the 4 surrounding pixels.  Neighbours
    outside [0, N) do not count.  ``thresh``: a scalar or (len(ix),).
    Returns (len(ix), H, W) counts."""
    N, H, W = disps.shape
    ix = torch.as_tensor(ix, dtype=torch.int64, device=disps.device)
    thresh = torch.as_tensor(thresh, dtype=disps.dtype, device=disps.device) \
        .expand(ix.shape[0])[:, None, None]
    X0 = iproj(disps[ix], intrinsics[ix])
    count = torch.zeros((ix.shape[0], H, W), dtype=disps.dtype,
                        device=disps.device)
    rows = torch.arange(ix.shape[0], device=disps.device)[:, None, None]
    for n in range(6):
        jx = ix - n - 1 if n < 3 else ix + n
        valid_j = ((jx >= 0) & (jx < N))[:, None, None]
        js = jx.clamp(0, N - 1)
        X1 = se3.act4(se3.relpose(poses[ix], poses[js])[:, None, None, :], X0)
        fx, fy, cx, cy = intrinsics[js][:, None, None, :].unbind(-1)
        front = X1[..., 2] > 0.01
        Z = torch.where(front, X1[..., 2], torch.full_like(X1[..., 2], 1e6))
        u0 = torch.floor(fx * X1[..., 0] / Z + cx).long()
        v0 = torch.floor(fy * X1[..., 1] / Z + cy).long()
        inb = (u0 >= 0) & (v0 >= 0) & (u0 < W - 1) & (v0 < H - 1) & front
        u0c, v0c = u0.clamp(0, W - 2), v0.clamp(0, H - 2)
        zj = 1.0 / torch.clamp(X1[..., 3] / Z, min=1e-8)
        dmap = disps[js]
        agree = torch.zeros_like(inb)
        for dv in (0, 1):
            for du in (0, 1):
                dn = dmap[rows, v0c + dv, u0c + du]
                agree |= torch.abs(zj - 1.0 / torch.clamp(dn, min=1e-8)) \
                    < thresh
        count = count + (agree & inb & valid_j).to(disps.dtype)
    return count
