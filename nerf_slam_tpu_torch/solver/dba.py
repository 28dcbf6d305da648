"""Dense bundle adjustment with marginal covariances (PyTorch).

One Gauss-Newton step over padded arrays:

  P  pose slots in the optimization window   (fixed/invalid -> masked)
  K  depth-map slots (unique source frames)  (padded)
  E  edge slots                              (padded, ``edge_valid``)

The host builds a small index plan per graph change (:func:`plan`, or the
frontend's slot-aligned plan); the device assembles the reduced camera
system, Schur-eliminates the depths (contracting the dense (P, K, 6, HW)
coupling tensor or, when the plan carries an interaction list, summing the
coupling pairs that share a depth slot), solves by Cholesky and
back-substitutes.  Conventions: DROID
tangent [v, w], left retraction on cam_T_world; the gauge is fixed by
freezing pose slot 0 when the window includes keyframe 0.  Depth
covariances use the exact ``Q + Q^2 ||L^-1 E||^2`` marginal.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..geometry import camera, se3
from ..ops.segment import segment_sum as seg_sum


class DBAPlan(NamedTuple):
    """Index plan for one factor-graph topology (device tensors).

    The optional pair tensors select the sparse Schur assembly: couplings
    are the 2E (pose slot, depth slot) incidences [Eiz ++ Ejz], and
    (pair_a, pair_b) lists the coupling pairs that share a depth slot
    (:func:`compute_pairs`).  Without them the dense (P, K) coupling
    tensor is contracted."""
    ii: torch.Tensor          # (E,) int64 source kf per edge
    jj: torch.Tensor          # (E,) int64 target kf per edge
    pi: torch.Tensor          # (E,) window pose slot of ii, or -1
    pj: torch.Tensor          # (E,) window pose slot of jj, or -1
    kk: torch.Tensor          # (E,) depth slot of ii, or -1
    edge_valid: torch.Tensor  # (E,) float 0/1
    px: torch.Tensor          # (P,) global kf per pose slot (clipped)
    p_valid: torch.Tensor     # (P,) float 0/1
    p_fixed: torch.Tensor     # (P,) float 0/1 (gauge-fixed: dx = 0)
    kx: torch.Tensor          # (K,) global kf per depth slot (clipped)
    k_valid: torch.Tensor     # (K,) float 0/1
    pair_a: Optional[torch.Tensor] = None      # (L,) int64 coupling index
    pair_b: Optional[torch.Tensor] = None      # (L,) int64 coupling index
    pair_valid: Optional[torch.Tensor] = None  # (L,) float 0/1


def plan_from_numpy(a, device) -> DBAPlan:
    """DBAPlan from a dict of numpy arrays (validity flags as 0/1); the
    pair arrays are optional."""
    def i(k):
        return torch.as_tensor(np.asarray(a[k], np.int64), device=device)

    def f(k):
        return torch.as_tensor(np.asarray(a[k], np.float32), device=device)

    return DBAPlan(ii=i("ii"), jj=i("jj"), pi=i("pi"), pj=i("pj"),
                   kk=i("kk"), edge_valid=f("edge_valid"), px=i("px"),
                   p_valid=f("p_valid"), p_fixed=f("p_fixed"), kx=i("kx"),
                   k_valid=f("k_valid"),
                   pair_a=i("pair_a") if "pair_a" in a else None,
                   pair_b=i("pair_b") if "pair_a" in a else None,
                   pair_valid=f("pair_valid") if "pair_a" in a else None)


def compute_pairs(pi: np.ndarray, pj: np.ndarray, kk: np.ndarray,
                  valid: np.ndarray, pad_to: int = 512):
    """Host-side interaction list for a sparse Schur assembly (numpy).

    Couplings are indexed 0..2E-1: coupling e couples (pi[e], kk[e]),
    coupling E+e couples (pj[e], kk[e]).  Returns padded (pair_a, pair_b,
    pair_valid) enumerating every ordered coupling pair that shares a depth
    slot, both poses in the window; the padding is a power of two, at
    least ``pad_to``.  :func:`solve_system` takes its sparse Schur path
    when the plan carries the list.
    """
    cp_pose = np.concatenate([pi, pj])
    cp_k = np.concatenate([kk, kk])
    cp_ok = np.concatenate([valid, valid]) & (cp_pose >= 0) & (cp_k >= 0)
    by_k = {}
    for c in np.nonzero(cp_ok)[0]:
        by_k.setdefault(int(cp_k[c]), []).append(int(c))
    pairs = [(a, b) for members in by_k.values()
             for a in members for b in members]
    n = len(pairs)
    L = max(pad_to, int(2 ** np.ceil(np.log2(max(n, 1)))))
    pa = np.zeros(L, np.int32)
    pb = np.zeros(L, np.int32)
    pv = np.zeros(L, np.float32)
    if n:
        arr = np.asarray(pairs, np.int32)
        pa[:n], pb[:n], pv[:n] = arr[:, 0], arr[:, 1], 1.0
    return pa, pb, pv


def plan(ii, jj, kf0: int, kf1: int, E: int, P: int, K: int,
         device="cuda") -> DBAPlan:
    """Padded index plan for edges (ii, jj) and the window [kf0, kf1),
    with the sparse-Schur interaction list."""
    ii = np.asarray(ii, dtype=np.int64)
    jj = np.asarray(jj, dtype=np.int64)
    n = ii.shape[0]
    if n > E:
        raise ValueError(f"{n} edges > edge capacity {E}")
    if kf1 - kf0 > P:
        raise ValueError(f"window {kf1 - kf0} > pose capacity {P}")
    kf_ids = np.unique(np.concatenate([np.arange(kf0, kf1), ii]))
    if kf_ids.shape[0] > K:
        raise ValueError(f"{kf_ids.shape[0]} depth maps > capacity {K}")
    kmap = {int(k): s for s, k in enumerate(kf_ids)}

    def pad(arr, size, fill):
        out = np.full((size,), fill, dtype=np.int64)
        out[:arr.shape[0]] = arr
        return out

    px = np.arange(kf0, kf0 + P)
    p_fixed = np.zeros(P)
    if kf0 == 0:
        p_fixed[0] = 1.0
    k_valid = np.zeros(K)
    k_valid[:kf_ids.shape[0]] = 1.0
    pi = pad(np.where((ii >= kf0) & (ii < kf1), ii - kf0, -1), E, -1)
    pj = pad(np.where((jj >= kf0) & (jj < kf1), jj - kf0, -1), E, -1)
    kk = pad(np.array([kmap[int(i)] for i in ii], np.int64), E, -1)
    valid = pad(np.ones(n, np.int64), E, 0)
    pa, pb, pv = compute_pairs(pi, pj, kk, valid > 0)
    return plan_from_numpy({
        "ii": pad(ii, E, 0), "jj": pad(jj, E, 0), "pi": pi, "pj": pj,
        "kk": kk, "edge_valid": valid,
        "px": np.clip(px, 0, None), "p_valid": (px < kf1),
        "p_fixed": p_fixed, "kx": pad(kf_ids, K, 0), "k_valid": k_valid,
        "pair_a": pa, "pair_b": pb, "pair_valid": pv,
    }, device)


def kx_scatter(buf: torch.Tensor, kx: torch.Tensor, k_valid: torch.Tensor,
               new: torch.Tensor) -> torch.Tensor:
    """Out-of-place ``buf[kx[s]] = new[s]`` for VALID depth slots only
    (padded slots alias index 0 and must not overwrite it)."""
    B = buf.shape[0]
    safe = torch.where(k_valid > 0, kx, B)
    out = torch.cat([buf, buf[:1]], dim=0)
    out[safe] = new.to(buf.dtype)
    return out[:B]


def linearize(poses, disps, intrinsics, targets, weights, p: DBAPlan):
    """Per-edge Gauss-Newton blocks.  Returns ((Hii, Hij, Hjj), (vi, vj),
    (Eiz, Ejz), (Cii, bz))."""
    Ec = p.ii.shape[0]
    HW = disps.shape[-2] * disps.shape[-1]
    coords, valid, Ji, Jj, Jz = camera.projective_transform_cm(
        poses, disps, intrinsics, p.ii, p.jj)
    t_cm = targets.reshape(Ec, HW, 2).transpose(1, 2)
    w_cm = weights.reshape(Ec, HW, 2).transpose(1, 2)
    r = t_cm - coords                                    # (E, 2, HW)
    w = 0.001 * valid * w_cm * p.edge_valid[:, None, None]
    wJz = w * Jz
    Cii = (wJz * Jz).sum(1)                              # (E, HW)
    bz = (wJz * r).sum(1)
    J2 = torch.cat([Ji, Jj], dim=1).reshape(Ec, 12, 2 * HW)
    wJ2 = w.reshape(Ec, 1, 2 * HW) * J2
    H12 = torch.bmm(wJ2, J2.transpose(1, 2))             # (E, 12, 12)
    v12 = torch.bmm(wJ2, r.reshape(Ec, 2 * HW, 1))[..., 0]
    Eiz = torch.einsum("exh,ecxh->ech", wJz, Ji)
    Ejz = torch.einsum("exh,ecxh->ech", wJz, Jj)
    return ((H12[:, :6, :6], H12[:, :6, 6:], H12[:, 6:, 6:]),
            (v12[:, :6], v12[:, 6:]), (Eiz, Ejz), (Cii, bz))


def assemble(blocks, p: DBAPlan, disps, eta, disps_sens, alpha=0.05):
    """Window-local dense system: Hd (6P, 6P), vd (6P,), Ehat (P, K, 6,
    HW), C (K, HW), w (K, HW)."""
    (Hii, Hij, Hjj), (vi, vj), (Eiz, Ejz), (Cii, bz) = blocks
    P = p.px.shape[0]
    K = p.kx.shape[0]
    HW = Cii.shape[-1]

    def pair_idx(a, b, n):
        return torch.where((a >= 0) & (b >= 0), a * n + b, -1)

    # one segment sum per output, over the edge blocks of all its terms
    Hgrid = seg_sum(torch.cat([Hii, Hij, Hij.transpose(-1, -2), Hjj]),
                    pair_idx(torch.cat([p.pi, p.pi, p.pj, p.pj]),
                             torch.cat([p.pi, p.pj, p.pi, p.pj]), P),
                    P * P).reshape(P, P, 6, 6)
    pp = torch.cat([p.pi, p.pj])
    v = seg_sum(torch.cat([vi, vj]), pp, P)
    C, w = seg_sum(torch.stack([Cii, bz], 1), p.kk, K).unbind(1)
    Ehat = seg_sum(torch.cat([Eiz, Ejz]),
                   pair_idx(pp, torch.cat([p.kk, p.kk]), K), P * K)
    d_k = disps[p.kx].reshape(K, HW)
    s_k = disps_sens.reshape(K, HW)
    m = (s_k > 0).to(C.dtype)
    C = C + m * alpha + (1 - m) * eta.reshape(K, HW)
    w = w - m * alpha * (d_k - s_k)
    C = torch.where(p.k_valid[:, None] > 0, C, torch.ones_like(C))
    w = w * p.k_valid[:, None]
    Hd = Hgrid.permute(0, 2, 1, 3).reshape(P * 6, P * 6)
    return Hd, v.reshape(P * 6), Ehat.reshape(P, K, 6, HW), C, w


def _gauge_mask(Hd, vd, p: DBAPlan):
    """Freeze invalid + gauge-fixed pose slots: identity rows/cols, rhs 0."""
    free = ((p.p_valid > 0) & (p.p_fixed == 0)).to(Hd.dtype)
    fm = free.repeat_interleave(6)
    Hd = Hd * fm[:, None] * fm[None, :] + torch.diag(1.0 - fm)
    return Hd, vd * fm, fm


_PAIR_CHUNK = 512      # coupling pairs contracted at a time


def _sparse_schur(E_blocks, Q, w, p: DBAPlan, fm, P: int, D: int):
    """S = E Q E^T and v_s = E Q w from the coupling interaction list:
    O(pairs * 36 * HW) work instead of the dense O((6P)^2 * K * HW)."""
    cp_pose = torch.cat([p.pi, p.pj])                    # (2E,)
    cp_k = torch.cat([p.kk, p.kk])
    E_all = torch.cat(E_blocks, dim=0)                   # (2E, 6, HW)
    free = fm.reshape(P, D)[:, 0]
    cp_pose_c = cp_pose.clamp(0, P - 1)
    cp_k_c = cp_k.clamp(0, Q.shape[0] - 1)
    cp_ok = ((cp_pose >= 0) & (cp_k >= 0)).to(E_all.dtype) * free[cp_pose_c]
    E_all = E_all * cp_ok[:, None, None]

    vs_c = torch.einsum("cdh,ch->cd", E_all, (Q * w)[cp_k_c])
    vs = seg_sum(vs_c, torch.where(cp_ok > 0, cp_pose_c, -1), P)

    S_grid = torch.zeros((P * P, D, D), dtype=E_all.dtype,
                         device=E_all.device)
    for s in range(0, p.pair_a.shape[0], _PAIR_CHUNK):
        pa = p.pair_a[s:s + _PAIR_CHUNK]
        pb = p.pair_b[s:s + _PAIR_CHUNK]
        pv = p.pair_valid[s:s + _PAIR_CHUNK]
        Bq = E_all[pb] * Q[cp_k_c[pb]][:, None, :]
        Sp = torch.einsum("lch,ldh->lcd", E_all[pa], Bq) * pv[:, None, None]
        idx = torch.where(pv > 0, cp_pose_c[pa] * P + cp_pose_c[pb], -1)
        S_grid = S_grid + seg_sum(Sp, idx, P * P)
    S = S_grid.reshape(P, P, D, D).permute(0, 2, 1, 3).reshape(P * D, P * D)
    return S, vs.reshape(P * D)


def solve_system(Hd, vd, Ehat, C, w, p: DBAPlan, ep=0.1, lm=1e-4,
                 E_blocks=None):
    """Schur-eliminate depths, solve the damped reduced camera system and
    back-substitute.  Returns dx (P, 6), dz (K, HW), the Cholesky factor L
    and Q = 1/C; a failed factorization gives a zero pose step (the
    reference's tolerance) without a host sync.

    When the plan carries an interaction list and the per-edge coupling
    blocks ``E_blocks`` = (Eiz, Ejz) of :func:`linearize` are given, S is
    assembled from the list; else from the dense coupling tensor."""
    P, K, D, HW = Ehat.shape
    Q = 1.0 / C
    Hd, vd, fm = _gauge_mask(Hd, vd, p)
    Ehat = Ehat * fm.reshape(P, D)[:, None, :, None]
    if (p.pair_a is not None and p.pair_a.shape[0] > 0
            and E_blocks is not None):
        S, vs = _sparse_schur(E_blocks, Q, w, p, fm, P, D)
    else:
        EQ = Ehat * Q[None, :, None, :]
        S = torch.einsum("pkdh,qkeh->pdqe", EQ, Ehat).reshape(P * D, P * D)
        vs = torch.einsum("pkdh,kh->pd", EQ, w).reshape(P * D)
    RCM = Hd - S
    rhs = vd - vs
    RCMd = RCM + torch.diag(ep + lm * torch.diagonal(RCM))
    L, info = torch.linalg.cholesky_ex(RCMd)
    L = torch.where(info == 0, L, torch.full_like(L, float("nan")))
    y = torch.linalg.solve_triangular(L, rhs[:, None], upper=False)
    dx = torch.linalg.solve_triangular(L.T, y, upper=True).reshape(P, D)
    dx = torch.where(torch.isfinite(dx).all(), dx, torch.zeros_like(dx))
    Etdx = torch.einsum("pkdh,pd->kh", Ehat, dx)
    dz = Q * (w - Etdx) * p.k_valid[:, None]
    return dx, dz, L, Q


def covariances(L, Ehat, Q, p: DBAPlan):
    """Marginal pose covariances (P, 6, 6) ([v, w], left perturbation of
    cam_T_world) and inverse-depth variances (K, HW) from the damped RCM
    factor; ``Ehat`` is the coupling as :func:`assemble` returns it."""
    P, K, D, HW = Ehat.shape
    PD = P * D
    eye = torch.eye(PD, dtype=L.dtype, device=L.device)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    Sigma = Linv.T @ Linv
    pose_cov = torch.diagonal(Sigma.reshape(P, D, P, D), dim1=0, dim2=2)
    pose_cov = pose_cov.permute(2, 0, 1)
    free = ((p.p_valid > 0) & (p.p_fixed == 0)).to(L.dtype)
    eye6 = torch.eye(D, dtype=L.dtype, device=L.device)
    pose_cov = torch.where(free[:, None, None] > 0, pose_cov, 1e-8 * eye6)
    G = Linv @ Ehat.permute(0, 2, 1, 3).reshape(PD, K * HW)
    z_cov = Q + Q * Q * (G * G).sum(0).reshape(K, HW)
    ok = torch.isfinite(L).all()
    pose_cov = torch.where(ok, pose_cov, eye6.expand_as(pose_cov))
    z_cov = torch.where(ok & torch.isfinite(z_cov), z_cov, Q)
    return pose_cov, z_cov


def dba_iterations(poses, disps, intrinsics, targets, weights, eta,
                   disps_sens, p: DBAPlan, iters: int = 2, ep: float = 0.1,
                   lm: float = 1e-4):
    """``iters`` relinearized Gauss-Newton steps on the full keyframe
    buffers (N, 7) / (N, H, W); only window slots change.  eta: (K, H, W)
    damping per depth slot; disps_sens: (K, H, W) sensed inverse depths
    (0 where absent).  Returns (poses, disps)."""
    K = p.kx.shape[0]
    Hh, Ww = disps.shape[-2:]
    mask = (p.p_valid * (1 - p.p_fixed))[:, None]
    N = poses.shape[0]
    px_safe = torch.where(p.p_valid > 0, p.px, N)
    px_read = p.px.clamp(max=N - 1)       # padded slots past the buffer
    for _ in range(iters):
        blocks = linearize(poses, disps, intrinsics, targets, weights, p)
        Hd, vd, Ehat, C, w = assemble(blocks, p, disps, eta, disps_sens)
        dx, dz, _, _ = solve_system(Hd, vd, Ehat, C, w, p, ep, lm,
                                    E_blocks=blocks[2])
        old = poses[px_read]
        upd = torch.where(mask > 0, se3.retr(old, dx), old)
        poses = torch.cat([poses, poses[:1]], dim=0)
        poses[px_safe] = upd
        poses = poses[:-1]
        dnew = torch.clamp(disps[p.kx] + dz.reshape(K, Hh, Ww), min=0.001)
        disps = kx_scatter(disps, p.kx, p.k_valid, dnew)
    return poses, disps
