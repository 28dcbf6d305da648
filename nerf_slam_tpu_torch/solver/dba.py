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

On the card, :func:`dba_iterations` replays its Gauss-Newton steps as one
CUDA graph (:class:`_SolveGraph`): the same kernels on the same shapes,
launched by one call instead of some 1,500 host dispatches.
"""
from __future__ import annotations

import threading
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..geometry import camera, se3
from ..ops.segment import reduce_in_order
from ..ops.segment import segment_sum as seg_sum
from ..utils import runtime


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


def linearize(poses, disps, intrinsics, targets, weights, p: DBAPlan,
              stereo_rel=None):
    """Per-edge Gauss-Newton blocks.  Returns ((Hii, Hij, Hjj), (vi, vj),
    (Eiz, Ejz), (Cii, bz)).  ``stereo_rel``: optional (7,) rig pose; the
    stereo edges (ii == jj) then take it as their relative pose and
    constrain depth only: they enter the depth blocks Cii and bz with
    their full weight and every pose-coupled block (H, v, Eiz, Ejz) with
    weight 0."""
    Ec = p.ii.shape[0]
    HW = disps.shape[-2] * disps.shape[-1]
    coords, valid, Ji, Jj, Jz = camera.projective_transform_cm(
        poses, disps, intrinsics, p.ii, p.jj, stereo_rel=stereo_rel)
    t_cm = targets.reshape(Ec, HW, 2).transpose(1, 2)
    w_cm = weights.reshape(Ec, HW, 2).transpose(1, 2)
    r = t_cm - coords                                    # (E, 2, HW)
    w = 0.001 * valid * w_cm * p.edge_valid[:, None, None]
    wJz = w * Jz
    Cii = (wJz * Jz).sum(1)                              # (E, HW)
    bz = (wJz * r).sum(1)
    if stereo_rel is not None:
        w = w * (p.ii != p.jj).to(w.dtype)[:, None, None]
        wJz = w * Jz
    J2 = torch.cat([Ji, Jj], dim=1).reshape(Ec, 12, 2 * HW)
    wJ2 = w.reshape(Ec, 1, 2 * HW) * J2
    H12 = torch.bmm(wJ2, J2.transpose(1, 2))             # (E, 12, 12)
    v12 = torch.bmm(wJ2, r.reshape(Ec, 2 * HW, 1))[..., 0]
    Eiz = torch.einsum("exh,ecxh->ech", wJz, Ji)
    Ejz = torch.einsum("exh,ecxh->ech", wJz, Jj)
    return ((H12[:, :6, :6], H12[:, :6, 6:], H12[:, 6:, 6:]),
            (v12[:, :6], v12[:, 6:]), (Eiz, Ejz), (Cii, bz))


def assemble_edges(blocks, p: DBAPlan):
    """The edge sums of the window-local system, before any prior:
    Hgrid (P, P, 6, 6), v (P, 6), Ehat (P * K, 6, HW), C (K, HW), w (K,
    HW).  Linear in the edges, so the sums of an edge-sharded system add
    across shards (:func:`reduce_in_order`)."""
    (Hii, Hij, Hjj), (vi, vj), (Eiz, Ejz), (Cii, bz) = blocks
    P = p.px.shape[0]
    K = p.kx.shape[0]

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
    return Hgrid, v, Ehat, C, w


def add_priors(sums, p: DBAPlan, disps, eta, disps_sens, alpha=0.05):
    """The window-local dense system from the edge sums of
    :func:`assemble_edges`: the depth damping ``eta`` (or the sensed-depth
    prior of weight ``alpha`` where ``disps_sens`` > 0) added once per
    depth slot, padded slots made harmless.  Returns Hd (6P, 6P), vd
    (6P,), Ehat (P, K, 6, HW), C (K, HW), w (K, HW)."""
    Hgrid, v, Ehat, C, w = sums
    P = p.px.shape[0]
    K = p.kx.shape[0]
    HW = C.shape[-1]
    d_k = disps[p.kx].reshape(K, HW)
    s_k = disps_sens.reshape(K, HW)
    m = (s_k > 0).to(C.dtype)
    C = C + m * alpha + (1 - m) * eta.reshape(K, HW)
    w = w - m * alpha * (d_k - s_k)
    C = torch.where(p.k_valid[:, None] > 0, C, torch.ones_like(C))
    w = w * p.k_valid[:, None]
    Hd = Hgrid.permute(0, 2, 1, 3).reshape(P * 6, P * 6)
    return Hd, v.reshape(P * 6), Ehat.reshape(P, K, 6, HW), C, w


def assemble(blocks, p: DBAPlan, disps, eta, disps_sens, alpha=0.05):
    """Window-local dense system: Hd (6P, 6P), vd (6P,), Ehat (P, K, 6,
    HW), C (K, HW), w (K, HW)."""
    return add_priors(assemble_edges(blocks, p), p, disps, eta, disps_sens,
                      alpha)


class EdgeShard(NamedTuple):
    """One shard's edges for :func:`sharded_system`: its plan (the edge
    arrays of its slots, the slot arrays replicated) and its flow targets
    and weights, all on the shard's device."""
    plan: DBAPlan
    targets: torch.Tensor
    weights: torch.Tensor


def sharded_system(poses, disps, intrinsics, shards, p: DBAPlan, eta,
                   disps_sens, stereo_rel=None):
    """The window-local system of edges split over ``shards``: each shard
    linearizes its edges and sums them on its own device, the sums are
    reduced on ``p``'s device in shard order, and the priors are added
    once.  Returns (Hd, vd, Ehat, C, w) and the last shard's blocks."""
    parts = []
    for sh in shards:
        dev = sh.plan.ii.device
        blocks = linearize(poses.to(dev), disps.to(dev), intrinsics.to(dev),
                           sh.targets, sh.weights, sh.plan,
                           stereo_rel=(None if stereo_rel is None
                                       else stereo_rel.to(dev)))
        parts.append(assemble_edges(blocks, sh.plan))
    return (add_priors(reduce_in_order(parts, p.ii.device), p, disps, eta,
                       disps_sens), blocks)


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
                   lm: float = 1e-4, stereo_rel=None, shards=None):
    """``iters`` relinearized Gauss-Newton steps on the full keyframe
    buffers (N, 7) / (N, H, W); only window slots change.  eta: (K, H, W)
    damping per depth slot; disps_sens: (K, H, W) sensed inverse depths
    (0 where absent); ``stereo_rel`` as in :func:`linearize`.
    ``shards``: the edges split into :class:`EdgeShard` s (``targets`` and
    ``weights`` are then unused): each step reduces the shards' edge sums
    (:func:`sharded_system`) and solves with the dense Schur complement
    on ``p``'s device.  Returns (poses, disps).

    A call whose tensors all lie on one CUDA device, none requiring
    grad, without ``shards``, replays the steps as a CUDA graph captured
    on the first call of its shapes (:class:`_SolveGraph`); every other
    call runs them eagerly.  ``GRAPH_COUNTS`` counts both."""
    flat = [poses, disps, intrinsics, targets, weights, eta, disps_sens,
            *p, stereo_rel]
    if shards is None and _on_one_card(flat):
        key = (poses.device, iters, ep, lm,
               tuple(None if t is None else (t.shape, t.dtype)
                     for t in flat))
        with _GRAPH_LOCK:
            graph = _GRAPHS.get(key)
            if graph is None:
                with runtime.span("dba.capture"):
                    graph = _GRAPHS[key] = _SolveGraph(flat, iters, ep, lm)
            with runtime.span("dba.replay"):
                return graph.replay(flat)
    GRAPH_COUNTS["eager"] += 1
    return _iterations(poses, disps, intrinsics, targets, weights, eta,
                       disps_sens, p, iters, ep, lm, stereo_rel, shards)


def _iterations(poses, disps, intrinsics, targets, weights, eta,
                disps_sens, p: DBAPlan, iters: int, ep: float, lm: float,
                stereo_rel, shards):
    """The steps of :func:`dba_iterations`, launched op by op."""
    K = p.kx.shape[0]
    Hh, Ww = disps.shape[-2:]
    mask = (p.p_valid * (1 - p.p_fixed))[:, None]
    N = poses.shape[0]
    px_safe = torch.where(p.p_valid > 0, p.px, N)
    px_read = p.px.clamp(max=N - 1)       # padded slots past the buffer
    if shards is None:
        shards = [EdgeShard(p, targets, weights)]
    else:   # the interaction list spans every shard's edges
        p = p._replace(pair_a=None, pair_b=None, pair_valid=None)
    for _ in range(iters):
        (Hd, vd, Ehat, C, w), blocks = sharded_system(
            poses, disps, intrinsics, shards, p, eta, disps_sens,
            stereo_rel)
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


# ---------------------------------------------------------------------------
# the solve as one CUDA graph
# ---------------------------------------------------------------------------

# calls by path: graphs captured, graphs replayed, eager solves
GRAPH_COUNTS = {"capture": 0, "replay": 0, "eager": 0}
# one graph per device, iters, ep, lm and input shapes, kept for the
# process: a tracker's shapes are fixed by its config, and the trackers of
# successive sessions share their graph
_GRAPHS: dict = {}
_GRAPH_LOCK = threading.Lock()   # a graph's buffers serve one call at a time


def _on_one_card(flat) -> bool:
    """Whether a call with these tensors (and Nones) can replay a graph:
    all on one CUDA device, none requiring grad."""
    ts = [t for t in flat if t is not None]
    dev = ts[0].device
    return dev.type == "cuda" and all(
        t.device == dev and not t.requires_grad for t in ts)


class _SolveGraph:
    """:func:`_iterations` captured as one CUDA graph for one set of
    input shapes: static copies of the inputs (``flat``: the buffers,
    the plan's fields, the rig; Nones stay None), the graph, and the
    (poses, disps) it leaves in its own memory pool.

    PyTorch's pattern: an eager run on the capture stream first, so that
    the cuBLAS and cuSOLVER handles and workspaces exist, then the
    capture (``thread_local``: other threads' CUDA calls do not break it;
    in the pipeline the tracker captures holding ``DEVICE_LOCK``)."""

    def __init__(self, flat, iters: int, ep: float, lm: float):
        dev = flat[0].device
        with torch.inference_mode(False):
            self.static = [None if t is None else torch.empty_like(
                t, memory_format=torch.contiguous_format) for t in flat]
        self._copy_in(flat)
        args = (*self.static[:7], DBAPlan(*self.static[7:-1]), iters, ep,
                lm, self.static[-1], None)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            _iterations(*args)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=side,
                              capture_error_mode="thread_local"):
            self.out = _iterations(*args)
        torch.cuda.current_stream(dev).wait_stream(side)
        GRAPH_COUNTS["capture"] += 1

    def _copy_in(self, flat):
        torch._foreach_copy_([s for s in self.static if s is not None],
                             [t for t in flat if t is not None])

    def replay(self, flat):
        """The solve of ``flat``'s values: copied in, replayed on the
        current stream, (poses, disps) cloned out (the next replay
        overwrites the graph's own)."""
        self._copy_in(flat)
        self.graph.replay()
        GRAPH_COUNTS["replay"] += 1
        return self.out[0].clone(), self.out[1].clone()
