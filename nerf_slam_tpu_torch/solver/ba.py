"""Dense bundle adjustment, training-style API (PyTorch).

One Gauss-Newton step on (keyframe poses, per-pixel inverse depths) given
the GRU's flow targets and confidence weights: the BA of the training
unroll (``models/training.py``), differentiable end to end.  The per-edge
blocks are pooled into the block system by ``ops/segment.py`` sums (one
one-hot product each, in a fixed order: no atomics, forward or backward).

All shapes are static; an edge is masked out by zero weights.
"""
from __future__ import annotations

import torch

from ..geometry import camera, se3
from ..ops.segment import segment_sum
from .schur import block_solve, schur_solve


def _scatter_mat(A, ii, jj, n, m):
    """Sum the (E, D1, D2) blocks into an (n, m, D1, D2) grid by (ii, jj);
    out-of-range indices are dropped."""
    valid = (ii >= 0) & (jj >= 0) & (ii < n) & (jj < m)
    idx = torch.where(valid, ii * m + jj, -1)
    return segment_sum(A, idx, n * m).reshape((n, m) + tuple(A.shape[1:]))


def _scatter_vec(b, ii, n):
    return segment_sum(b, torch.where((ii >= 0) & (ii < n), ii, -1), n)


def build_system(target, weight, poses, disps, intrinsics, ii, jj):
    """Linearize the reprojection residuals of all edges.

    target/weight: (E, H, W, 2).  Returns the per-edge blocks (Hii, Hij,
    Hji, Hjj (E,6,6)), (vi, vj (E,6)), (Ei, Ej (E,6,HW)), (Ck, wk (E,HW)),
    in DROID's tangent order.
    """
    E = ii.shape[0]
    H, W = disps.shape[-2:]
    HW = H * W

    coords, valid, (Ji, Jj, Jz) = camera.projective_transform(
        poses, disps, intrinsics, ii, jj, jacobian=True)

    r = target - coords                             # (E,H,W,2)
    w = 0.001 * (valid * weight)

    # pixels and coords flattened into one residual axis of length HW*2
    Jif = Ji.reshape(E, HW * 2, 6)
    Jjf = Jj.reshape(E, HW * 2, 6)
    Jzf = Jz.reshape(E, HW, 2)
    rf = r.reshape(E, HW * 2)
    wf = w.reshape(E, HW * 2)

    wJi = wf[..., None] * Jif
    wJj = wf[..., None] * Jjf

    Hii = torch.einsum("enc,end->ecd", wJi, Jif)
    Hij = torch.einsum("enc,end->ecd", wJi, Jjf)
    Hji = torch.einsum("enc,end->ecd", wJj, Jif)
    Hjj = torch.einsum("enc,end->ecd", wJj, Jjf)

    vi = torch.einsum("enc,en->ec", wJi, rf)
    vj = torch.einsum("enc,en->ec", wJj, rf)

    w2 = w.reshape(E, HW, 2)
    r2 = r.reshape(E, HW, 2)
    Ei = torch.einsum("ehx,ehx,ehxc->ech", w2, Jzf, Ji.reshape(E, HW, 2, 6))
    Ej = torch.einsum("ehx,ehx,ehxc->ech", w2, Jzf, Jj.reshape(E, HW, 2, 6))

    Ck = torch.einsum("ehx,ehx,ehx->eh", w2, Jzf, Jzf)
    wk = torch.einsum("ehx,ehx,ehx->eh", w2, r2, Jzf)

    return (Hii, Hij, Hji, Hjj), (vi, vj), (Ei, Ej), (Ck, wk)


def _pose_system(blocks, vecs, ii, jj, P, fixedp):
    """The pose blocks and right-hand side with the first ``fixedp``
    poses fixed."""
    Hii, Hij, Hji, Hjj = blocks
    vi, vj = vecs
    iis, jjs = ii - fixedp, jj - fixedp
    Hb = (_scatter_mat(Hii, iis, iis, P, P)
          + _scatter_mat(Hij, iis, jjs, P, P)
          + _scatter_mat(Hji, jjs, iis, P, P)
          + _scatter_mat(Hjj, jjs, jjs, P, P))
    vb = _scatter_vec(vi, iis, P) + _scatter_vec(vj, jjs, P)
    return Hb, vb


def _retract(poses, dx, fixedp):
    zeros = torch.zeros((fixedp, 6), dtype=dx.dtype, device=dx.device)
    return se3.retr(poses, torch.cat([zeros, dx], dim=0))


def ba_step(target, weight, eta, poses, disps, intrinsics, ii, jj,
            fixedp: int = 1, ep: float = 0.1, lm: float = 1e-4):
    """One full-BA Gauss-Newton step over every pose but the first
    ``fixedp`` and every depth map of the buffer.

    eta: (N, H, W) per-depth damping; ``ii`` indexes depth slots 0..N-1
    of the whole buffer, and a depth map no edge touches gets no update.
    Returns (poses, disps).
    """
    N = poses.shape[0]
    H, W = disps.shape[-2:]
    HW = H * W
    P = N - fixedp

    blocks, vecs, (Ei, Ej), (Ck, wk) = build_system(
        target, weight, poses, disps, intrinsics, ii, jj)
    Hb, vb = _pose_system(blocks, vecs, ii, jj, P, fixedp)

    # depth maps: one slot per buffer entry (untouched slots have C = eta
    # and w = 0, hence dz = 0)
    iis, jjs = ii - fixedp, jj - fixedp
    Eb = (_scatter_mat(Ei, iis, ii, P, N)
          + _scatter_mat(Ej, jjs, ii, P, N))          # (P,N,6,HW)
    C = _scatter_vec(Ck, ii, N) + eta.reshape(N, HW) + 1e-7
    w = _scatter_vec(wk, ii, N)

    dx, dz = schur_solve(Hb, Eb, C, vb, w, ep=ep, lm=lm)

    poses = _retract(poses, dx, fixedp)
    disps = disps + dz.reshape(N, H, W)
    disps = torch.where(disps > 10.0, torch.zeros_like(disps), disps)
    return poses, torch.clamp(disps, min=0.0)


def moba_step(target, weight, poses, disps, intrinsics, ii, jj,
              fixedp: int = 1, ep: float = 0.1, lm: float = 1e-4):
    """Motion-only BA step: the poses move, the depths stay."""
    N = poses.shape[0]
    blocks, vecs, _, _ = build_system(target, weight, poses, disps,
                                      intrinsics, ii, jj)
    Hb, vb = _pose_system(blocks, vecs, ii, jj, N - fixedp, fixedp)
    return _retract(poses, block_solve(Hb, vb, ep=ep, lm=lm), fixedp)
