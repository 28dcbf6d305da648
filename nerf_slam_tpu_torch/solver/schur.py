"""Damped block-Cholesky and Schur-complement solvers (PyTorch).

``block_solve`` solves the pose-only normal equations, ``schur_solve``
eliminates the per-pixel depths first.  Both are differentiable (Cholesky
and its triangular solves have autograd formulas), so they sit inside
the training unroll.  A reduced system that is not positive definite
gives a zero step, as the JAX package's ``schur_solve`` does: there the
factorization returns NaN; here ``cholesky_ex`` reports it (``info != 0``),
its partial factor is never used, and :func:`cho_solve` gives NaN too.
"""
from __future__ import annotations

import torch


def damp(H: torch.Tensor, ep: float = 0.1, lm: float = 1e-4) -> torch.Tensor:
    """H + (ep + lm * diag(H)) on the diagonal, batched over leading dims."""
    diag = torch.diagonal(H, dim1=-2, dim2=-1)
    eye = torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
    return H + eye * (ep + lm * diag)[..., None, :]


def cho_solve(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve H x = b by Cholesky, batched over leading dims; NaN where the
    factorization fails (``info != 0``) or is not finite, as JAX's
    ``cho_factor``/``cho_solve`` give."""
    L, info = torch.linalg.cholesky_ex(H)
    x = torch.cholesky_solve(b[..., None], L)[..., 0]
    ok = (info == 0)[..., None] & torch.isfinite(x).all(-1, keepdim=True)
    return torch.where(ok, x, torch.full_like(x, float("nan")))


def block_solve(H: torch.Tensor, b: torch.Tensor, ep: float = 0.1,
                lm: float = 1e-4) -> torch.Tensor:
    """Pose-only normal equations: H (N, N, D, D), b (N, D) -> dx (N, D);
    NaN where the damped system is not positive definite, as in JAX."""
    N, _, D, _ = H.shape
    Hd = damp(H.permute(0, 2, 1, 3).reshape(N * D, N * D), ep, lm)
    return cho_solve(Hd, b.reshape(N * D)).reshape(N, D)


def schur_solve(H: torch.Tensor, E: torch.Tensor, C: torch.Tensor,
                v: torch.Tensor, w: torch.Tensor, ep: float = 0.1,
                lm: float = 1e-4):
    """Solve the full (pose, depth) system by eliminating the depths.

    H: (P, P, D, D) pose-pose blocks; E: (P, M, D, HW) pose-depth
    coupling; C: (M, HW) depth diagonal; v: (P, D), w: (M, HW) right-hand
    sides.  Returns (dx (P, D), dz (M, HW)); both zero when the reduced
    system is not positive definite (a zero step, not a NaN unroll).
    """
    P, M, D, HW = E.shape
    Hd = damp(H.permute(0, 2, 1, 3).reshape(P * D, P * D), ep, lm)
    Ed = E.permute(0, 2, 1, 3).reshape(P * D, M * HW)
    Q = 1.0 / C.reshape(M * HW)
    vd = v.reshape(P * D)
    wd = w.reshape(M * HW)

    S = Hd - Ed @ (Q[:, None] * Ed.T)
    rhs = vd - Ed @ (Q * wd)
    dx = cho_solve(S, rhs)
    ok = torch.isfinite(dx).all()
    dx = torch.where(ok, dx, torch.zeros_like(dx))
    dz = Q * (wd - Ed.T @ dx)
    dz = torch.where(ok, dz, torch.zeros_like(dz))
    return dx.reshape(P, D), dz.reshape(M, HW)
