"""Nonlinear solvers over the factor-graph layer (PyTorch).

Gauss-Newton, Levenberg-Marquardt, an iSAM2-style incremental smoother
with fluid relinearization, and batched weighted linear least squares.
A Cholesky factorization that fails (a matrix that is not positive
definite) gives NaN, as ``jax.scipy.linalg.cho_factor`` does, and the
solvers treat the NaN step as the JAX package's solvers do.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .factor_graph import FactorGraph, Variables, as_f32
from .schur import cho_solve


@dataclass
class SolverResult:
    variables: Variables
    error: float
    iterations: int
    converged: bool


class Solver:
    def solve(self, graph: FactorGraph, x0: Variables) -> SolverResult:
        raise NotImplementedError


class GaussNewton(Solver):
    """Plain Gauss-Newton with fixed damping."""

    def __init__(self, max_iters: int = 10, tol: float = 1e-8,
                 damping: float = 1e-8):
        self.max_iters = max_iters
        self.tol = tol
        self.damping = damping

    def solve(self, graph, x0):
        x = x0.copy()
        err = graph.error(x)
        it = 0
        for it in range(self.max_iters):
            H, b = graph.linearize_dense(x)
            H = H + self.damping * torch.eye(H.shape[0], device=H.device)
            dx = cho_solve(H, b)
            x_new = x.retract(dx)
            err_new = graph.error(x_new)
            if not np.isfinite(err_new):
                break
            x = x_new
            if abs(err - err_new) < self.tol * max(err, 1.0):
                err = err_new
                return SolverResult(x, err, it + 1, True)
            err = err_new
        return SolverResult(x, err, it + 1, False)


class LevenbergMarquardt(Solver):
    """Adaptive-damping Levenberg-Marquardt."""

    def __init__(self, max_iters: int = 20, tol: float = 1e-8,
                 lambda0: float = 1e-4, lambda_factor: float = 10.0):
        self.max_iters = max_iters
        self.tol = tol
        self.lambda0 = lambda0
        self.factor = lambda_factor

    def solve(self, graph, x0):
        x = x0.copy()
        lam = self.lambda0
        err = graph.error(x)
        it = 0
        for it in range(self.max_iters):
            H, b = graph.linearize_dense(x)
            improved = False
            for _ in range(8):
                Hd = H + lam * torch.diag(torch.clamp(torch.diag(H),
                                                      min=1e-10))
                x_new = x.retract(cho_solve(Hd, b))
                err_new = graph.error(x_new)
                if np.isfinite(err_new) and err_new < err:
                    x = x_new
                    rel = abs(err - err_new) / max(err, 1.0)
                    err = err_new
                    lam = max(lam / self.factor, 1e-12)
                    improved = True
                    if rel < self.tol:
                        return SolverResult(x, err, it + 1, True)
                    break
                lam *= self.factor
            if not improved:
                return SolverResult(x, err, it + 1, True)
        return SolverResult(x, err, it + 1, False)


class IncrementalSolver(Solver):
    """Incremental smoother with iSAM2's fluid relinearization:

    - every variable carries a linearization point and a tangent delta
      (host numpy); the estimate is ``retract(lin_point, delta)``;
    - every factor caches its whitened linearization (host float64) taken
      at its keys' linearization points;
    - ``update()`` linearizes only new factors and factors touching
      variables whose delta exceeded ``relin_thresh`` (their lin points
      advance and their deltas reset first); the rest reuse the cache;
    - the normal equations are assembled on the host from the cached
      blocks, one einsum per block signature, and solved densely.

    The fresh linearizations of an inner iteration come back from the
    device in ONE transfer.  ``stats`` counts relinearized and reused
    factors.
    """

    def __init__(self, relin_thresh: float = 0.02, damping: float = 1e-8,
                 inner_iters: int = 2):
        self.relin_thresh = relin_thresh
        self.damping = damping
        self.inner_iters = inner_iters
        self.estimate: Optional[Variables] = None
        self._lin_point: Optional[Variables] = None
        self._delta: dict = {}       # Key -> tangent vector (host float64)
        self._cache: dict = {}       # fid -> (r0, [J_k], version tuple)
        self._ver: dict = {}         # Key -> int, bumped on relinearization
        self.stats = {"relinearized": 0, "reused": 0, "updates": 0}

    def _absorb_new(self, new_values: Optional[Variables]):
        if self.estimate is None:
            assert new_values is not None, "first update needs values"
            self.estimate = Variables()
            self._lin_point = Variables()
        if new_values is None:
            return
        for k in new_values.keys():
            if k not in self.estimate._vals:
                t = new_values._types[k]
                self.estimate.insert(k, new_values.at(k), t)
                self._lin_point.insert(k, new_values.at(k), t)
                self._delta[k] = np.zeros(t.tangent_dim, np.float64)
                self._ver[k] = 0

    def _batch_retract(self, keys, deltas_np):
        """Retract the lin points at ``keys`` by ``deltas_np``, one batched
        retraction per variable type.  Returns {key: new value}."""
        by_type: dict = {}
        for k, d in zip(keys, deltas_np):
            by_type.setdefault(id(self._lin_point._types[k]),
                               []).append((k, d))
        out = {}
        for group in by_type.values():
            ks = [k for k, _ in group]
            t = self._lin_point._types[ks[0]]
            vals = torch.stack([self._lin_point.at(k) for k in ks])
            ds = as_f32(np.stack([d for _, d in group]), vals.device)
            new = t.retract(vals, ds)
            for i, k in enumerate(ks):
                out[k] = new[i]
        return out

    @staticmethod
    def _fetch(pending: dict) -> dict:
        """{fid: (r0, [J_k], ver)} on the device -> {fid: (r0, [J_k])} host
        float64, in one transfer."""
        parts = [t for r0, Js, _ in pending.values() for t in (r0, *Js)]
        flat = torch.cat([t.reshape(-1) for t in parts]).cpu().numpy()
        flat = flat.astype(np.float64)
        out, o = {}, 0
        for fid, (r0, Js, _) in pending.items():
            blocks = []
            for t in (r0, *Js):
                n = t.numel()
                blocks.append(flat[o:o + n].reshape(tuple(t.shape)))
                o += n
            out[fid] = (blocks[0], blocks[1:])
        return out

    def update(self, graph: FactorGraph,
               new_values: Optional[Variables] = None) -> SolverResult:
        """iSAM2-style incremental update (see the class docstring)."""
        self._absorb_new(new_values)
        if len(graph) == 0:
            return SolverResult(self.estimate, 0.0, 0, True)
        self.stats["updates"] += 1
        live = set(graph.factors.keys())
        for fid in [f for f in self._cache if f not in live]:
            del self._cache[fid]     # removed/replaced factors

        relin_count = 0
        for _ in range(self.inner_iters):
            # 1. advance the lin points of variables whose delta got large
            moved = [k for k, d in self._delta.items()
                     if np.max(np.abs(d)) > self.relin_thresh]
            if moved:
                new_vals = self._batch_retract(
                    moved, [self._delta[k] for k in moved])
                for k in moved:
                    self._lin_point._vals[k] = new_vals[k]
                    self._delta[k] = np.zeros_like(self._delta[k])
                    self._ver[k] += 1

            # 2. (re)linearize new factors and factors touching moved
            #    variables; fetch them all in one transfer
            pending = {}
            for fid, f in graph.factors.items():
                ver = tuple(self._ver[k] for k in f.keys)
                hit = self._cache.get(fid)
                if hit is not None and hit[2] == ver:
                    self.stats["reused"] += 1
                    continue
                r0, Js = f.linearize(self._lin_point)
                pending[fid] = (r0, Js, ver)
                self.stats["relinearized"] += 1
                relin_count += 1
            if pending:
                fetched = self._fetch(pending)
                for fid, (_, _, ver) in pending.items():
                    fr0, fJs = fetched[fid]
                    self._cache[fid] = (fr0, fJs, ver)

            # 3. assemble the normal equations in the joint tangent space
            #    (absolute deltas wrt the lin points): factors grouped by
            #    block signature, one einsum per group
            offs = self._lin_point.tangent_offsets()
            T = self._lin_point.tangent_dim
            H = np.zeros((T, T), np.float64)
            b = np.zeros((T,), np.float64)
            groups: dict = {}
            for fid, f in graph.factors.items():
                r0, Js, _ = self._cache[fid]
                sig = (r0.shape[0],) + tuple(J.shape[1] for J in Js)
                g = groups.setdefault(sig, ([], [], []))
                g[0].append(r0)
                g[1].append(Js)
                g[2].append([offs[k][0] for k in f.keys])
            Hf = H.reshape(-1)
            for sig, (r0s, Js_list, offs_list) in groups.items():
                A = len(sig) - 1                    # key arity
                R = np.stack(r0s)                   # (F, m)
                O = np.asarray(offs_list)           # (F, A)
                Jb = [np.stack([Js[a] for Js in Js_list])
                      for a in range(A)]            # A x (F, m, d_a)
                for a in range(A):
                    da = sig[1 + a]
                    ia = O[:, a:a + 1] + np.arange(da)      # (F, d_a)
                    np.add.at(b, ia.ravel(),
                              -np.einsum('frd,fr->fd', Jb[a], R).ravel())
                    for c in range(A):
                        dc = sig[1 + c]
                        ic = O[:, c:c + 1] + np.arange(dc)  # (F, d_c)
                        blk = np.einsum('fra,frc->fac', Jb[a], Jb[c])
                        flat = (ia[:, :, None] * T
                                + ic[:, None, :]).ravel()
                        np.add.at(Hf, flat, blk.ravel())
            H[np.diag_indices(T)] += self.damping
            try:
                d_full = np.linalg.solve(H, b)
            except np.linalg.LinAlgError:
                break
            if not np.all(np.isfinite(d_full)):
                break
            for k, (o, dk) in offs.items():
                self._delta[k] = d_full[o:o + dk]

        # 4. estimate = retract(lin_point, delta), batched per type
        ks = self._lin_point.keys()
        new_vals = self._batch_retract(ks, [self._delta[k] for k in ks])
        est = Variables()
        for k in ks:
            est.insert(k, new_vals[k], self._lin_point._types[k])
        self.estimate = est
        err = graph.error(est)
        return SolverResult(est, err, relin_count, True)

    def solve(self, graph, x0):
        return self.update(graph, x0)


class LinearLS:
    """Batched weighted linear least squares: argmin ||W^0.5 (A x - b)||."""

    @staticmethod
    def solve_cholesky(A: torch.Tensor, b: torch.Tensor,
                       w: Optional[torch.Tensor] = None,
                       damping: float = 1e-10) -> torch.Tensor:
        Aw = A * w[..., :, None] if w is not None else A
        H = Aw.transpose(-1, -2) @ A
        g = Aw.transpose(-1, -2) @ b[..., None]
        H = H + damping * torch.eye(H.shape[-1], dtype=H.dtype,
                                    device=H.device)
        return cho_solve(H, g[..., 0])
