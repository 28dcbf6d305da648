"""Generic factor-graph layer with autodiff Jacobians (PyTorch).

Hashable keys, a ``Variables`` store with a retraction per variable type,
a ``Factor`` base whose tangent Jacobians come from forward-mode autodiff
(``torch.func.jacfwd``) through each variable's retraction at zero, robust
loss weights, and a graph that stacks residuals and whitened Jacobians for
the nonlinear solvers (``solver/nonlinear.py``).

Residuals and Jacobians are f32, as the JAX package computes them; values
live on the device they were inserted on (``Variables.to`` and
``Factor.to`` move them).
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..geometry import se3


def as_f32(value, device=None) -> torch.Tensor:
    """``value`` as an f32 tensor (on ``device`` when given, else where it
    lies; host arrays go to the CPU)."""
    return torch.as_tensor(value, dtype=torch.float32, device=device)


@dataclass(frozen=True)
class Key:
    """Hashable variable key."""
    name: str
    idx: int = 0

    def __repr__(self):
        return f"{self.name}{self.idx}"


class VariableType:
    """Manifold spec: ambient dim, tangent dim, retraction."""

    def __init__(self, dim: int, tangent_dim: int,
                 retract: Callable[[torch.Tensor, torch.Tensor],
                                   torch.Tensor]):
        self.dim = dim
        self.tangent_dim = tangent_dim
        self.retract = retract


# a new type on every call: the incremental solver groups by type identity
VECTOR = lambda d: VariableType(d, d, lambda x, dx: x + dx)  # noqa: E731
SE3_VAR = VariableType(7, 6, se3.retr)


class Variables:
    """Ordered key -> (value, type) store with block retraction."""

    def __init__(self):
        self._vals: Dict[Key, torch.Tensor] = {}
        self._types: Dict[Key, VariableType] = {}

    def insert(self, key: Key, value, vtype: VariableType):
        self._vals[key] = as_f32(value)
        self._types[key] = vtype
        return self

    def at(self, key: Key) -> torch.Tensor:
        return self._vals[key]

    def keys(self) -> List[Key]:
        return list(self._vals.keys())

    def tangent_offsets(self) -> Dict[Key, Tuple[int, int]]:
        out = {}
        o = 0
        for k in self._vals:
            d = self._types[k].tangent_dim
            out[k] = (o, d)
            o += d
        return out

    @property
    def tangent_dim(self) -> int:
        return sum(t.tangent_dim for t in self._types.values())

    def retract(self, delta: torch.Tensor) -> "Variables":
        out = Variables()
        for k, (o, d) in self.tangent_offsets().items():
            out.insert(k, self._types[k].retract(self._vals[k],
                                                 delta[o:o + d]),
                       self._types[k])
        return out

    def copy(self) -> "Variables":
        out = Variables()
        out._vals = dict(self._vals)
        out._types = dict(self._types)
        return out

    def to(self, device) -> "Variables":
        out = self.copy()
        out._vals = {k: v.to(device) for k, v in out._vals.items()}
        return out


class LossFunction:
    """Robust weight rho'(r^2)."""

    def weight(self, sq_norm: torch.Tensor) -> torch.Tensor:
        return torch.ones_like(sq_norm)


class TrivialLoss(LossFunction):
    pass


class CauchyLoss(LossFunction):
    def __init__(self, k: float = 1.0):
        self.k2 = k * k

    def weight(self, sq_norm):
        return self.k2 / (self.k2 + sq_norm)


class GemanMcClureLoss(LossFunction):
    def __init__(self, k: float = 1.0):
        self.k2 = k * k

    def weight(self, sq_norm):
        return (self.k2 / (self.k2 + sq_norm)) ** 2


class Factor:
    """Residual factor over a set of keys.

    Subclasses implement ``residual(*values) -> r`` in ambient space; the
    tangent-space Jacobian comes from autodiff through each variable's
    retraction at zero.  Constant tensors a subclass holds move with
    :meth:`to`.  A subclass whose residual broadcasts over a leading batch
    dim names its per-factor constants in ``stacked`` (a tuple): the
    graph's error then evaluates all its factors in one call.
    """

    stacked = None

    def __init__(self, keys: Sequence[Key],
                 loss: Optional[LossFunction] = None,
                 sigma: float = 1.0):
        self.keys = list(keys)
        self.loss = loss or TrivialLoss()
        self.sigma = sigma

    def residual(self, *values) -> torch.Tensor:
        raise NotImplementedError

    def batch_key(self):
        """Factors with one key evaluate in one batched residual call."""
        if self.stacked is None:
            return None
        return (type(self), len(self.keys)) + tuple(
            tuple(getattr(self, n).shape) if isinstance(
                getattr(self, n), torch.Tensor) else () for n in self.stacked)

    @staticmethod
    def batched(factors: Sequence["Factor"], device) -> "Factor":
        """A copy of ``factors[0]`` whose ``stacked`` constants are those
        of all ``factors``, stacked on a leading dim (floats as (F, 1) on
        ``device``)."""
        out = copy.copy(factors[0])
        for n in out.stacked:
            vals = [getattr(f, n) for f in factors]
            if isinstance(vals[0], torch.Tensor):
                setattr(out, n, torch.stack(vals))
            else:
                setattr(out, n, as_f32([[v] for v in vals], device))
        return out

    def to(self, device) -> "Factor":
        for name, v in vars(self).items():
            if isinstance(v, torch.Tensor):
                setattr(self, name, v.to(device))
        return self

    def linearize(self, variables: Variables):
        """Returns (r (m,), [J_k (m, t_k)]) whitened by 1/sigma and the
        robust weight's square root."""
        vals = [variables.at(k) for k in self.keys]
        types = [variables._types[k] for k in self.keys]

        def res_of_deltas(*deltas):
            r = self.residual(*[t.retract(v, d) for v, t, d in
                                zip(vals, types, deltas)])
            return r, r

        zeros = [torch.zeros(t.tangent_dim, dtype=torch.float32,
                             device=v.device) for v, t in zip(vals, types)]
        Js, r = torch.func.jacfwd(res_of_deltas,
                                  argnums=tuple(range(len(zeros))),
                                  has_aux=True)(*zeros)
        w = self.loss.weight(torch.sum(r * r))
        scale = torch.sqrt(w) / self.sigma
        # f32 as r: a 0-dim tangent times a Python float promotes to f64
        return scale * r, [scale * J.to(r.dtype) for J in Js]


class PriorFactor(Factor):
    """||log(x prior^-1)|| for SE3, x - prior for vectors."""

    stacked = ("prior",)

    def __init__(self, key: Key, prior, vtype: VariableType,
                 sigma: float = 1.0, loss=None):
        super().__init__([key], loss, sigma)
        self.prior = as_f32(prior)
        self.vtype = vtype

    def batch_key(self):
        return super().batch_key() + (self.vtype is SE3_VAR,)

    def residual(self, x):
        if self.vtype is SE3_VAR:
            return se3.log(se3.mul(x, se3.inv(self.prior)))
        return x - self.prior


class BetweenFactorSE3(Factor):
    """Relative-pose factor: log((xj xi^-1) meas^-1)."""

    stacked = ("measured",)

    def __init__(self, ki: Key, kj: Key, measured, sigma: float = 1.0,
                 loss=None):
        super().__init__([ki, kj], loss, sigma)
        self.measured = as_f32(measured)

    def residual(self, xi, xj):
        rel = se3.mul(xj, se3.inv(xi))
        return se3.log(se3.mul(rel, se3.inv(self.measured)))


class FactorGraph:
    """Nonlinear factor graph: add/replace/remove by id, dense (H, b)."""

    def __init__(self):
        self.factors: Dict[int, Factor] = {}
        self._next = 0

    def add(self, factor) -> int:
        """Add a factor or a list of factors; returns the (first) id."""
        if isinstance(factor, (list, tuple)):
            return [self.add(f) for f in factor][0]
        fid = self._next
        self.factors[fid] = factor
        self._next += 1
        return fid

    def replace(self, fid: int, factor: Factor):
        self.factors[fid] = factor

    def remove(self, fid: int):
        self.factors.pop(fid, None)

    def reset(self):
        self.factors.clear()

    def __len__(self):
        return len(self.factors)

    def error(self, variables: Variables) -> float:
        """Sum of squared whitened residuals: each factor's f32 sum on the
        device (the factors of one batchable class in one residual call),
        fetched in one transfer and added on the host in factor order."""
        if not self.factors:
            return 0.0
        groups: Dict = {}
        for i, f in enumerate(self.factors.values()):
            key = f.batch_key()
            groups.setdefault(i if key is None else key, []).append((i, f))
        order, sums = [], []
        for members in groups.values():
            idx, fs = zip(*members)
            vals = [torch.stack([variables.at(f.keys[a]) for f in fs])
                    for a in range(len(fs[0].keys))]
            if fs[0].stacked is None:
                r = fs[0].residual(*[v[0] for v in vals])[None]
            else:
                r = Factor.batched(fs, vals[0].device).residual(*vals)
            sigma = as_f32([[f.sigma] for f in fs], r.device)
            sums.append(torch.sum((r / sigma) ** 2, dim=-1))
            order.extend(idx)
        per = torch.cat(sums).cpu().tolist()
        tot = 0.0
        for i in sorted(range(len(order)), key=order.__getitem__):
            tot += per[i]
        return tot

    def linearize_dense(self, variables: Variables):
        """Gauss-Newton normal equations: H (T, T), b (T,), f32."""
        offs = variables.tangent_offsets()
        T = variables.tangent_dim
        dev = next(iter(variables._vals.values())).device
        H = torch.zeros((T, T), dtype=torch.float32, device=dev)
        b = torch.zeros((T,), dtype=torch.float32, device=dev)
        for f in self.factors.values():
            r, Js = f.linearize(variables)
            for k_a, J_a in zip(f.keys, Js):
                oa, da = offs[k_a]
                b[oa:oa + da] += -J_a.T @ r
                for k_b, J_b in zip(f.keys, Js):
                    ob, db = offs[k_b]
                    H[oa:oa + da, ob:ob + db] += J_a.T @ J_b
        return H, b
