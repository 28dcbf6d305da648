"""Edge-sharded dense bundle adjustment over several devices.

The DBA cost is the per-edge linearization and the edge sums of the
window-local system, both independent across edges.  The edge axis is
split into shards: each shard linearizes its edges and sums them on its
own device, the five accumulators (Hd, vd, Ehat, C, w) are reduced on the
first shard's device in shard order, the priors are added once, and the
small reduced camera solve runs there (``solver/dba.py``: ``EdgeShard``,
``sharded_system``).  The counterpart of the JAX package's ``shard_map``
over a mesh axis with ``psum`` reductions.

One process drives every shard, as ``shard_map`` does from one
controller: the reductions are copies to the first shard's device and
adds in a fixed order, not collectives of a process group (NCCL refuses
two ranks on one GPU, and a CPU backend would bounce every reduction
through the host).  Shard ``s`` runs on ``devices[s % k]`` of the ``k``
visible devices of the tracker's type (:func:`shard_devices`): on one card
every shard shares it.  The dense Schur complement is used, since the
sparse interaction list spans every shard's edges.
"""
from __future__ import annotations

from collections import Counter
from typing import List

import numpy as np
import torch

from ..geometry import se3
from ..solver import dba


def _index(d: torch.device) -> int:
    return d.index if d.index is not None else torch.cuda.current_device()


def shard_devices(n: int, base="cuda") -> List[torch.device]:
    """The device of each of ``n`` shards: round robin over the visible
    devices of ``base``'s type, starting at ``base``, which every shard
    on that device gets as it is (shard 0 shares the caller's device,
    where the reductions run)."""
    base = torch.device(base)
    if base.type != "cuda":
        return [base] * n
    k = torch.cuda.device_count()
    first = _index(base)
    return [base if s % k == 0 else torch.device("cuda", (first + s) % k)
            for s in range(n)]


def placement(devices: List[torch.device]) -> str:
    """``over 1 device: cuda:0 x2``-style summary of a shard placement."""
    counts = Counter(f"cuda:{_index(d)}" if d.type == "cuda" else str(d)
                     for d in devices)
    k = len(counts)
    return (f"over {k} device{'s' if k > 1 else ''}: "
            + ", ".join(f"{d} x{c}" for d, c in counts.items()))


def shard_plan(plan: dba.DBAPlan, idx, device) -> dba.DBAPlan:
    """The plan of the edges ``idx`` (a slice, or indices on the plan's
    device) on ``device``: their rows of the edge-major arrays, the pose-
    and depth-slot arrays replicated, no interaction list."""
    edge = {k: getattr(plan, k)[idx].to(device)
            for k in ("ii", "jj", "pi", "pj", "kk", "edge_valid")}
    slots = {k: getattr(plan, k).to(device)
             for k in ("px", "p_valid", "p_fixed", "kx", "k_valid")}
    return dba.DBAPlan(**edge, **slots)


def make_sharded_dba_step(devices, ep: float = 0.1, lm: float = 1e-4):
    """One edge-sharded Gauss-Newton DBA step over ``devices``, one shard
    a device entry (repeats allowed).

    Returns ``run(poses, disps, intrinsics, targets, weights, eta,
    disps_sens, plan) -> (poses, disps)``, the arguments as for
    ``solver.dba.dba_iterations``: shard ``s`` takes the ``s``-th of
    ``len(devices)`` contiguous blocks of the edge axis, whose capacity
    must divide by it; the result lies on ``devices[0]``.  The plan's
    interaction list is dropped (dense Schur)."""
    devices = [torch.device(d) for d in devices]
    n = len(devices)

    def run(poses, disps, intrinsics, targets, weights, eta, disps_sens,
            plan):
        E = plan.ii.shape[0]
        if E % n:
            raise ValueError(f"edge capacity {E} does not divide into "
                             f"{n} shards")
        d0 = devices[0]
        plan = shard_plan(plan, slice(None), d0)
        shards = []
        for s, dev in enumerate(devices):
            sl = slice(s * E // n, (s + 1) * E // n)
            shards.append(dba.EdgeShard(shard_plan(plan, sl, dev),
                                        targets[sl].to(dev),
                                        weights[sl].to(dev)))
        return dba.dba_iterations(
            poses.to(d0), disps.to(d0), intrinsics.to(d0), None, None,
            eta.to(d0), disps_sens.to(d0), plan, iters=1, ep=ep, lm=lm,
            shards=shards)

    return run


def dryrun(n_devices: int, device="cuda") -> float:
    """One sharded DBA step on tiny shapes; returns the largest pose
    error after the step over the one before it (below 1 when the step
    converges)."""
    from ..geometry import camera

    devices = shard_devices(n_devices, device)
    dev = devices[0]
    gen = torch.Generator().manual_seed(0)
    n, h, w = 4, 6, 8
    poses_gt = se3.exp(0.05 * torch.randn((n, 6), generator=gen)).to(dev)
    disps = 0.8 * torch.ones((n, h, w), device=dev)
    intr = torch.tensor([[10.0, 10.0, w / 2, h / 2]], device=dev).repeat(
        n, 1)
    ii = np.array([0, 1, 2, 1, 2, 3])
    jj = np.array([1, 2, 3, 0, 1, 2])
    E = 2 * n_devices * max(1, (len(ii) + 2 * n_devices - 1)
                            // (2 * n_devices))
    plan = dba.plan(ii, jj, 0, n, E=E, P=n, K=n, device=dev)
    target, valid, _ = camera.projective_transform(
        poses_gt, disps, intr, torch.as_tensor(ii, device=dev),
        torch.as_tensor(jj, device=dev))
    tpad = torch.zeros((E, h, w, 2), device=dev)
    wpad = torch.zeros((E, h, w, 2), device=dev)
    tpad[:len(ii)] = target
    wpad[:len(ii)] = torch.ones_like(target) * valid
    noise = 0.01 * torch.randn((n, 6), generator=gen)
    noise[0] = 0.0
    poses0 = se3.retr(poses_gt, noise.to(dev))
    eta = 1e-4 * torch.ones((n, h, w), device=dev)
    sens = torch.zeros((n, h, w), device=dev)

    poses1, disps1 = make_sharded_dba_step(devices)(
        poses0, disps, intr, tpad, wpad, eta, sens, plan)
    if not (torch.isfinite(poses1).all() and torch.isfinite(disps1).all()):
        raise RuntimeError("the sharded DBA step gave non-finite values")

    def err(p):
        return float(se3.log(se3.mul(p, se3.inv(poses_gt))).abs().max())

    return err(poses1) / max(err(poses0), 1e-12)
