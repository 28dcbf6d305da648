"""Data-parallel NGP training over several devices.

Rays are split over the shards; each shard holds a replica of the field
on its own device, draws its ray samples from its own generator (seeded
from (seed, shard), the counterpart of the JAX package's ``fold_in(key,
axis_index)``), and computes its loss and gradients; the losses and the
gradients are averaged on the first shard's device in shard order (the
JAX ``pmean``), and the first replica takes the Adam step, whose
parameters every other replica then copies, so the replicas stay equal to
the bit.  One process drives every shard (``parallel/tracking.py`` says
why); a device listed more than once holds one replica.
"""
from __future__ import annotations

import copy

import numpy as np
import torch

from ..fusion.ngp import (NGPConfig, draw_ray_samples, init_ngp,
                          render_rays, sample_along_rays)
from ..ops.segment import reduce_in_order
from .tracking import shard_devices

RAY_KEYS = ("origins", "dirs", "rgb", "depth", "depth_w")


def shard_generator(seed: int, shard: int, device) -> torch.Generator:
    """Shard ``shard``'s sampling generator for the step seeded ``seed``."""
    state = np.random.SeedSequence([seed, shard]).generate_state(1)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def local_loss(field, cfg: NGPConfig, batch, draws) -> torch.Tensor:
    """The NGP loss of one shard's rays: squared color error plus the
    weighted squared depth error over the rays with a depth."""
    o, d, depth = batch["origins"], batch["dirs"], batch["depth"]
    dv = (depth > 0).float()
    t = sample_along_rays(depth, dv, cfg, draws)
    rgb, depth_r, _, _ = render_rays(field, cfg, o, d, t)
    l_rgb = torch.mean((rgb - batch["rgb"]) ** 2)
    l_d = torch.sum(batch["depth_w"] * dv * (depth_r - depth) ** 2) \
        / torch.clamp(dv.sum(), min=1.0)
    return cfg.rgb_weight * l_rgb + cfg.depth_weight * l_d


def make_dp_train_step(devices, field, cfg: NGPConfig, optimizer):
    """A data-parallel NGP train step over ``devices`` (one shard an
    entry); ``field`` lies on ``devices[0]`` and ``optimizer`` steps its
    parameters.

    Returns ``step(batch, seed, draws=None) -> loss``: ``batch`` is a dict
    of ray tensors (origins/dirs (R, 3), rgb (R, 3), depth (R,), depth_w
    (R,)) whose R rays split into ``len(devices)`` contiguous blocks;
    ``draws``, optional, gives each shard's sample draws (as
    ``fusion.ngp.draw_ray_samples`` returns them) in place of its
    generator's.  The loss is the shards' mean."""
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    replicas = {devices[0]: field}
    for dev in devices[1:]:
        if dev not in replicas:
            replicas[dev] = copy.deepcopy(field).to(dev)
    params = list(field.parameters())

    def step(batch, seed: int, draws=None):
        R = batch["origins"].shape[0]
        if R % n:
            raise ValueError(f"{R} rays do not divide into {n} shards")
        losses, grads = [], []
        for s, dev in enumerate(devices):
            rep = replicas[dev]
            sl = slice(s * R // n, (s + 1) * R // n)
            local = {k: batch[k][sl].to(dev) for k in RAY_KEYS}
            dr = (draws[s] if draws is not None else draw_ray_samples(
                R // n, cfg, shard_generator(seed, s, dev), dev))
            loss = local_loss(rep, cfg, local, [x.to(dev) for x in dr])
            losses.append(loss.detach())
            grads.append(torch.autograd.grad(loss, list(rep.parameters())))
        d0 = devices[0]
        loss = reduce_in_order([(x,) for x in losses], d0)[0] / n
        mean = reduce_in_order(grads, d0)
        optimizer.zero_grad(set_to_none=True)
        for p, g in zip(params, mean):
            p.grad = g / n
        optimizer.step()
        with torch.no_grad():
            for rep in replicas.values():
                if rep is not field:
                    for q, p in zip(rep.parameters(), params):
                        q.copy_(p)
        return loss

    return step


def dryrun(n_devices: int, device="cuda") -> float:
    """One data-parallel train step of a tiny hash field; returns the
    loss."""
    from ..fusion.hashgrid import HashGridConfig

    devices = shard_devices(n_devices, device)
    cfg = NGPConfig(n_uniform=8, n_depth=4, encoding="hash",
                    grid=HashGridConfig(n_levels=2, log2_table_size=8,
                                        base_resolution=4,
                                        finest_resolution=8))
    field = init_ngp(cfg, torch.Generator().manual_seed(0)).to(devices[0])
    opt = torch.optim.Adam(field.parameters(), lr=1e-2)
    R = 8 * n_devices
    gen = torch.Generator().manual_seed(1)
    batch = {"origins": torch.full((R, 3), 0.5),
             "dirs": torch.randn((R, 3), generator=gen) * 0.3,
             "rgb": torch.rand((R, 3), generator=gen),
             "depth": torch.full((R,), 0.4),
             "depth_w": torch.ones((R,))}
    step = make_dp_train_step(devices, field, cfg, opt)
    return float(step(batch, seed=1))
