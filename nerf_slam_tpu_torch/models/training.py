"""DROID training: BA-in-the-loop unrolled updates, losses, optimizer.

The training forward unrolls ``num_steps`` update iterations with two
differentiable BA steps each (``solver/ba.py``) and supervises them with
the scale-fitted geodesic pose loss, the flow loss and the residual loss
of the DROID recipe, as the JAX package's ``models/training.py`` does.
Everything between the images and the losses is differentiable in
PyTorch autograd; the correlation lookup is the one-hot product
(``ops/corr.lookup_level_onehot``), whose backward has no atomics.

The optimizer is optax's chain written out: ``zero_nans`` ->
``clip_by_global_norm`` -> ``adam`` under a warmup-cosine schedule
(:class:`Optimizer`), with the weight EMA of the curriculum trainer.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, NamedTuple, Sequence

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..geometry import camera, se3
from ..ops import corr
from ..solver import ba
from .update import DroidNet

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_images(images_u8: torch.Tensor) -> torch.Tensor:
    x = images_u8.to(torch.float32) / 255.0
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)
    std = torch.tensor(IMAGENET_STD, device=x.device)
    return (x - mean) / std


def fit_scale(dP: torch.Tensor, dG: torch.Tensor) -> torch.Tensor:
    """Least-squares scale aligning estimated to GT translations."""
    t1 = dP[..., :3].reshape(-1)
    t2 = dG[..., :3].reshape(-1)
    return torch.sum(t1 * t2) / (torch.sum(t2 * t2) + 1e-8)


def geodesic_loss(poses_gt, poses_list, ii, jj, gamma: float = 0.9,
                  do_scale: bool = True):
    """Weighted relative-pose loss over the iterates; poses (N, 7)
    cam_T_world.  Returns (loss, metrics of the last iterate)."""
    dP = se3.relpose(poses_gt[ii], poses_gt[jj])
    n = len(poses_list)
    loss = 0.0
    for i, Gs in enumerate(poses_list):
        w = gamma ** (n - i - 1)
        dG = se3.relpose(Gs[ii], Gs[jj])
        if do_scale:
            s = fit_scale(dP, dG)
            dG = torch.cat([dG[..., :3] * s, dG[..., 3:]], dim=-1)
        d = se3.log(se3.mul(dG, se3.inv(dP)))
        tau = torch.linalg.norm(d[..., :3], dim=-1)
        phi = torch.linalg.norm(d[..., 3:], dim=-1)
        loss = loss + w * (tau.mean() + phi.mean())
    return loss, {"rot_error_deg": torch.rad2deg(phi).mean(),
                  "tr_error": tau.mean()}


def flow_loss(poses_gt, disps_gt, poses_list, disps_list, intrinsics,
              ii, jj, gamma: float = 0.9):
    """End-point error against the ground truth's induced flow."""
    coords0, val0, _ = camera.projective_transform(
        poses_gt, disps_gt, intrinsics, ii, jj)
    val0 = val0[..., 0] * (disps_gt[ii] > 0)
    n = len(poses_list)
    loss = 0.0
    epe = None
    for i, (Gs, ds) in enumerate(zip(poses_list, disps_list)):
        w = gamma ** (n - i - 1)
        coords1, val1, _ = camera.projective_transform(
            Gs, ds, intrinsics, ii, jj)
        v = val0 * val1[..., 0]
        epe = torch.linalg.norm(coords1 - coords0, dim=-1) * v
        loss = loss + w * epe.mean()
    return loss, {"epe": epe.sum() / torch.clamp(val0.sum(), min=1.0)}


def residual_loss(residuals, gamma: float = 0.9):
    n = len(residuals)
    loss = 0.0
    for i, r in enumerate(residuals):
        loss = loss + gamma ** (n - i - 1) * r.abs().mean()
    return loss


class TrainBatch(NamedTuple):
    images: torch.Tensor       # (N, H, W, 3) uint8
    poses_gt: torch.Tensor     # (N, 7) cam_T_world
    disps_gt: torch.Tensor     # (N, h, w) GT inverse depth (feature res)
    intrinsics: torch.Tensor   # (N, 4) feature-res intrinsics

    def to(self, device) -> "TrainBatch":
        return TrainBatch(*(t.to(device) for t in self))


def droid_forward(net: DroidNet, batch: TrainBatch, ii, jj,
                  num_steps: int = 8, fixedp: int = 2, remat: bool = False,
                  bf16_pyramid: bool = False):
    """Unrolled training forward.  ``remat`` recomputes each iteration in
    the backward (``torch.utils.checkpoint``) so high-resolution phases
    fit; ``bf16_pyramid`` builds the correlation pyramid in bf16 from
    pooled features, as the tracker stores it.

    ii, jj: (E,) int64 edges on the batch's device.  Returns (poses_list,
    disps_list, residual_list).
    """
    N, H, W, _ = batch.images.shape
    h, w = H // 8, W // 8
    dev = batch.images.device

    imgs = normalize_images(batch.images)
    fmaps = net.features(imgs)
    ctx, inp = net.context(imgs)

    f = fmaps.permute(0, 3, 1, 2)
    if bf16_pyramid:
        levels = corr.build_pyramid_bf16(f[ii], f[jj])
    else:
        levels = corr.build_pyramid(corr.build_volume(f[ii], f[jj]))
    cp = corr.CorrPyramid(levels, onehot=True)

    coords0 = camera.coords_grid(h, w, device=dev)
    poses = torch.cat([batch.poses_gt[:fixedp],
                       se3.identity((N - fixedp,), device=dev)], dim=0)
    disps = torch.ones((N, h, w), device=dev)

    net_h = ctx[ii].to(torch.bfloat16)
    inp_i = inp[ii].to(torch.bfloat16)
    # the context's share of the GRU gates is constant over the unroll
    gates_inp = net.update_precompute(inp_i)

    # depth-map segment of each edge: its unique source frame
    kx, kk_inv = np.unique(ii.cpu().numpy(), return_inverse=True)
    seg = torch.as_tensor(kk_inv, device=dev)
    K = int(kx.shape[0])
    kx_t = torch.as_tensor(kx, device=dev)

    coords1, _, _ = camera.projective_transform(
        poses, disps, batch.intrinsics, ii, jj)
    target = coords1

    def one_step(net_h, coords1, target, poses, disps):
        coords1, target = coords1.detach(), target.detach()
        poses, disps = poses.detach(), disps.detach()

        cvals = cp(coords1).permute(0, 2, 3, 1).to(torch.bfloat16)
        motion = torch.clamp(torch.cat([coords1 - coords0,
                                        target - coords1], -1), -64.0, 64.0)
        net_h, delta, weight, eta = net.update(
            net_h, inp_i, cvals, motion.to(torch.bfloat16), seg, K,
            with_upmask=False, gates_inp=gates_inp)

        target = coords1 + delta
        eta_full = torch.full((N, h, w), 1e-4, device=dev).index_put(
            (kx_t,), eta)
        for _ in range(2):
            poses, disps = ba.ba_step(
                target, weight, eta_full, poses, disps, batch.intrinsics,
                ii, jj, fixedp=fixedp, ep=0.1, lm=1e-4)

        coords1, valid, _ = camera.projective_transform(
            poses, disps, batch.intrinsics, ii, jj)
        residual = (target - coords1) * valid
        return net_h, coords1, target, poses, disps, residual

    poses_list, disps_list, residual_list = [], [], []
    for _ in range(num_steps):
        args = (net_h, coords1, target, poses, disps)
        out = (checkpoint(one_step, *args, use_reentrant=False) if remat
               else one_step(*args))
        net_h, coords1, target, poses, disps, residual = out
        residual_list.append(residual)
        poses_list.append(poses)
        disps_list.append(disps)
    return poses_list, disps_list, residual_list


def droid_loss(net: DroidNet, batch: TrainBatch, ii, jj,
               num_steps: int = 8, w_pose: float = 10.0,
               w_flow: float = 0.1, w_res: float = 0.01,
               remat: bool = False, bf16_pyramid: bool = False):
    """Total training loss (the DROID recipe's weights) and metrics."""
    poses_list, disps_list, residuals = droid_forward(
        net, batch, ii, jj, num_steps, remat=remat,
        bf16_pyramid=bf16_pyramid)
    lg, mg = geodesic_loss(batch.poses_gt, poses_list, ii, jj)
    lf, mf = flow_loss(batch.poses_gt, batch.disps_gt, poses_list,
                       disps_list, batch.intrinsics, ii, jj)
    lr = residual_loss(residuals)
    loss = w_pose * lg + w_flow * lf + w_res * lr
    metrics = {"loss": loss, "geodesic": lg, "flow": lf, "residual": lr,
               **mg, **mf}
    return loss, metrics


def _detached(metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach() for k, v in metrics.items()}


def grad_fn(net: DroidNet, batch: TrainBatch, ii, jj, num_steps: int = 8,
            remat: bool = False, bf16_pyramid: bool = False):
    """(grads, metrics) of ONE scene, the accumulation unit: grads are
    f32 tensors in ``net.parameters()`` order."""
    params = list(net.parameters())
    loss, metrics = droid_loss(net, batch, ii, jj, num_steps, remat=remat,
                               bf16_pyramid=bf16_pyramid)
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params, grads)]
    return grads, _detached(metrics)


@torch.no_grad()
def eval_fn(net: DroidNet, batch: TrainBatch, ii, jj, num_steps: int = 8,
            bf16_pyramid: bool = False) -> Dict[str, torch.Tensor]:
    """Loss and metrics only (held-out scenes)."""
    return _detached(droid_loss(net, batch, ii, jj, num_steps,
                                bf16_pyramid=bf16_pyramid)[1])


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0
                                 ) -> Callable[[int], float]:
    """optax's schedule of the same name: linear warmup from
    ``init_value`` to ``peak_value`` over ``warmup_steps``, then cosine
    decay to ``end_value`` at ``decay_steps``; evaluated in f32 as optax
    does."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    f32 = np.float32

    def linear(count):
        c = f32(min(max(count, 0), warmup_steps))
        frac = f32(1) - c / f32(warmup_steps)
        return f32(init_value - peak_value) * frac + f32(peak_value)

    def cosine(count):
        T = decay_steps - warmup_steps
        c = f32(min(count, T))
        cos = f32(0.5) * (f32(1) + f32(math.cos(f32(math.pi) * c / f32(T))))
        return f32(peak_value) * (f32(1 - alpha) * cos + f32(alpha))

    def schedule(count: int) -> float:
        if warmup_steps > 0 and count < warmup_steps:
            return float(linear(count))
        return float(cosine(count - warmup_steps))

    return schedule


class Optimizer:
    """optax.chain(zero_nans(), clip_by_global_norm(max_norm),
    adam(lr, b1, b2, eps)) over a list of f32 parameters.

    ``update(grads)`` returns the updates (the step to add) and advances
    the state: NaNs become 0; above ``max_norm`` the gradients are scaled
    as ``(g / ||g||) * max_norm`` (optax's order, not
    ``clip_grad_norm_``'s ``g * max / (||g|| + 1e-6)``); Adam's moments,
    bias corrections at the incremented count and ``-lr(count)`` at the
    count before it.
    """

    def __init__(self, params: Sequence[torch.Tensor], lr, max_norm=1.0,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr = lr if callable(lr) else (lambda count: lr)
        self.max_norm = max_norm
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        self.nu = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        self.count = 0

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        g = [torch.where(torch.isnan(x), torch.zeros_like(x), x)
             for x in grads]
        norm = torch.sqrt(sum(torch.sum(x * x) for x in g))
        clip = norm >= self.max_norm
        g = [torch.where(clip, (x / norm) * self.max_norm, x) for x in g]
        b1, b2 = self.b1, self.b2
        self.mu = [(1 - b1) * x + b1 * m for x, m in zip(g, self.mu)]
        self.nu = [(1 - b2) * (x * x) + b2 * v for x, v in zip(g, self.nu)]
        count_inc = self.count + 1
        c1 = float(np.float32(1) - np.float32(b1) ** np.float32(count_inc))
        c2 = float(np.float32(1) - np.float32(b2) ** np.float32(count_inc))
        step = -float(np.float32(self.lr(self.count)))
        updates = [step * ((m / c1) / (torch.sqrt(v / c2) + self.eps))
                   for m, v in zip(self.mu, self.nu)]
        self.count = count_inc
        return updates

    def state_dict(self) -> Dict:
        return {"mu": self.mu, "nu": self.nu, "count": self.count}

    def load_state_dict(self, state: Dict) -> None:
        self.mu = [t.clone() for t in state["mu"]]
        self.nu = [t.clone() for t in state["nu"]]
        self.count = int(state["count"])


@torch.no_grad()
def apply_fn(net: DroidNet, opt: Optimizer, g_sum: Sequence[torch.Tensor],
             inv_n: float, ema: List[torch.Tensor] = None,
             ema_decay: float = 0.0) -> None:
    """One optimizer step on the averaged gradients (``g_sum * inv_n``),
    in place on ``net``'s parameters; with ``ema_decay`` > 0 the weight
    EMA (what ships) follows: ``ema = decay * ema + (1 - decay) * p``."""
    params = list(net.parameters())
    for p, u in zip(params, opt.update([g * inv_n for g in g_sum])):
        p.add_(u)
    if ema_decay > 0.0:
        for e, p in zip(ema, params):
            e.copy_(ema_decay * e + (1.0 - ema_decay) * p)
