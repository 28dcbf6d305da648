"""Online NeRF fusion: a depth-supervised radiance field fed by SLAM
packets (PyTorch).

NeRF-SLAM's mapping module (fusion/nerf_fusion.py there): a preallocated
training set that SLAM packets grow and update, depth supervision
weighted by the SLAM depth variance (``mask_type="ours"``; "raw",
"ours_w_thresh" and "no_depth" are the JAX package's ablations),
sRGB->linear targets, per-spin training (``fit_volume``) with Adam, on
the field ``NGPConfig.encoding`` names (the PE MLP or the hash grid), and
evaluation at the training views (PSNR, depth L1; a results row every
``eval_every`` iterations), rendered with occupancy-bounded samples
(``render_accel``, or the plain 128-sample render) at a resolution that
may adapt to a time budget (``dynamic_render_res``); free-view renders
and a density mesh.  Options off by default, as in the JAX package:
mapping-time pose refinement (``optimize_extrinsics``: per-view SE(3)
deltas on the training poses with their own Adam, in coordinate descent
with the field) and depth-supervision annealing (``depth_anneal_iters``).

Scene coordinates are normalized into the unit cube by
``(world * scale + offset)``; a ray's parameter t equals the camera
z-depth in normalized units, so supervised depths compare directly.

Each train step draws its rays and samples (:meth:`NerfFusion.draw_batch`)
apart from the loss (:meth:`NerfFusion.loss`), so a test can hand both
this package and the JAX one the same random numbers.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..geometry import se3
from ..utils.evaluation import to_numpy
from .ngp import (NGPConfig, draw_ray_samples, init_ngp, occupancy_grid,
                  query, ray_occ_interval, render_rays, sample_along_rays,
                  sample_in_interval)


def srgb_to_linear(img: torch.Tensor) -> torch.Tensor:
    return torch.where(img <= 0.04045, img / 12.92,
                       ((img + 0.055) / 1.055) ** 2.4)


def linear_to_srgb(img: torch.Tensor) -> torch.Tensor:
    return torch.where(img <= 0.0031308, img * 12.92,
                       1.055 * torch.clamp(img, min=1e-8) ** (1 / 2.4)
                       - 0.055)


def mse2psnr(mse) -> float:
    return float(-10.0 * np.log10(np.maximum(mse, 1e-12)))


# depth-supervision masking: 1/sigma^2-weighted depth ("ours"), unweighted
# ("raw"), sigma above a threshold masked ("ours_w_thresh"), none
MASK_TYPES = ("ours", "raw", "ours_w_thresh", "no_depth")


@dataclass
class NerfFusionConfig:
    buffer: int = 64                  # max training images
    height: int = 120                 # fusion resolution (= the packets')
    width: int = 160
    batch_rays: int = 4096
    mask_type: str = "ours"           # ours | raw | ours_w_thresh | no_depth
    iters_per_spin: int = 10
    ngp: NGPConfig = field(default_factory=NGPConfig)
    scale: float = 0.25               # unit = world * scale + offset
    offset: tuple = (0.5, 0.5, 0.5)
    eval_every: int = 0               # iterations between results rows
                                      # (0: none; the CLI's --eval sets 200)
    eval_views: int = 8               # views per results row
    # mapping-time pose refinement: per-view SE(3) deltas (right
    # perturbations of the training c2w) with their own Adam.  After
    # ``extrinsics_start`` iterations every ``extrinsics_period``-iteration
    # cycle ends with ``extrinsics_pose_iters`` POSE-ONLY steps (field
    # frozen); view 0 stays pinned (the map's gauge)
    optimize_extrinsics: bool = False
    extrinsics_lr: float = 1e-3
    extrinsics_start: int = 500
    extrinsics_period: int = 100
    extrinsics_pose_iters: int = 25
    # occupancy-bounded render (``render_samples`` samples a ray inside
    # the occupied span of an ``occ_res``^3 sigma grid); False: 128
    # samples spread over [near, far]
    render_accel: bool = True
    render_rows_per_chunk: int = 40
    occ_res: int = 64
    occ_thresh: float = 4.0
    occ_refresh_every: int = 200
    render_samples: int = 48
    # dynamic render resolution: free-view renders at the smallest
    # downscale (1, 2 or 4) whose measured render time fits
    # ``render_target_ms``, upsampled back to the full frame
    render_target_ms: float = 66.0
    dynamic_render_res: bool = False
    # depth-supervision annealing: the depth weight goes linearly from 1
    # to ``depth_anneal_floor`` over ``depth_anneal_iters`` iterations,
    # then stays there (0: off)
    depth_anneal_iters: int = 0
    depth_anneal_floor: float = 0.25


@dataclass
class TrainSet:
    """Preallocated growable dataset on the mapping device."""
    c2w: torch.Tensor          # (N, 4, 4) world_T_cam (normalized scene)
    images: torch.Tensor       # (N, H, W, 3) linear RGB f32
    depths: torch.Tensor       # (N, H, W) z-depth (normalized), <0 invalid
    depths_cov: torch.Tensor   # (N, H, W) depth variance (normalized^2)
    gt_depths: torch.Tensor    # (N, H, W) GT z-depth (normalized), eval
    intrinsics: torch.Tensor   # (N, 4)
    valid: torch.Tensor        # (N,) 0/1


class Batch(NamedTuple):
    """One train step's random draws."""
    img_idx: torch.Tensor      # (R,) training view per ray
    uv: torch.Tensor           # (R, 2) uniform pixel position
    samples: tuple             # draw_ray_samples(R, ...)


_RENDER_SCALES = (1, 2, 4)


def _set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = lr


class NerfFusion:
    """Mapping module.  ``device``: where the field, optimizer and
    training set live (CUDA unless the caller asks for the CPU).

    Both optimizers step on every iteration, as the JAX package's do:
    a phase that freezes the field (or the poses) runs its Adam at rate 0,
    so its moments and step count still advance while its parameters keep
    their bits (JAX multiplies the updates by 0 after the Adam update)."""

    def __init__(self, cfg: NerfFusionConfig, seed: int = 0,
                 device="cuda"):
        if cfg.mask_type not in MASK_TYPES:
            raise ValueError(f"unknown mask_type {cfg.mask_type!r}")
        self.cfg = cfg
        self.device = torch.device(device)
        self._seed = seed
        self.reset()

    def reset(self):
        """Fresh field, optimizer, training set and generators."""
        cfg, dev = self.cfg, self.device
        init_gen = torch.Generator().manual_seed(self._seed)
        self.field = init_ngp(cfg.ngp, generator=init_gen).to(dev)
        self._lr = cfg.ngp.pe_lr if cfg.ngp.encoding == "pe" else cfg.ngp.lr
        self.opt = torch.optim.Adam(self.field.parameters(), lr=self._lr,
                                    betas=(0.9, 0.99), eps=1e-15)
        N, H, W = cfg.buffer, cfg.height, cfg.width
        # per-view SE(3) deltas [v, w] and their Adam (optax.adam's
        # defaults: b2 0.999, eps 1e-8)
        self.pose_deltas = torch.zeros((N, 6), device=dev,
                                       requires_grad=True)
        self.pose_opt = torch.optim.Adam([self.pose_deltas],
                                         lr=cfg.extrinsics_lr,
                                         betas=(0.9, 0.999), eps=1e-8)

        def full(shape, v):
            return torch.full(shape, v, dtype=torch.float32, device=dev)

        self.train_set = TrainSet(
            c2w=torch.eye(4, device=dev).repeat(N, 1, 1),
            images=full((N, H, W, 3), 0.0), depths=full((N, H, W), -1.0),
            depths_cov=full((N, H, W), 1.0),
            gt_depths=full((N, H, W), -1.0), intrinsics=full((N, 4), 1.0),
            valid=full((N,), 0.0))
        self.gen = torch.Generator(device=dev).manual_seed(self._seed + 1)
        self.iteration = 0
        self.results = []
        self.sigma_thresh = None   # absolute threshold for ours_w_thresh
        self.has_data = False
        self._t0 = None
        self._occ_mask = None
        self._occ_iter = -1
        self._render_ms = {}       # EMA ms of a full render, by scale

    # ------------------------------------------------------------------
    # data ingestion
    # ------------------------------------------------------------------
    def _packet_arrays(self, packet: Dict[str, Any]):
        """Tensors of a SLAM viz packet on the mapping device; ids are
        re-padded to the packet's padded row count."""
        ids = np.asarray(packet["viz_idx"])
        V = packet["cam0_poses"].shape[0]
        if ids.shape[0] < V:
            ids = np.concatenate(
                [ids, np.full(V - ids.shape[0], ids[-1], ids.dtype)])
        dev = self.device

        def get(name):
            return torch.as_tensor(packet[name], device=dev)

        gt = packet.get("gt_depths")
        return (torch.as_tensor(ids, dtype=torch.int64, device=dev),
                get("cam0_poses"), get("cam0_images"),
                get("cam0_idepths_up"), get("cam0_depths_cov_up"),
                get("cam0_intrinsics") * 8.0,
                None if gt is None else torch.as_tensor(gt, device=dev))

    @torch.no_grad()
    def update_training_images(self, ids, poses7, images_u8, idepths_up,
                               depths_cov_up, intrinsics, gt_depths=None):
        """idepth -> depth, sRGB -> linear, normalization and the
        scatter of views ``ids`` into the training set (the fuse body).
        poses7: cam_T_world [t, q_xyzw] in world units; intrinsics at the
        packet's resolution, which must be the fusion resolution."""
        cfg = self.cfg
        if tuple(images_u8.shape[1:3]) != (cfg.height, cfg.width):
            raise ValueError(
                f"packet images {tuple(images_u8.shape[1:3])} differ from "
                f"the fusion resolution {(cfg.height, cfg.width)}")
        c2w = se3.matrix(se3.inv(poses7.float()))
        idepths_up = idepths_up.float()
        depths_cov_up = depths_cov_up.float()
        # depth-uncertainty masking
        if cfg.mask_type == "raw":
            depths_cov_up = torch.ones_like(depths_cov_up)
        elif cfg.mask_type == "ours_w_thresh":
            sig = torch.sqrt(torch.clamp(depths_cov_up, min=0))
            thr = (torch.quantile(sig.reshape(-1), 0.5)
                   if self.sigma_thresh is None else self.sigma_thresh)
            idepths_up = torch.where(sig > thr, -1.0, idepths_up)
        elif cfg.mask_type == "no_depth":
            idepths_up = -torch.ones_like(idepths_up)
        depths = torch.where(idepths_up > 1e-6,
                             1.0 / torch.clamp(idepths_up, min=1e-6), -1.0)
        s = cfg.scale
        off = torch.tensor(cfg.offset, dtype=torch.float32,
                           device=self.device)
        c2w[:, :3, 3] = c2w[:, :3, 3] * s + off
        gtd = (gt_depths.float() if gt_depths is not None
               else -torch.ones_like(depths))
        ts = self.train_set
        ts.c2w[ids] = c2w
        ts.images[ids] = srgb_to_linear(images_u8.float() / 255.0)
        ts.depths[ids] = torch.where(depths > 0, depths * s, -1.0)
        ts.depths_cov[ids] = depths_cov_up * (s * s)
        ts.gt_depths[ids] = torch.where(gtd > 0, gtd * s, -1.0)
        ts.intrinsics[ids] = intrinsics.float()
        ts.valid[ids] = 1.0
        if cfg.optimize_extrinsics:
            # fresh SLAM poses supersede refined deltas for these views
            self.pose_deltas[ids] = 0.0
        self.has_data = True
        if self._t0 is None:
            self._t0 = time.time()

    def set_sigma_thresh(self, value: Optional[float]):
        """An ABSOLUTE depth-sigma threshold for ``mask_type=
        "ours_w_thresh"`` (None restores the median of each packet);
        applies to packets fused from now on."""
        self.sigma_thresh = None if value is None else float(value)

    def fuse(self, packet: Optional[Dict[str, Any]]) -> bool:
        """Consume one SLAM viz packet; True at end of sequence.  Padded
        duplicate rows write the same view twice, which is harmless."""
        if packet is None:
            return False
        if packet.get("is_last_frame") and "viz_idx" not in packet:
            return True
        self.update_training_images(*self._packet_arrays(packet))
        return bool(packet.get("is_last_frame", False))

    def fuse_and_fit(self, packet: Optional[Dict[str, Any]],
                     iters: Optional[int] = None) -> bool:
        """Packet ingest, then ``iters`` training steps."""
        done = self.fuse(packet)
        self.fit_volume(iters)
        return done

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------
    def draw_batch(self) -> Batch:
        """Rays from valid views (uniformly over them), uniform pixel
        positions, and the ray-sample draws."""
        cfg, g = self.cfg, self.gen
        R = cfg.batch_rays
        img_idx = torch.multinomial(self.train_set.valid, R,
                                    replacement=True, generator=g)
        uv = torch.rand((R, 2), generator=g, device=self.device)
        return Batch(img_idx, uv,
                     draw_ray_samples(R, cfg.ngp, g, self.device))

    def _refined_c2w(self, deltas: torch.Tensor,
                     c2w: torch.Tensor) -> torch.Tensor:
        """Apply per-view SE(3) right perturbations (N, 6) to c2w (N, 4,
        4)."""
        return c2w @ se3.matrix(se3.exp(deltas))

    def _schedule(self, it: int):
        """(pose_enable, field_enable, depth_mult) of iteration ``it``: the
        coordinate-descent phase (pose-only at the end of each cycle once
        refinement has started) and the depth-annealing multiplier, in f32
        as the JAX package computes it."""
        cfg = self.cfg
        pose = 0.0
        if cfg.optimize_extrinsics and it >= cfg.extrinsics_start:
            cyc = (it - cfg.extrinsics_start) % cfg.extrinsics_period
            pose = float(cyc >= cfg.extrinsics_period
                         - cfg.extrinsics_pose_iters)
        mult = 1.0
        if cfg.depth_anneal_iters > 0:
            f32 = np.float32
            frac = np.clip(f32(it) / f32(cfg.depth_anneal_iters), f32(0),
                           f32(1))
            mult = float(f32(1) + f32(cfg.depth_anneal_floor - 1.0) * frac)
        return pose, 1.0 - pose, mult

    def loss(self, batch: Batch, depth_mult: float = 1.0,
             pose_grad: bool = True):
        """Sigma-weighted depth + RGB + opacity loss of one batch, the depth
        terms scaled by ``depth_mult``; under ``optimize_extrinsics`` the
        rays leave the refined poses (differentiable in the deltas when
        ``pose_grad``).  Returns (loss, l_rgb, l_depth)."""
        cfg, ts = self.cfg, self.train_set
        ngp = cfg.ngp
        img_idx = batch.img_idx
        xi = torch.round(batch.uv[:, 0] * (cfg.width - 1)).long()
        yi = torch.round(batch.uv[:, 1] * (cfg.height - 1)).long()
        fx, fy, cx, cy = ts.intrinsics[img_idx].unbind(-1)
        dirs_cam = torch.stack([(xi + 0.5 - cx) / fx, (yi + 0.5 - cy) / fy,
                                torch.ones_like(fx)], dim=-1)
        tgt_rgb = ts.images[img_idx, yi, xi]
        tgt_depth = ts.depths[img_idx, yi, xi]
        tgt_cov = ts.depths_cov[img_idx, yi, xi]
        d_valid = (tgt_depth > 0).float()
        if cfg.optimize_extrinsics:
            deltas = self.pose_deltas if pose_grad \
                else self.pose_deltas.detach()
            c2w = self._refined_c2w(deltas, ts.c2w)[img_idx]
        else:
            c2w = ts.c2w[img_idx]
        # unit-z camera dirs, unnormalized: t is the normalized z-depth
        dirs = torch.einsum("rij,rj->ri", c2w[:, :3, :3], dirs_cam)
        origins = c2w[:, :3, 3]
        t = sample_along_rays(tgt_depth, d_valid, ngp, batch.samples)
        rgb, depth, acc, _ = render_rays(self.field, ngp, origins, dirs, t)
        l_rgb = ((rgb - tgt_rgb) ** 2).mean()
        # acc-normalized expected depth (the missed tail mass would bias
        # it short) plus opacity supervision on rays with a sensed depth
        depth = depth / torch.clamp(acc, min=0.25)
        w = d_valid / (tgt_cov / (cfg.scale ** 2) + 1e-2)
        nv = torch.clamp(d_valid.sum(), min=1.0)
        l_d = (w * (depth - tgt_depth) ** 2).sum() / nv
        l_acc = (d_valid * (1.0 - acc) ** 2).sum() / nv
        loss = (ngp.rgb_weight * l_rgb
                + ngp.depth_weight * depth_mult * (l_d + l_acc))
        return loss, l_rgb, l_d

    def train_step(self, batch: Optional[Batch] = None) -> torch.Tensor:
        """One step of iteration ``self.iteration``'s schedule: the field's
        Adam and, under ``optimize_extrinsics``, the poses' (view 0's
        gradient pinned to 0).  Outside the pose-only steps the poses' Adam
        gets a zero gradient, as JAX's product of the gradient with 0 gives
        it, without the backward through the rays that computes one.
        Returns the loss as a device scalar."""
        cfg = self.cfg
        pose_on, field_on, mult = self._schedule(self.iteration)
        batch = self.draw_batch() if batch is None else batch
        self.opt.zero_grad(set_to_none=True)
        self.pose_deltas.grad = None
        loss, _, _ = self.loss(batch, depth_mult=mult,
                               pose_grad=pose_on > 0)
        loss.backward()
        _set_lr(self.opt, self._lr * field_on)
        self.opt.step()
        if cfg.optimize_extrinsics:
            if self.pose_deltas.grad is None:
                self.pose_deltas.grad = torch.zeros_like(self.pose_deltas)
            self.pose_deltas.grad[0] = 0.0
            _set_lr(self.pose_opt, cfg.extrinsics_lr * pose_on)
            self.pose_opt.step()
        return loss.detach()

    def fit_volume(self, iters: Optional[int] = None):
        """``iters`` train steps, with a results row every
        ``cfg.eval_every`` iterations.  Returns the last loss (a device
        scalar)."""
        iters = iters or self.cfg.iters_per_spin
        if not self.has_data:
            return 0.0
        every = self.cfg.eval_every
        loss = 0.0
        for _ in range(int(iters)):
            loss = self.train_step()
            self.iteration += 1
            if every > 0 and self.iteration % every == 0:
                self.evaluate_training_views(max_views=self.cfg.eval_views)
        return loss

    # ------------------------------------------------------------------
    # rendering / eval
    # ------------------------------------------------------------------
    @torch.no_grad()
    def _ensure_occ(self) -> torch.Tensor:
        """Boolean occupancy of the sigma grid, dilated by a 3x3x3 max
        pool; rebuilt every ``occ_refresh_every`` iterations."""
        cfg = self.cfg
        if (self._occ_mask is None
                or self.iteration - self._occ_iter >= cfg.occ_refresh_every):
            occ = (occupancy_grid(self.field, cfg.occ_res, self.device)
                   > cfg.occ_thresh).float()
            self._occ_mask = F.max_pool3d(occ[None, None], 3, 1, 1)[0, 0] > 0
            self._occ_iter = self.iteration
        return self._occ_mask

    @torch.no_grad()
    def render_rows(self, c2w: torch.Tensor, intr: torch.Tensor, ys,
                    gen: torch.Generator, width: Optional[int] = None):
        """Render image rows ``ys`` of a ``width``-wide image (default the
        fusion width) at a normalized-frame pose: occupancy-bounded samples
        under ``render_accel`` once the field has trained, else 128 samples
        spread over the ray.  Returns (linear rgb (n, W, 3), depth (n, W),
        acc (n, W))."""
        cfg = self.cfg
        W = cfg.width if width is None else width
        fx, fy, cx, cy = intr.unbind(-1)
        yy, xx = torch.meshgrid(ys.float(), torch.arange(
            W, dtype=torch.float32, device=self.device), indexing="ij")
        dirs_cam = torch.stack([(xx + 0.5 - cx) / fx, (yy + 0.5 - cy) / fy,
                                torch.ones_like(xx)], dim=-1)
        dirs = dirs_cam.reshape(-1, 3) @ c2w[:3, :3].T
        origins = c2w[:3, 3].expand(dirs.shape)
        R = dirs.shape[0]
        if cfg.render_accel and self.iteration > 0:
            t_lo, t_hi, _ = ray_occ_interval(self._ensure_occ(), origins,
                                             dirs, cfg.ngp)
            u = torch.rand((R, cfg.render_samples), generator=gen,
                           device=self.device)
            t = sample_in_interval(t_lo, t_hi, u)
        else:
            zeros = torch.zeros(R, device=self.device)
            t = sample_along_rays(zeros, zeros, cfg.ngp, draw_ray_samples(
                R, cfg.ngp, gen, self.device))
        rgb, depth, acc, _ = render_rays(self.field, cfg.ngp, origins, dirs,
                                         t)
        depth = depth / torch.clamp(acc, min=0.25)
        n = ys.shape[0]
        return rgb.reshape(n, W, 3), depth.reshape(n, W), acc.reshape(n, W)

    @torch.no_grad()
    def _render_normalized(self, c2w: torch.Tensor, intr: torch.Tensor,
                           scale: int = 1):
        """Render at a pose in the normalized map frame; ``scale`` > 1
        renders (H/s, W/s) and repeats each pixel back to the full frame.
        Keeps an average of each scale's render time (the device's, read
        on the host after a sync).  Returns (sRGB rgb (H, W, 3) in [0, 1],
        depth (H, W) normalized units)."""
        cfg = self.cfg
        H, W = cfg.height, cfg.width
        h, w = -(-H // scale), -(-W // scale)
        intr = intr / scale
        gen = torch.Generator(device=self.device).manual_seed(0)
        t0 = time.perf_counter()
        rgb, depth = [], []
        for y0 in range(0, h, cfg.render_rows_per_chunk):
            ys = torch.arange(y0, min(y0 + cfg.render_rows_per_chunk, h),
                              device=self.device)
            r, d, _ = self.render_rows(c2w, intr, ys, gen, width=w)
            rgb.append(r)
            depth.append(d)
        rgb = torch.clamp(linear_to_srgb(torch.cat(rgb)), 0.0, 1.0)
        depth = torch.cat(depth)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        ms = 1e3 * (time.perf_counter() - t0)
        prev = self._render_ms.get(scale)
        self._render_ms[scale] = ms if prev is None else 0.8 * prev + 0.2 * ms
        if scale > 1:
            rgb = rgb.repeat_interleave(scale, 0).repeat_interleave(
                scale, 1)[:H, :W]
            depth = depth.repeat_interleave(scale, 0).repeat_interleave(
                scale, 1)[:H, :W]
        return rgb, depth

    def _pick_render_scale(self) -> int:
        """Under ``dynamic_render_res``: the smallest downscale whose
        measured (or, from another scale's time, quadratically
        extrapolated) render time fits ``render_target_ms``; else 1."""
        if not self.cfg.dynamic_render_res:
            return 1
        budget = self.cfg.render_target_ms
        for s in _RENDER_SCALES:
            ms = self._render_ms.get(s)
            if ms is None and self._render_ms:
                s0, v0 = next(iter(self._render_ms.items()))
                ms = v0 * (s0 * s0) / (s * s)
            if ms is None or ms <= budget:
                return s
        return _RENDER_SCALES[-1]

    def render_training_view(self, i: int):
        """Render training view i at its (refined) pose in the map's own
        frame (see :meth:`_render_normalized`)."""
        ts = self.train_set
        c2w = ts.c2w[i]
        if self.cfg.optimize_extrinsics:
            with torch.no_grad():
                c2w = self._refined_c2w(self.pose_deltas[i:i + 1],
                                        ts.c2w[i:i + 1])[0]
        return self._render_normalized(c2w, ts.intrinsics[i])

    def render_image(self, c2w_world, intrinsics):
        """Full-frame render at a world-frame c2w pose (at the dynamic
        resolution's scale when that is on).  Returns numpy (sRGB rgb (H,
        W, 3), depth (H, W) in world units)."""
        cfg = self.cfg
        c2w = torch.as_tensor(np.asarray(c2w_world, np.float32),
                              device=self.device).clone()
        c2w[:3, 3] = c2w[:3, 3] * cfg.scale + torch.tensor(
            cfg.offset, dtype=torch.float32, device=self.device)
        intr = torch.as_tensor(np.asarray(intrinsics, np.float32),
                               device=self.device)
        rgb, depth = self._render_normalized(
            c2w, intr, scale=self._pick_render_scale())
        return rgb.cpu().numpy(), depth.cpu().numpy() / cfg.scale

    @torch.no_grad()
    def evaluate_training_views(self, max_views: int = 8):
        """PSNR and depth L1 (cm; raw and median-scale-aligned) at up to
        ``max_views`` training views; appends and returns a results row."""
        cfg, ts = self.cfg, self.train_set
        idx = np.nonzero(ts.valid.cpu().numpy() > 0)[0]
        if idx.size == 0:
            return None
        if idx.size > max_views:
            idx = idx[np.linspace(0, idx.size - 1, max_views).astype(int)]
        psnrs, l1s, l1s_aligned = [], [], []
        for i in idx:
            rgb, depth = self.render_training_view(int(i))
            gt = torch.clamp(linear_to_srgb(ts.images[i]), 0.0, 1.0)
            psnrs.append(mse2psnr(float(((rgb - gt) ** 2).mean())))
            gtd = ts.gt_depths[i].cpu().numpy() / cfg.scale
            dep = depth.cpu().numpy() / cfg.scale
            ok = gtd > 0
            if ok.any():
                err = np.abs(dep - gtd)[ok]
                err = err[err < 2.0]            # truncate outliers at 2 m
                if err.size:
                    l1s.append(float(err.mean()) * 100.0)
                s = np.median(gtd[ok]) / max(np.median(dep[ok]), 1e-6)
                err_a = np.abs(dep * s - gtd)[ok]
                err_a = err_a[err_a < 2.0]
                if err_a.size:
                    l1s_aligned.append(float(err_a.mean()) * 100.0)

        def mean(xs):
            return float(np.mean(xs)) if xs else float("nan")

        row = {"iteration": self.iteration,
               "wall_s": (round(time.time() - self._t0, 2)
                          if self._t0 else 0.0),
               "psnr": mean(psnrs), "depth_l1_cm": mean(l1s),
               "depth_l1_aligned_cm": mean(l1s_aligned)}
        self.results.append(row)
        return row

    def write_results_csv(self, path: str):
        """results.csv, one row per online evaluation."""
        cols = ["iteration", "wall_s", "psnr", "depth_l1_cm",
                "depth_l1_aligned_cm"]
        with open(path, "w") as f:
            f.write(",".join(cols) + "\n")
            for row in self.results:
                f.write(",".join(str(row.get(c, "")) for c in cols) + "\n")

    @torch.no_grad()
    def extract_mesh(self, path: str = "fusion_mesh.obj",
                     resolution: int = 128, iso: float = 10.0,
                     chunk: int = 8):
        """Mesh of the density iso-surface sigma = ``iso`` over the unit
        cube, marched at ``resolution``^3 (written to ``path`` as .obj
        unless ``path`` is empty).  Returns (verts world frame, faces)."""
        from . import mesher
        cfg = self.cfg
        n = resolution
        xs = (np.arange(n) + 0.5) / n
        sdf = np.empty((n, n, n), np.float32)
        dirs = torch.zeros((n * n, 3), device=self.device)
        dirs[:, 2] = 1.0
        for z0 in range(0, n, chunk):
            zc = min(chunk, n - z0)
            g = np.stack(np.meshgrid(xs[z0:z0 + zc], xs, xs, indexing="ij"),
                         axis=-1)
            pos = torch.as_tensor(g.reshape(-1, 3)[:, ::-1].copy(),
                                  dtype=torch.float32, device=self.device)
            sig = [query(self.field, pos[i * n * n:(i + 1) * n * n],
                         dirs)[0].cpu().numpy() for i in range(zc)]
            sdf[z0:z0 + zc] = iso - np.stack(sig).reshape(zc, n, n)
        verts, faces = mesher.marching_tetrahedra(sdf)
        if verts.shape[0]:
            # grid index (z, y, x) -> unit cube -> world
            verts = verts[:, ::-1] / n
            verts = (verts - np.asarray(cfg.offset)) / cfg.scale
            if path:
                mesher.write_obj(path, verts, faces)
        return verts, faces

    def evaluate(self, gt_images_u8, gt_depths, c2ws, intrinsics,
                 max_views: int = 8):
        """PSNR and depth-L1 (cm) over world-frame views; appends and
        returns a results row.  A monocular map's frame differs from the
        ground truth's by a similarity: align ``c2ws`` first, or prefer
        :meth:`evaluate_training_views`."""
        psnrs, l1s = [], []
        for i in range(min(len(c2ws), max_views)):
            rgb, depth = self.render_image(to_numpy(c2ws[i]),
                                           to_numpy(intrinsics[i]))
            gt = np.asarray(to_numpy(gt_images_u8[i]), np.float32) / 255.0
            psnrs.append(mse2psnr(float(np.mean((rgb - gt) ** 2))))
            if gt_depths is not None:
                gtd = np.asarray(to_numpy(gt_depths[i]), np.float32)
                err = np.abs(depth - gtd)[gtd > 0]
                err = err[err < 2.0]            # truncate outliers at 2 m
                if err.size:
                    l1s.append(float(err.mean()) * 100.0)
        row = {"iteration": self.iteration,
               "psnr": float(np.mean(psnrs)) if psnrs else float("nan"),
               "depth_l1_cm": float(np.mean(l1s)) if l1s else float("nan")}
        self.results.append(row)
        return row

