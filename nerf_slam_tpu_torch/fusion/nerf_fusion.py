"""Online NeRF fusion: a depth-supervised radiance field fed by SLAM
packets (PyTorch).

NeRF-SLAM's mapping module (fusion/nerf_fusion.py there): a preallocated
training set that SLAM packets grow and update, depth supervision
weighted by the SLAM depth variance (the JAX package's
``mask_type="ours"``), sRGB->linear targets, per-spin
training (``fit_volume``) with Adam, and evaluation at the training views
(PSNR, depth L1), rendered with occupancy-bounded samples.

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
from .ngp import (NGPConfig, PEField, draw_ray_samples, occupancy_grid,
                  ray_occ_interval, render_rays, sample_along_rays,
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


@dataclass
class NerfFusionConfig:
    buffer: int = 64                  # max training images
    height: int = 120                 # fusion resolution (= the packets')
    width: int = 160
    batch_rays: int = 4096
    iters_per_spin: int = 10
    ngp: NGPConfig = field(default_factory=NGPConfig)
    scale: float = 0.25               # unit = world * scale + offset
    offset: tuple = (0.5, 0.5, 0.5)
    render_rows_per_chunk: int = 40
    occ_res: int = 64
    occ_thresh: float = 4.0
    occ_refresh_every: int = 200
    render_samples: int = 48


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


class NerfFusion:
    """Mapping module.  ``device``: where the field, optimizer and
    training set live (CUDA unless the caller asks for the CPU)."""

    def __init__(self, cfg: NerfFusionConfig, seed: int = 0,
                 device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self._seed = seed
        self.reset()

    def reset(self):
        """Fresh field, optimizer, training set and generators."""
        cfg, dev = self.cfg, self.device
        init_gen = torch.Generator().manual_seed(self._seed)
        self.field = PEField(cfg.ngp, generator=init_gen).to(dev)
        self.opt = torch.optim.Adam(self.field.parameters(),
                                    lr=cfg.ngp.pe_lr, betas=(0.9, 0.99),
                                    eps=1e-15)
        N, H, W = cfg.buffer, cfg.height, cfg.width

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
        self.has_data = False
        self._t0 = None
        self._occ_mask = None
        self._occ_iter = -1

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
        self.has_data = True
        if self._t0 is None:
            self._t0 = time.time()

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

    def loss(self, batch: Batch):
        """Sigma-weighted depth + RGB + opacity loss of one batch.
        Returns (loss, l_rgb, l_depth)."""
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
        loss = ngp.rgb_weight * l_rgb + ngp.depth_weight * (l_d + l_acc)
        return loss, l_rgb, l_d

    def train_step(self, batch: Optional[Batch] = None) -> torch.Tensor:
        """One Adam step; returns the loss as a device scalar."""
        batch = self.draw_batch() if batch is None else batch
        self.opt.zero_grad(set_to_none=True)
        loss, _, _ = self.loss(batch)
        loss.backward()
        self.opt.step()
        return loss.detach()

    def fit_volume(self, iters: Optional[int] = None):
        """``iters`` train steps.  Returns the last loss (a device
        scalar)."""
        iters = iters or self.cfg.iters_per_spin
        if not self.has_data:
            return 0.0
        loss = 0.0
        for _ in range(int(iters)):
            loss = self.train_step()
            self.iteration += 1
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
                    gen: torch.Generator):
        """Render image rows ``ys`` at a normalized-frame pose.  Returns
        (linear rgb (n, W, 3), depth (n, W), acc (n, W))."""
        cfg = self.cfg
        W = cfg.width
        fx, fy, cx, cy = intr.unbind(-1)
        yy, xx = torch.meshgrid(ys.float(), torch.arange(
            W, dtype=torch.float32, device=self.device), indexing="ij")
        dirs_cam = torch.stack([(xx + 0.5 - cx) / fx, (yy + 0.5 - cy) / fy,
                                torch.ones_like(xx)], dim=-1)
        dirs = dirs_cam.reshape(-1, 3) @ c2w[:3, :3].T
        origins = c2w[:3, 3].expand(dirs.shape)
        R = dirs.shape[0]
        if self.iteration > 0:           # occupancy-bounded samples
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
    def render_training_view(self, i: int):
        """Render training view i in the map's own frame.  Returns (sRGB
        rgb (H, W, 3) in [0, 1], depth (H, W) normalized units)."""
        cfg, ts = self.cfg, self.train_set
        gen = torch.Generator(device=self.device).manual_seed(0)
        rgb, depth = [], []
        for y0 in range(0, cfg.height, cfg.render_rows_per_chunk):
            ys = torch.arange(y0, min(y0 + cfg.render_rows_per_chunk,
                                      cfg.height), device=self.device)
            r, d, _ = self.render_rows(ts.c2w[i], ts.intrinsics[i], ys, gen)
            rgb.append(r)
            depth.append(d)
        rgb = torch.clamp(linear_to_srgb(torch.cat(rgb)), 0.0, 1.0)
        return rgb, torch.cat(depth)

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
