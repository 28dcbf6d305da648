"""Uncertainty-weighted TSDF fusion (Sigma-Fusion) on a dense voxel grid
(PyTorch).

NeRF-SLAM's "probabilistic volumetric fusion": every depth reading is
integrated with the weight 1/sigma of its depth uncertainty, so uncertain
depths move the surface less.  The port of the JAX package's
``fusion/tsdf_fusion.py``, one dense masked update over a (G, G, G) grid:

  - per-pixel integration weight = 1/sigma_depth; the ``uniform`` mask
    type (``--fusion tsdf``) uses weight 1
  - sdf = depth_reading - voxel_cam_z; inliers need a reading in
    (0, max_depth) and sdf >= -trunc; sdf saturated at +trunc and
    normalized
  - weighted running average of tsdf and color, weights saturated at
    max_weight
  - readings whose sigma exceeds the live threshold are masked
    (``sigma`` mode); a bounded history of integrated frames replays under
    a new threshold (:meth:`TsdfFusion.rebuild`)
  - ray-cast rendering for PSNR / depth-L1 evaluation, marching-tetrahedra
    mesh export.

The volume lives on the mapping device and keeps the JAX package's
channel-major (3, G, G, G) color at the public API.  The JAX integration
returns a new volume (its input is donated); here :meth:`_integrate`
updates the volume's tensors in place and returns the same volume.

A packet's integration runs inside the span ``map.tsdf`` of
``utils.runtime`` (recorded while a profiler records).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..geometry import se3
from ..utils import runtime
from ..utils.evaluation import to_numpy


@dataclass
class TsdfFusionConfig:
    grid_size: int = 192              # voxels per axis
    volume_extent: float = 6.0        # metres covered per axis
    volume_origin: tuple = (-3.0, -3.0, -1.0)
    sdf_trunc_voxels: float = 4.0     # truncation band in voxel units
    max_depth: float = 5.0
    max_weight: float = 500.0
    depth_mask_type: str = "weighted"  # weighted (sigma) | uniform (tsdf)
    max_depth_sigma_thresh: float = 5.0
    # bounded history of integrated frames, replayed by rebuild() at a
    # new sigma threshold
    history_size: int = 96

    @property
    def voxel_size(self) -> float:
        return self.volume_extent / self.grid_size

    @property
    def sdf_trunc(self) -> float:
        return self.sdf_trunc_voxels * self.voxel_size

    @classmethod
    def high_fidelity(cls, **kw) -> "TsdfFusionConfig":
        """1.5 cm voxels (384^3 over 5.76 m); about 1.1 GB of f32 state."""
        kw.setdefault("grid_size", 384)
        kw.setdefault("volume_extent", 5.76)       # 5.76/384 = 1.5 cm
        kw.setdefault("volume_origin", (-2.88, -2.88, -1.0))
        return cls(**kw)


class TsdfVolume(NamedTuple):
    tsdf: torch.Tensor     # (G, G, G)
    weight: torch.Tensor   # (G, G, G)
    color: torch.Tensor    # (3, G, G, G), channel-major


class TsdfFusion:
    """Mapping backend.  ``device``: where the volume and the history live
    (CUDA unless the caller asks for the CPU)."""

    def __init__(self, cfg: Optional[TsdfFusionConfig] = None,
                 device="cuda"):
        self.cfg = cfg or TsdfFusionConfig()
        self.device = torch.device(device)
        # live sigma threshold; rebuild() replays the history under it
        self.sigma_thresh = self.cfg.max_depth_sigma_thresh
        # integrated frames (device tensors), at most history_size
        self.history: list = []
        self.volume = self.reset_volume()

    def reset_volume(self) -> TsdfVolume:
        G, dev = self.cfg.grid_size, self.device
        self.volume = TsdfVolume(
            tsdf=torch.ones((G, G, G), dtype=torch.float32, device=dev),
            weight=torch.zeros((G, G, G), dtype=torch.float32, device=dev),
            color=torch.zeros((3, G, G, G), dtype=torch.float32, device=dev))
        return self.volume

    def _voxel_axes(self):
        """Voxel-centre coordinates along x, y, z, shaped to broadcast to
        (G, G, G)."""
        cfg = self.cfg
        ax = torch.arange(cfg.grid_size, dtype=torch.float32,
                          device=self.device)
        o = cfg.volume_origin
        return ((o[0] + (ax + 0.5) * cfg.voxel_size)[:, None, None],
                (o[1] + (ax + 0.5) * cfg.voxel_size)[None, :, None],
                (o[2] + (ax + 0.5) * cfg.voxel_size)[None, None, :])

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _integrate(self, volume: TsdfVolume, w2c: torch.Tensor,
                   intrinsics: torch.Tensor, depth: torch.Tensor,
                   depth_weight: torch.Tensor,
                   color: torch.Tensor) -> TsdfVolume:
        """Integrate one frame into ``volume`` IN PLACE.  w2c: (4, 4)
        cam_T_world; depth / depth_weight: (H, W); color: (H, W, 3) in
        [0, 1].  Returns ``volume``."""
        cfg = self.cfg
        H, W = depth.shape
        X, Y, Z = self._voxel_axes()
        R, t = w2c[:3, :3], w2c[:3, 3]
        camx = R[0, 0] * X + R[0, 1] * Y + R[0, 2] * Z + t[0]
        camy = R[1, 0] * X + R[1, 1] * Y + R[1, 2] * Z + t[1]
        d = R[2, 0] * X + R[2, 1] * Y + R[2, 2] * Z + t[2]
        fx, fy, cx, cy = intrinsics
        # round half to even, as jnp.round
        u = torch.round(fx * camx / d + cx).to(torch.int64)
        v = torch.round(fy * camy / d + cy).to(torch.int64)
        del camx, camy

        in_img = (d > 0) & (u >= 0) & (v >= 0) & (u < W) & (v < H)
        # one flat index gathers depth, weight and all three color
        # channels (the JAX code gathers the color once per channel)
        idx = v.clamp(0, H - 1) * W + u.clamp(0, W - 1)
        del u, v
        reading = depth.reshape(-1)[idx]
        wr = depth_weight.reshape(-1)[idx]
        col = color.reshape(-1, 3)[idx]                     # (G, G, G, 3)
        del idx

        sdf = reading - d
        inlier = in_img & (reading > 0) & (reading < cfg.max_depth) \
            & (sdf >= -cfg.sdf_trunc)
        sdf = torch.clamp(sdf, max=cfg.sdf_trunc) / cfg.sdf_trunc
        wr = torch.where(inlier, wr, torch.zeros_like(wr))
        del reading, d, in_img, inlier

        w_old = volume.weight
        wp = w_old + wr
        wp_safe = torch.clamp(wp, min=1e-8)
        keep = wr > 0
        tsdf_new = (w_old * volume.tsdf + wr * sdf) / wp_safe
        volume.tsdf.copy_(torch.where(keep, tsdf_new, volume.tsdf))
        del tsdf_new, sdf
        for c in range(3):
            ch = volume.color[c]
            ch.copy_(torch.where(keep, (w_old * ch + wr * col[..., c])
                                 / wp_safe, ch))
        w_old.copy_(torch.where(keep, torch.clamp(wp, max=cfg.max_weight),
                                w_old))
        return volume

    def _tensor(self, x, dtype=torch.float32) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device).to(dtype)

    def integrate_frame(self, w2c, intrinsics, depth, depth_cov, color_u8,
                        record: bool = True):
        """Integrate one frame under the LIVE ``sigma_thresh``;
        ``record=True`` appends it to the bounded history so
        :meth:`rebuild` can replay it at another threshold."""
        cfg = self.cfg
        w2c, intr = self._tensor(w2c), self._tensor(intrinsics)
        depth, cov = self._tensor(depth), self._tensor(depth_cov)
        color = self._tensor(color_u8) / 255.0
        if record:
            self.history.append((w2c, intr, depth, cov, color))
            if len(self.history) > cfg.history_size:
                self.history = self.history[-cfg.history_size:]
        self._integrate(self.volume, w2c, intr, depth,
                        self._mask_weight(depth, cov), color)

    def set_sigma_thresh(self, value: float):
        """Future integrations mask at this threshold (call
        :meth:`rebuild` to re-filter the fused history)."""
        self.sigma_thresh = float(value)

    def rebuild(self, sigma_thresh: Optional[float] = None):
        """Reset the volume and replay the history under
        ``sigma_thresh`` (default: the live threshold)."""
        if sigma_thresh is not None:
            self.sigma_thresh = float(sigma_thresh)
        self.reset_volume()
        for w2c, intr, depth, cov, color in list(self.history):
            self._integrate(self.volume, w2c, intr, depth,
                            self._mask_weight(depth, cov), color)

    def _mask_weight(self, depth: torch.Tensor,
                     cov: torch.Tensor) -> torch.Tensor:
        """Integration weight per pixel: 1 ("uniform"), else 1/sigma, and 0
        where sigma exceeds the live threshold ("weighted")."""
        if self.cfg.depth_mask_type == "uniform":
            return torch.ones_like(depth)
        wgt = 1.0 / torch.sqrt(torch.clamp(cov, min=1e-12))
        return torch.where(torch.sqrt(torch.clamp(cov, min=0))
                           > self.sigma_thresh, torch.zeros_like(wgt), wgt)

    def fuse(self, packet: Optional[Dict]) -> bool:
        """Integrate every keyframe of a SLAM viz packet; True at the end
        of the sequence."""
        if packet is None:
            return False
        if packet.get("is_last_frame") and "viz_idx" not in packet:
            return True
        with runtime.span("map.tsdf"):
            n = int(packet.get("viz_count",
                               np.asarray(packet["viz_idx"]).shape[0]))
            poses7 = self._tensor(packet["cam0_poses"])[:n]
            w2cs = se3.matrix(poses7)
            idepths = self._tensor(packet["cam0_idepths_up"])[:n]
            covs = self._tensor(packet["cam0_depths_cov_up"])[:n]
            imgs = torch.as_tensor(packet["cam0_images"],
                                   device=self.device)[:n]
            intr = self._tensor(packet["cam0_intrinsics"])[:n] * 8.0
            depths = torch.where(idepths > 1e-6,
                                 1.0 / torch.clamp(idepths, min=1e-6),
                                 torch.zeros_like(idepths))
            for i in range(n):
                self.integrate_frame(w2cs[i], intr[i], depths[i], covs[i],
                                     imgs[i])
        return bool(packet.get("is_last_frame", False))

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _raycast(self, volume: TsdfVolume, c2w: torch.Tensor,
                 shape: Tuple[int, int], intrinsics: torch.Tensor,
                 n_steps: int = 192):
        """Fixed-step march to the first tsdf zero crossing along each
        pixel's ray (a loop of ``n_steps`` eager steps: evaluation only).
        Returns (rgb (H, W, 3), depth (H, W))."""
        cfg = self.cfg
        H, W = shape
        G = cfg.grid_size
        dev = self.device
        fx, fy, cx, cy = intrinsics
        v, u = torch.meshgrid(
            torch.arange(H, dtype=torch.float32, device=dev) + 0.5,
            torch.arange(W, dtype=torch.float32, device=dev) + 0.5,
            indexing="ij")
        dirs_cam = torch.stack([(u - cx) / fx, (v - cy) / fy,
                                torch.ones_like(u)], -1)
        dirs = dirs_cam @ c2w[:3, :3].T
        origin = c2w[:3, 3]
        step = cfg.max_depth / n_steps
        ts = (torch.arange(n_steps, dtype=torch.float32, device=dev)
              + 0.5) * step
        vo = torch.tensor(cfg.volume_origin, dtype=torch.float32, device=dev)
        color = volume.color.reshape(3, -1)

        prev = torch.ones((H, W), device=dev)
        hit_t = torch.zeros((H, W), device=dev)
        hit_col = torch.zeros((H, W, 3), device=dev)
        found = torch.zeros((H, W), dtype=torch.bool, device=dev)
        for t in ts:
            pts = origin + t * dirs
            # nearest voxel
            g = (pts - vo) / cfg.voxel_size - 0.5
            gi = torch.clamp(torch.round(g).to(torch.int64), 0, G - 1)
            inb = ((g >= 0) & (g <= G - 1)).all(dim=-1)
            flat = (gi[..., 0] * G + gi[..., 1]) * G + gi[..., 2]
            tv = volume.tsdf.reshape(-1)[flat]
            wv = volume.weight.reshape(-1)[flat]
            cv = color[:, flat].permute(1, 2, 0)
            tv = torch.where(inb & (wv > 0), tv, torch.ones_like(tv))
            crossing = (prev > 0) & (tv <= 0) & ~found
            # linear interpolation of the crossing point
            frac = prev / torch.clamp(prev - tv, min=1e-6)
            hit_t = torch.where(crossing, t - step + frac * step, hit_t)
            hit_col = torch.where(crossing[..., None], cv, hit_col)
            found = found | crossing
            prev = tv
        # dirs have unit z in the camera frame, so t IS the z-depth
        depth = torch.where(found, hit_t, torch.zeros_like(hit_t))
        return hit_col, depth

    def render(self, c2w, intrinsics, shape):
        """Ray-cast view at a world-frame c2w; numpy (rgb, depth)."""
        rgb, depth = self._raycast(self.volume, self._tensor(c2w),
                                   tuple(shape), self._tensor(intrinsics))
        return rgb.cpu().numpy(), depth.cpu().numpy()

    def evaluate(self, gt_images_u8, gt_depths, c2ws, intrinsics,
                 max_views: int = 4):
        """PSNR and depth-L1 (cm, errors of 2 m or more left out) of
        ray-cast views against ground truth."""
        psnrs, l1s = [], []
        for i in range(min(len(c2ws), max_views)):
            gt = np.asarray(to_numpy(gt_images_u8[i]), np.float32) / 255.0
            rgb, depth = self.render(c2ws[i], intrinsics[i], gt.shape[:2])
            ok = depth > 0
            if ok.sum() < 10:
                continue
            mse = float(np.mean((rgb[ok] - gt[ok]) ** 2))
            psnrs.append(-10.0 * np.log10(max(mse, 1e-12)))
            if gt_depths is not None:
                gtd = np.asarray(to_numpy(gt_depths[i]), np.float32)
                sel = ok & (gtd > 0)
                err = np.abs(depth - gtd)[sel]
                err = err[err < 2.0]
                if err.size:
                    l1s.append(float(err.mean()) * 100.0)
        return {"psnr": float(np.mean(psnrs)) if psnrs else float("nan"),
                "depth_l1_cm": float(np.mean(l1s)) if l1s else float("nan")}

    def _host_volume(self):
        v = self.volume
        return (v.tsdf.cpu().numpy(), v.weight.cpu().numpy(),
                np.moveaxis(v.color.cpu().numpy(), 0, -1))

    def extract_surface_points(self, max_points: int = 200000):
        """Voxel centres near the zero crossing (|tsdf| < 0.5, weight > 1)
        and their colors, at most ``max_points`` (a fixed random subset)."""
        cfg = self.cfg
        t, w, col = self._host_volume()
        idx = np.argwhere((np.abs(t) < 0.5) & (w > 1.0))
        if idx.shape[0] > max_points:
            sel = np.random.RandomState(0).choice(
                idx.shape[0], max_points, replace=False)
            idx = idx[sel]
        pts = np.asarray(cfg.volume_origin) + (idx + 0.5) * cfg.voxel_size
        return pts, col[idx[:, 0], idx[:, 1], idx[:, 2]]

    def extract_mesh(self, weight_thresh: float = 1.0):
        """Marching-tetrahedra surface of the fused TSDF over voxels of
        weight above ``weight_thresh``.  Returns (vertices (V, 3) world,
        faces (F, 3), nearest-voxel colors (V, 3))."""
        from .mesher import marching_tetrahedra
        cfg = self.cfg
        t, w, col = self._host_volume()
        verts, faces = marching_tetrahedra(
            t, mask=w > weight_thresh,
            origin=np.asarray(cfg.volume_origin) + 0.5 * cfg.voxel_size,
            voxel_size=cfg.voxel_size)
        if verts.shape[0]:
            g = (verts - np.asarray(cfg.volume_origin)) / cfg.voxel_size \
                - 0.5
            gi = np.clip(np.round(g).astype(int), 0, cfg.grid_size - 1)
            colors = col[gi[:, 0], gi[:, 1], gi[:, 2]]
        else:
            colors = np.zeros((0, 3))
        return verts, faces, colors
