"""Headless visualizer: consumes SLAM viz packets, writes artifacts.

NeRF-SLAM's Open3D GUI without its window (GPU servers are usually
headless): per packet it accumulates the camera trajectory with
pose-covariance ellipsoids and, every ``export_every`` packets and at the
last one, writes an uncertainty-masked colored point cloud (PLY), the
trajectory (JSON) and depth / sigma heatmaps of the newest keyframe (PNG,
through the port's own encoder).  The packet contract and the sigma-threshold
masking are the GUI's, so a live viewer (``gui/viewer.py``) attaches to
the same stream.  Packet fields may be tensors on any device.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..datasets.image_io import write_png
from ..geometry import se3
from ..utils import viz
from ..utils.evaluation import to_numpy


def _viz_count(packet) -> int:
    return int(packet.get("viz_count", len(packet["viz_idx"])))


def _c2w(packet, nv: int) -> np.ndarray:
    """(nv, 4, 4) camera-to-world matrices of the packet's poses (f32)."""
    poses = torch.as_tensor(to_numpy(packet["cam0_poses"])[:nv],
                            dtype=torch.float32)
    return se3.matrix(se3.inv(poses)).numpy()


def backproject_packet(packet: Dict[str, Any], sigma_thresh: float = 10.0,
                       stride: int = 2):
    """Viz packet -> (points (N, 3), colors (N, 3) uint8), a world-frame
    cloud of every ``stride``-th pixel whose inverse depth exceeds 1e-3
    and whose depth sigma is below ``sigma_thresh`` (the GUI's A/S-key
    threshold)."""
    nv = _viz_count(packet)
    c2w = _c2w(packet, nv)
    idepths = to_numpy(packet["cam0_idepths_up"])[:nv]
    covs = to_numpy(packet["cam0_depths_cov_up"])[:nv]
    imgs = to_numpy(packet["cam0_images"])[:nv]
    intr = to_numpy(packet["cam0_intrinsics"])[:nv] * 8.0
    pts_all, col_all = [], []
    n, H, W = idepths.shape
    for i in range(n):
        fx, fy, cx, cy = intr[i]
        u, v = np.meshgrid(np.arange(0, W, stride), np.arange(0, H, stride))
        idep = idepths[i][::stride, ::stride]
        sig = np.sqrt(np.maximum(covs[i][::stride, ::stride], 0))
        ok = (idep > 1e-3) & (sig < sigma_thresh)
        z = 1.0 / np.maximum(idep, 1e-6)
        x = (u + 0.5 - cx) / fx * z
        y = (v + 0.5 - cy) / fy * z
        pts = np.stack([x, y, z], -1)[ok]
        pts_all.append(pts @ c2w[i][:3, :3].T + c2w[i][:3, 3])
        col_all.append(imgs[i][::stride, ::stride][ok])
    if not pts_all:
        return np.zeros((0, 3)), np.zeros((0, 3), np.uint8)
    return np.concatenate(pts_all), np.concatenate(col_all)


def ply_text(points: np.ndarray, colors: np.ndarray) -> str:
    """An ASCII PLY of colored points."""
    header = ("ply\nformat ascii 1.0\n"
              f"element vertex {points.shape[0]}\n"
              "property float x\nproperty float y\nproperty float z\n"
              "property uchar red\nproperty uchar green\n"
              "property uchar blue\nend_header\n")
    return header + "".join(
        f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} "
        f"{int(c[0])} {int(c[1])} {int(c[2])}\n"
        for p, c in zip(points, colors))


def write_ply(path: str, points: np.ndarray, colors: np.ndarray):
    """Write an ASCII PLY of colored points (no open3d)."""
    with open(path, "w") as f:
        f.write(ply_text(points, colors))


class HeadlessGui:
    """The GUI stage's payload: ``visualize(packet)`` and the command
    back-channel ``pop_commands()``."""

    def __init__(self, out_dir: str = "viz_out", sigma_thresh: float = 10.0,
                 export_every: int = 10, max_cloud_points: int = 500000,
                 end_commands=("mesh", "eval")):
        self.out_dir = out_dir
        self.sigma_thresh = sigma_thresh
        self.export_every = export_every
        self.max_cloud_points = max_cloud_points
        self.n_packets = 0
        self.trajectory = []
        # commands to the fusion stage (the GUI's key bindings), drained by
        # the GuiModule; the end commands follow the last packet
        self._commands = []
        self.end_commands = list(end_commands or ())
        os.makedirs(out_dir, exist_ok=True)

    # the command back-channel (NeRF-SLAM's key bindings)
    def request_mesh(self):                       # 'M'
        self._commands.append({"cmd": "mesh"})

    def request_eval(self):                       # 'N'
        self._commands.append({"cmd": "eval"})

    def adjust_sigma_thresh(self, value: float):  # 'A'/'S'
        self.sigma_thresh = float(value)
        self._commands.append({"cmd": "sigma_thresh",
                               "value": float(value)})

    def toggle_mask(self):                        # 'T'
        self._commands.append({"cmd": "toggle_mask"})

    def request_rebuild(self):                    # 'Z'
        """Replay the TSDF keyframe history at the current threshold."""
        self._commands.append({"cmd": "rebuild",
                               "value": float(self.sigma_thresh)})

    def pop_commands(self):
        out, self._commands = self._commands, []
        return out

    def visualize(self, packet: Optional[Dict[str, Any]]):
        if packet is None or "cam0_poses" not in packet:
            return packet
        self.n_packets += 1
        nv = _viz_count(packet)
        c2w = _c2w(packet, nv)
        covs = to_numpy(packet["world_T_body_cov"])[:nv]
        for i, idx in enumerate(np.asarray(packet["viz_idx"])[:nv]):
            radii, axes = viz.pose_cov_ellipsoid(covs[i])
            self.trajectory.append({"kf": int(idx), "c2w": c2w[i].tolist(),
                                    "cov_radii": radii.tolist(),
                                    "cov_axes": axes.tolist()})
        if self.n_packets % self.export_every == 0 or \
                packet.get("is_last_frame"):
            self.export(packet)
        if packet.get("is_last_frame"):
            for cmd in self.end_commands:
                self._commands.append({"cmd": cmd})
        return packet

    def export(self, packet):
        """cloud_<n>.ply, trajectory.json, and depth_<n>.png / sigma_<n>.png
        of the newest keyframe, into ``out_dir``."""
        tag = f"{self.n_packets:05d}"
        pts, cols = backproject_packet(packet, self.sigma_thresh)
        if pts.shape[0] > self.max_cloud_points:
            sel = np.random.RandomState(0).choice(
                pts.shape[0], self.max_cloud_points, replace=False)
            pts, cols = pts[sel], cols[sel]
        if pts.shape[0]:
            write_ply(os.path.join(self.out_dir, f"cloud_{tag}.ply"), pts,
                      cols)
        with open(os.path.join(self.out_dir, "trajectory.json"), "w") as f:
            json.dump(self.trajectory, f)
        nv = _viz_count(packet)
        idep = to_numpy(packet["cam0_idepths_up"][nv - 1])
        cov = to_numpy(packet["cam0_depths_cov_up"][nv - 1])
        with np.errstate(divide="ignore"):
            depth = np.where(idep > 1e-3, 1.0 / idep, 0.0)
        write_png(os.path.join(self.out_dir, f"depth_{tag}.png"),
                  viz.depth_to_rgb(depth))
        write_png(os.path.join(self.out_dir, f"sigma_{tag}.png"),
                  viz.sigma_to_rgb(cov))
