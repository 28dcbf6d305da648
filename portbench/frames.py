"""The benchmark's frames: a frozen torch copy of the port's synthetic box
room (``nerf_slam_tpu_torch/datasets/synthetic.py``: the empty room, its
orbit, its texture and its camera), rendered on the device.

The seed picks where on the orbit a sequence starts (``start_deg``,
uniform over the turn); the room and its texture are the legacy room's
for every seed.  So every seed sees the same room along the same orbit,
in another order, with the same frame count, shapes and motion: the
seed moves the work as little as a SLAM input can.  ``render`` returns
host uint8 images, as a loader would hand them, and the world_T_cam
ground-truth poses; on request also each frame's z-depth in metres (an
RGB-D sensor's) and the right view of a stereo rig, the synthetic
dataset's ``depths`` and ``images_right``.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

ROOM_HALF = 2.0
ROOM_HEIGHT = 2.5
ORBIT_RADIUS = 0.8
BOB_AMP = 0.2
LEGACY_PHASES = (1.7, 0.5, 2.9, 0.0)


def start_deg(seed: int) -> float:
    """Where on the orbit the sequence of ``seed`` starts, in degrees."""
    return float(np.random.default_rng(int(seed)).uniform(0.0, 360.0))


def intrinsics(height: int, width: int, fov_deg: float) -> np.ndarray:
    f = 0.5 * width / np.tan(np.radians(fov_deg) / 2)
    return np.array([f, f, width / 2, height / 2], dtype=np.float32)


def _look_at(eye: np.ndarray, target: np.ndarray) -> np.ndarray:
    up = np.array([0.0, 0.0, 1.0])
    z = target - eye
    z = z / np.linalg.norm(z)
    x = np.cross(z, up)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    c2w = np.eye(4)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, y, z, eye
    return c2w


def trajectory(n_frames: int, deg_per_frame: float,
               start_deg: float = 0.0) -> np.ndarray:
    """(n, 4, 4) float64 world_T_cam along the room's orbit."""
    out = np.empty((n_frames, 4, 4))
    for i in range(n_frames):
        a = np.radians(start_deg + i * deg_per_frame)
        eye = np.array([ORBIT_RADIUS * np.cos(a), ORBIT_RADIUS * np.sin(a),
                        0.5 * ROOM_HEIGHT + BOB_AMP * np.sin(2 * a)])
        target = np.array([2.0 * np.cos(a + 0.7), 2.0 * np.sin(a + 0.7),
                           0.5 * ROOM_HEIGHT])
        out[i] = _look_at(eye, target)
    return out


def _texture(p: torch.Tensor, axis: torch.Tensor, ph) -> torch.Tensor:
    x, y, z = p.unbind(-1)
    r = 0.5 + 0.25 * torch.sin(3.1 * x + ph[0]) * torch.cos(2.3 * y + ph[3])
    g = 0.5 + 0.25 * torch.sin(2.7 * y + ph[1]) * torch.cos(3.7 * z + ph[3])
    b = 0.5 + 0.25 * torch.sin(4.1 * z + ph[2]) * torch.cos(1.9 * x + ph[3])
    c = torch.remainder(torch.floor(2.5 * x + ph[3]) + torch.floor(2.5 * y)
                        + torch.floor(2.5 * z), 2.0)
    shade = 0.85 + 0.15 * (axis.to(p.dtype) / 2.0)
    rgb = torch.stack([r + 0.15 * c, g + 0.12 * c, b + 0.1 * c], dim=-1)
    return torch.clamp(rgb * shade[..., None], 0.0, 1.0)


def _render_batch(c2w: torch.Tensor, K, h: int, w: int, ph,
                  depth: bool = False):
    """(n, 4, 4) float64 poses -> (n, h, w, 3) uint8 on their device and,
    with ``depth``, the (n, h, w) float32 z-depth (the ray parameter of
    the hit: the camera rays have z = 1)."""
    dev, f64 = c2w.device, torch.float64
    v, u = torch.meshgrid(torch.arange(h, dtype=f64, device=dev) + 0.5,
                          torch.arange(w, dtype=f64, device=dev) + 0.5,
                          indexing="ij")
    fx, fy, cx, cy = (float(k) for k in K)
    dirs_cam = torch.stack([(u - cx) / fx, (v - cy) / fy,
                            torch.ones_like(u)], dim=-1)
    R, t = c2w[:, :3, :3], c2w[:, :3, 3]
    dirs = torch.einsum("hwj,nij->nhwi", dirs_cam, R)
    lo = (-ROOM_HALF, -ROOM_HALF, 0.0)
    hi = (ROOM_HALF, ROOM_HALF, ROOM_HEIGHT)
    n = c2w.shape[0]
    tmax = torch.full((n, h, w), math.inf, dtype=f64, device=dev)
    axis = torch.zeros((n, h, w), dtype=torch.int64, device=dev)
    for ax in range(3):
        for bound in (lo[ax], hi[ax]):
            d = dirs[..., ax]
            s = (bound - t[:, ax, None, None]) / d
            s = torch.where(d.abs() < 1e-9, math.inf, s)
            p = t[:, None, None, :] + s[..., None] * dirs
            ok = s > 1e-6
            for other in range(3):
                if other != ax:
                    ok &= (p[..., other] >= lo[other] - 1e-6) \
                        & (p[..., other] <= hi[other] + 1e-6)
            better = ok & (s < tmax)
            tmax = torch.where(better, s, tmax)
            axis = torch.where(better, ax, axis)
    pts = t[:, None, None, :] + tmax[..., None] * dirs
    rgb = (_texture(pts, axis, ph) * 255).to(torch.uint8)
    return (rgb, tmax.to(torch.float32)) if depth else rgb


class Frames(NamedTuple):
    images: np.ndarray                   # (n, H, W, 3) uint8
    poses: np.ndarray                    # (n, 4, 4) float32 world_T_cam
    K: np.ndarray                        # (4,) float32 fx, fy, cx, cy
    depths: Optional[np.ndarray] = None  # (n, H, W) float32 metres
    images_right: Optional[np.ndarray] = None   # (n, H, W, 3) uint8


def render(n_frames: int, height: int, width: int, fov_deg: float,
           deg_per_frame: float, seed: int, device, chunk: int = 16,
           depths: bool = False, baseline: Optional[float] = None
           ) -> Frames:
    """A sequence along the orbit, on the host.  ``depths``: each frame's
    z-depth too; ``baseline`` (metres): the right view too, from each
    pose moved by ``baseline`` along the camera's x axis."""
    K = intrinsics(height, width, fov_deg)
    poses = trajectory(n_frames, deg_per_frame, start_deg(seed))
    ph = LEGACY_PHASES
    c2w = torch.as_tensor(poses, dtype=torch.float64, device=device)
    out = torch.empty((n_frames, height, width, 3), dtype=torch.uint8)
    depth = torch.empty((n_frames, height, width), dtype=torch.float32) \
        if depths else None
    right = torch.empty_like(out) if baseline is not None else None
    for s in range(0, n_frames, chunk):
        got = _render_batch(c2w[s:s + chunk], K, height, width, ph, depths)
        if depths:
            got, d = got
            depth[s:s + chunk] = d.cpu()
        out[s:s + chunk] = got.cpu()
        if right is not None:
            c2w_r = c2w[s:s + chunk].clone()
            c2w_r[:, :3, 3] += baseline * c2w_r[:, :3, 0]
            right[s:s + chunk] = _render_batch(c2w_r, K, height, width,
                                               ph).cpu()
    return Frames(out.numpy(), poses.astype(np.float32), K,
                  None if depth is None else depth.numpy(),
                  None if right is None else right.numpy())
