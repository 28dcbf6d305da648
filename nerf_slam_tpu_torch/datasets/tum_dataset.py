"""TUM RGB-D dataset loader (host numpy).

The JAX package's ``datasets/tum_dataset.py`` with the port's own image
reader (``image_io``) in place of OpenCV: associates ``rgb.txt`` and
``depth.txt`` by timestamp, reads the ground truth from
``groundtruth.txt`` ([t, tx ty tz qx qy qz qw], c2w), resizes to
``target_hw`` (384x512) floored to multiples of 8 with the intrinsics
rescaled (area for color, nearest for depth), depth scale 1/5000.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import image_io
from .base import (CameraCalibration, Dataset, PinholeCameraModel,
                   Resolution)

# freiburg default intrinsics (fr3); per-sequence files override
_TUM_INTRINSICS = {
    "fr1": (517.3, 516.5, 318.6, 255.3),
    "fr2": (520.9, 521.0, 325.1, 249.7),
    "fr3": (535.4, 539.2, 320.1, 247.6),
}


def _read_list(path: str) -> List[Tuple[float, str]]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            out.append((float(parts[0]), parts[1]))
    return out


def _associate(a, b, max_dt=0.02):
    """Greedy nearest-timestamp association: for each of ``a`` in order,
    the nearest of ``b`` from where the last match left off, kept within
    ``max_dt`` seconds."""
    out = []
    bi = 0
    for ta, pa in a:
        while bi + 1 < len(b) and abs(b[bi + 1][0] - ta) <= \
                abs(b[bi][0] - ta):
            bi += 1
        if abs(b[bi][0] - ta) < max_dt:
            out.append((ta, pa, b[bi][1]))
    return out


def _quat_to_mat(q):
    x, y, z, w = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


class TumDataset(Dataset):
    def __init__(self, dataset_dir: str, initial_k: int = 0,
                 final_k: int = -1, img_stride: int = 1,
                 buffer: int = 512, target_hw=(384, 512)):
        super().__init__("tum", dataset_dir, initial_k, final_k,
                         img_stride, buffer=buffer)
        self.target_hw = target_hw
        self._parse()

    def _parse(self):
        d = self.dataset_dir
        rgb = _read_list(os.path.join(d, "rgb.txt"))
        depth = _read_list(os.path.join(d, "depth.txt")) \
            if os.path.exists(os.path.join(d, "depth.txt")) else []
        assoc = _associate(rgb, depth) if depth else \
            [(t, p, None) for t, p in rgb]

        gt = None
        gt_path = os.path.join(d, "groundtruth.txt")
        if os.path.exists(gt_path):
            rows = []
            with open(gt_path) as f:
                for line in f:
                    if line.startswith("#"):
                        continue
                    rows.append([float(v) for v in line.split()])
            gt = np.asarray(rows)

        final = self.final_k if self.final_k > 0 else len(assoc)
        assoc = assoc[self.initial_k:final:self.img_stride]
        self.frames = assoc
        self.gt = gt

        key = next((k for k in _TUM_INTRINSICS if k in d.lower()), "fr3")
        fx, fy, cx, cy = _TUM_INTRINSICS[key]
        # resize plan
        probe = image_io.imread(os.path.join(d, assoc[0][1]))
        H, W = probe.shape[:2]
        h1 = self.target_hw[0] - self.target_hw[0] % 8
        w1 = self.target_hw[1] - self.target_hw[1] % 8
        self.out_hw = (h1, w1)
        sx, sy = w1 / W, h1 / H
        self.calib = CameraCalibration(
            camera_model=PinholeCameraModel(fx, fy, cx, cy)
            .scale_intrinsics(sx, sy),
            resolution=Resolution(w1, h1),
            depth_scale=1.0 / 5000.0)

    def _gt_pose(self, t: float) -> Optional[np.ndarray]:
        if self.gt is None or self.gt.shape[0] == 0:
            return None
        i = int(np.argmin(np.abs(self.gt[:, 0] - t)))
        row = self.gt[i]
        c2w = np.eye(4)
        c2w[:3, :3] = _quat_to_mat(row[4:8])
        c2w[:3, 3] = row[1:4]
        return c2w

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, k: int) -> Dict:
        t, rgb_p, d_p = self.frames[k]
        img = image_io.imread(os.path.join(self.dataset_dir, rgb_p))
        h1, w1 = self.out_hw
        img = image_io.resize_area(img, h1, w1)
        depth = None
        if d_p is not None:
            d16 = image_io.imread(os.path.join(self.dataset_dir, d_p),
                                  image_io.IMREAD_UNCHANGED)
            depth = d16.astype(np.float32) * self.calib.depth_scale
            depth = image_io.resize_nearest(depth, h1, w1)
        pose = self._gt_pose(t)
        return {
            "k": k,
            "t_cams": t,
            "poses": None if pose is None else pose.astype(np.float32),
            "images": np.ascontiguousarray(img, np.uint8),
            "depths": depth,
            "intrinsics": self.calib.camera_model.numpy(),
            "calib": self.calib,
            "is_last_frame": k == len(self) - 1,
        }
