"""instant-ngp ``transforms.json`` dataset loader (host numpy).

The JAX package's ``datasets/nerf_dataset.py`` with the port's own image
reader (``image_io``) in place of OpenCV: parses the json, converts the
poses, plans a resize to at most 640x640 with both sides multiples of 8
(the intrinsics rescaled), and reads uint16 depth PNGs through
``integer_depth_scale``.

Packets carry **OpenCV c2w** poses (x right, y down, z forward) in world
units, as the JAX package's do.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np

from . import image_io
from .base import (CameraCalibration, Dataset, PinholeCameraModel,
                   Resolution)
from ..utils.conversions import opengl_to_opencv_c2w


class NeRFDataset(Dataset):
    def __init__(self, dataset_dir: str, initial_k: int = 0,
                 final_k: int = -1, img_stride: int = 1,
                 buffer: int = 512):
        super().__init__("nerf", dataset_dir, initial_k, final_k,
                         img_stride, buffer=buffer)
        self._parse_metadata()

    def _parse_metadata(self):
        with open(os.path.join(self.dataset_dir, "transforms.json")) as f:
            self.meta = json.load(f)
        m = self.meta

        W = int(m.get("w", 0))
        H = int(m.get("h", 0))
        fx = float(m.get("fl_x", 0.0))
        fy = float(m.get("fl_y", fx))
        cx = float(m.get("cx", W / 2))
        cy = float(m.get("cy", H / 2))
        self.depth_scale = float(m.get("integer_depth_scale", 1.0))
        aabb = np.array(m.get("aabb",
                              [[-2.0, -2.0, -2.0], [2.0, 2.0, 2.0]]))

        frames = m["frames"]
        final = self.final_k if self.final_k > 0 else len(frames)
        frames = frames[self.initial_k:final:self.img_stride]

        def sort_key(fr):
            base = os.path.splitext(os.path.basename(fr["file_path"]))[0]
            digits = "".join(c for c in base if c.isdigit())
            return int(digits) if digits else 0

        # the digit sort comes after the slice, as in the JAX loader
        frames = sorted(frames, key=sort_key)

        self.image_paths = []
        self.depth_paths = []
        self.c2w = []
        for fr in frames:
            p = fr["file_path"]
            if not (p.endswith(".png") or p.endswith(".jpg")):
                p += ".png"
            self.image_paths.append(os.path.join(self.dataset_dir, p))
            dp = fr.get("depth_path")
            self.depth_paths.append(
                os.path.join(self.dataset_dir, dp) if dp else None)
            # transforms.json stores OpenGL/NeRF c2w
            self.c2w.append(
                opengl_to_opencv_c2w(np.array(fr["transform_matrix"])))

        # the resize plan (NeRF-SLAM's nerf_dataset.py:44-62)
        if H * W > 640 * 640:
            total = 341 * 640
            h1 = int(H * np.sqrt(total / (H * W)))
            w1 = int(W * np.sqrt(total / (H * W)))
            h1 -= h1 % 8
            w1 -= w1 % 8
            self.scale_xy = (w1 / W, h1 / H)
        else:
            h1, w1 = H - H % 8, W - W % 8
            self.scale_xy = (w1 / W, h1 / H) if (h1 != H or w1 != W) \
                else (1.0, 1.0)
        self.out_hw = (h1, w1)

        cam = PinholeCameraModel(fx, fy, cx, cy).scale_intrinsics(
            *self.scale_xy)
        self.calib = CameraCalibration(
            camera_model=cam,
            resolution=Resolution(self.out_hw[1], self.out_hw[0]),
            aabb=aabb, depth_scale=self.depth_scale)

    def __len__(self):
        return len(self.image_paths)

    def _load_image(self, path: str) -> np.ndarray:
        if path.endswith(".jpg"):
            img = image_io.read_jpeg_rgb(path)
        else:
            img = image_io.imread(path, image_io.IMREAD_UNCHANGED)
            if img.ndim == 2:
                img = np.repeat(img[..., None], 3, -1)
        h1, w1 = self.out_hw
        if img.shape[:2] != (h1, w1):
            img = image_io.resize_area(img, h1, w1)
        return np.ascontiguousarray(img[..., :3], dtype=np.uint8)

    def _load_depth(self, path: Optional[str]) -> Optional[np.ndarray]:
        if path is None or not os.path.exists(path):
            return None
        d = image_io.imread(path, image_io.IMREAD_UNCHANGED)
        d = d.astype(np.int32).astype(np.float32) * self.depth_scale
        h1, w1 = self.out_hw
        if d.shape[:2] != (h1, w1):
            d = image_io.resize_nearest(d, h1, w1)
        return d

    def __getitem__(self, k: int) -> Dict:
        return {
            "k": k,
            "t_cams": float(k),
            "poses": self.c2w[k].astype(np.float32),
            "images": self._load_image(self.image_paths[k]),
            "depths": self._load_depth(self.depth_paths[k]),
            "intrinsics": self.calib.camera_model.numpy(),
            "calib": self.calib,
            "is_last_frame": k == len(self) - 1,
        }


def export_nerf_format(dataset, out_dir: str, depth_scale: float = 1e-3):
    """Write any packet dataset as a transforms.json scene (NeRF-SLAM's
    replica -> nerf converter, scripts/replica_to_nerf_dataset.py), with
    the port's PNG encoder."""
    os.makedirs(os.path.join(out_dir, "images"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "depths"), exist_ok=True)
    frames = []
    positions = []
    intr = None
    hw = None
    for pkt in dataset:
        k = pkt["k"]
        img = pkt["images"]
        hw = img.shape[:2]
        intr = pkt["intrinsics"]
        rel_img = f"images/frame{k:06d}.png"
        image_io.write_png(os.path.join(out_dir, rel_img),
                           np.asarray(img, np.uint8))
        fr = {"file_path": rel_img}
        if pkt.get("depths") is not None:
            rel_d = f"depths/depth{k:06d}.png"
            d16 = np.clip(pkt["depths"] / depth_scale, 0,
                          65535).astype(np.uint16)
            image_io.write_png(os.path.join(out_dir, rel_d), d16)
            fr["depth_path"] = rel_d
        c2w_gl = opengl_to_opencv_c2w(pkt["poses"])  # involution: cv->gl
        fr["transform_matrix"] = np.asarray(c2w_gl, np.float64).tolist()
        positions.append(np.asarray(pkt["poses"])[:3, 3])
        frames.append(fr)

    positions = np.stack(positions)
    margin = 2.0
    aabb = [(positions.min(0) - margin).tolist(),
            (positions.max(0) + margin).tolist()]
    meta = {
        "w": hw[1], "h": hw[0],
        "fl_x": float(intr[0]), "fl_y": float(intr[1]),
        "cx": float(intr[2]), "cy": float(intr[3]),
        "integer_depth_scale": depth_scale,
        "aabb": aabb,
        "frames": frames,
    }
    with open(os.path.join(out_dir, "transforms.json"), "w") as f:
        json.dump(meta, f)
    return out_dir
