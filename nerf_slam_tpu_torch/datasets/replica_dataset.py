"""Replica dataset loader (NICE-SLAM/iMAP export layout, host numpy).

The JAX package's ``datasets/replica_dataset.py``: reads
``results/frame*.jpg`` + ``results/depth*.png`` + ``traj.txt`` (c2w,
row-major 4x4 per line) + ``cam_params.json`` (in the scene directory or
its parent); the stored poses are in the NeRF/OpenGL convention, so the
y/z camera axes are flipped to OpenCV.  Depth PNGs go through the port's
own codec; the JPEG color frames need OpenCV or Pillow, and the
constructor raises ``ImportError`` naming both when neither is installed.
"""
from __future__ import annotations

import glob
import json
import os
from typing import Dict

import numpy as np

from . import image_io
from .base import (CameraCalibration, Dataset, PinholeCameraModel,
                   Resolution)
from ..utils.conversions import opengl_to_opencv_c2w


class ReplicaDataset(Dataset):
    def __init__(self, dataset_dir: str, initial_k: int = 0,
                 final_k: int = -1, img_stride: int = 1,
                 buffer: int = 512):
        super().__init__("replica", dataset_dir, initial_k, final_k,
                         img_stride, buffer=buffer)
        if not image_io.jpeg_decoder_available():
            raise ImportError("ReplicaDataset's JPEG color frames need "
                              "OpenCV (cv2) or Pillow (PIL); neither is "
                              "installed")
        self._parse()

    def _parse(self):
        d = self.dataset_dir
        self.image_paths = sorted(
            glob.glob(os.path.join(d, "results", "frame*.jpg")))
        self.depth_paths = sorted(
            glob.glob(os.path.join(d, "results", "depth*.png")))
        traj = np.loadtxt(os.path.join(d, "traj.txt")).reshape(-1, 4, 4)

        final = self.final_k if self.final_k > 0 else len(self.image_paths)
        sl = slice(self.initial_k, final, self.img_stride)
        self.image_paths = self.image_paths[sl]
        self.depth_paths = self.depth_paths[sl]
        self.c2w = [opengl_to_opencv_c2w(m) for m in traj[sl]]

        # cam_params.json may live in the scene dir or one level up
        for p in (os.path.join(d, "cam_params.json"),
                  os.path.join(os.path.dirname(d), "cam_params.json")):
            if os.path.exists(p):
                with open(p) as f:
                    cam = json.load(f)["camera"]
                break
        else:
            raise FileNotFoundError("cam_params.json not found")

        self.depth_scale = 1.0 / float(cam["scale"])
        model = PinholeCameraModel(cam["fx"], cam["fy"],
                                   cam["cx"], cam["cy"])
        self.calib = CameraCalibration(
            camera_model=model,
            resolution=Resolution(int(cam["w"]), int(cam["h"])),
            depth_scale=self.depth_scale)

    def __len__(self):
        return len(self.image_paths)

    def __getitem__(self, k: int) -> Dict:
        img = image_io.read_jpeg_rgb(self.image_paths[k])
        depth = None
        if k < len(self.depth_paths):
            d16 = image_io.imread(self.depth_paths[k],
                                  image_io.IMREAD_UNCHANGED)
            depth = d16.astype(np.float32) * self.depth_scale
        return {
            "k": k,
            "t_cams": float(k) / 30.0,
            "poses": np.asarray(self.c2w[k], np.float32),
            "images": np.ascontiguousarray(img, np.uint8),
            "depths": depth,
            "intrinsics": self.calib.camera_model.numpy(),
            "calib": self.calib,
            "is_last_frame": k == len(self) - 1,
        }
