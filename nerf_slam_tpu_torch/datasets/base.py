"""Dataset base classes and camera calibration containers.

Equivalent of NeRF-SLAM's datasets/dataset.py:9-140: the Dataset ABC
(dir, initial/final frame, stride, buffer) and the calibration value
types (pinhole model with rescaling, distortion, body_T_cam, aabb,
depth scale, IMU parameters).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


@dataclass
class Resolution:
    width: int
    height: int

    @property
    def total(self) -> int:
        return self.width * self.height


@dataclass
class PinholeCameraModel:
    fx: float
    fy: float
    cx: float
    cy: float

    def numpy(self) -> np.ndarray:
        return np.array([self.fx, self.fy, self.cx, self.cy], np.float32)

    def scale_intrinsics(self, sx: float, sy: float
                         ) -> "PinholeCameraModel":
        """Rescale for a resized image (dataset.py:81-91)."""
        return PinholeCameraModel(self.fx * sx, self.fy * sy,
                                  self.cx * sx, self.cy * sy)

    def matrix(self) -> np.ndarray:
        K = np.eye(3)
        K[0, 0], K[1, 1] = self.fx, self.fy
        K[0, 2], K[1, 2] = self.cx, self.cy
        return K


@dataclass
class RadTanDistortionModel:
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0

    def numpy(self) -> np.ndarray:
        return np.array([self.k1, self.k2, self.p1, self.p2], np.float32)


@dataclass
class CameraCalibration:
    camera_model: PinholeCameraModel
    distortion_model: RadTanDistortionModel = field(
        default_factory=RadTanDistortionModel)
    resolution: Resolution = field(
        default_factory=lambda: Resolution(640, 480))
    body_T_cam: np.ndarray = field(default_factory=lambda: np.eye(4))
    rate_hz: float = 30.0
    aabb: np.ndarray = field(default_factory=lambda: np.array(
        [[-2.0, -2.0, -2.0], [2.0, 2.0, 2.0]]))
    depth_scale: float = 1.0


@dataclass
class ImuCalibration:
    body_T_imu: np.ndarray = field(default_factory=lambda: np.eye(4))
    a_n: float = 2e-3      # accel noise density
    a_b: float = 3e-3      # accel bias random walk
    g_n: float = 1.7e-4    # gyro noise density
    g_b: float = 2e-5      # gyro bias random walk
    rate_hz: float = 200.0
    imu_integration_sigma: float = 1e-8
    imu_time_shift: float = 0.0
    n_gravity: np.ndarray = field(
        default_factory=lambda: np.array([0.0, 0.0, -9.81]))


class Dataset:
    """Index/stream dataset ABC (dataset.py:9-44 contract).

    Subclasses fill self.packets lazily or override __getitem__.
    Packets: {k, t_cams, poses (c2w 4x4), images (H,W,3) u8, depths
    (H,W) or None, intrinsics (4,), calib, is_last_frame}.
    """

    def __init__(self, name: str, dataset_dir: str, initial_k: int = 0,
                 final_k: int = -1, img_stride: int = 1,
                 stereo: bool = False, buffer: int = 512):
        self.name = name
        self.dataset_dir = dataset_dir
        self.initial_k = initial_k
        self.final_k = final_k
        self.img_stride = img_stride
        self.stereo = stereo
        self.buffer = buffer

    def __len__(self) -> int:
        raise NotImplementedError

    def __getitem__(self, k: int) -> Dict:
        raise NotImplementedError

    def __iter__(self) -> Iterator[Dict]:
        for k in range(len(self)):
            yield self[k]

    def stream(self) -> Optional[Dict]:
        """Live sources override (real_sense_dataset.py:112-176)."""
        return None


def resize_to_multiple_of_8(img: np.ndarray, max_hw=(640, 640)
                            ) -> Tuple[np.ndarray, float, float]:
    """Resize so max dims fit and H, W are multiples of 8
    (nerf_dataset.py:54-62 semantics).  Returns (img, sx, sy)."""
    from .image_io import resize_area
    H, W = img.shape[:2]
    s = min(1.0, max_hw[0] / H, max_hw[1] / W)
    newH = int((H * s) // 8 * 8)
    newW = int((W * s) // 8 * 8)
    out = resize_area(img, newH, newW)
    return out, newW / W, newH / H
