"""Live RealSense camera source.

The JAX package's ``datasets/realsense_dataset.py`` (NeRF-SLAM's
datasets/real_sense_dataset.py): a blocking ``stream()`` returning one
packet per call with identity poses.  Requires ``pyrealsense2``, imported
in the constructor, which raises ``ImportError`` where it is absent.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from .base import (CameraCalibration, Dataset, PinholeCameraModel,
                   Resolution)


class RealSenseDataset(Dataset):
    def __init__(self, width: int = 640, height: int = 480,
                 fps: int = 30, buffer: int = 512):
        super().__init__("realsense", dataset_dir="", buffer=buffer)
        try:
            import pyrealsense2 as rs
        except ImportError as e:
            raise ImportError(
                "pyrealsense2 is required for the live RealSense source "
                "(not available in this environment)") from e
        self._rs = rs
        self.pipeline = rs.pipeline()
        cfg = rs.config()
        cfg.enable_stream(rs.stream.color, width, height,
                          rs.format.rgb8, fps)
        cfg.enable_stream(rs.stream.depth, width, height,
                          rs.format.z16, fps)
        profile = self.pipeline.start(cfg)
        sp = profile.get_stream(rs.stream.color).as_video_stream_profile()
        intr = sp.get_intrinsics()
        self.calib = CameraCalibration(
            camera_model=PinholeCameraModel(intr.fx, intr.fy,
                                            intr.ppx, intr.ppy),
            resolution=Resolution(width, height),
            rate_hz=fps,
            depth_scale=profile.get_device().first_depth_sensor()
            .get_depth_scale())
        self._k = 0

    def __len__(self):
        return self.buffer

    def __getitem__(self, k: int) -> Dict:
        return self.stream()

    def stream(self) -> Optional[Dict]:
        frames = self.pipeline.wait_for_frames()
        color = np.asanyarray(frames.get_color_frame().get_data())
        depth = np.asanyarray(frames.get_depth_frame().get_data()) \
            .astype(np.float32) * self.calib.depth_scale
        k = self._k
        self._k += 1
        return {
            "k": k,
            "t_cams": frames.get_timestamp() * 1e-3,
            "poses": np.eye(4, dtype=np.float32),
            "images": color,
            "depths": depth,
            "intrinsics": self.calib.camera_model.numpy(),
            "calib": self.calib,
            "is_last_frame": k >= self.buffer - 1,
        }
