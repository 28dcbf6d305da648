"""EuRoC MAV dataset loader (mono + stereo + IMU, host numpy).

The JAX package's ``datasets/euroc_dataset.py`` with the port's own
sensor-file reader, rectification and remapping (``rectify``) and PNG
reader (``image_io``) in place of PyYAML and OpenCV: YAML sensor
calibration (cam0/cam1/imu0/ground truth), CSV parsing, radial-tangential
undistortion + resize for the mono pipeline, nearest-timestamp GT lookup.
Stereo mode rectifies cam0/cam1 to a shared pinhole (NeRF-SLAM hardcodes
the EuRoC rectification matrices, datasets/euroc_dataset.py:37-62; they
are derived from the sensor files here, so any EuRoC-layout rig works)
and emits ``images_right`` + ``stereo_rel`` (cam1_T_cam0 [t, q_xyzw]) per
packet, the contract the stereo frontend consumes.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from . import image_io
from .base import (CameraCalibration, Dataset, ImuCalibration,
                   PinholeCameraModel, RadTanDistortionModel, Resolution)
from .rectify import (load_sensor_yaml, remap_bilinear, stereo_rectify,
                      undistort_rectify_map)


def _quat_wxyz_to_mat(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


class EurocDataset(Dataset):
    def __init__(self, dataset_dir: str, initial_k: int = 0,
                 final_k: int = -1, img_stride: int = 1,
                 buffer: int = 512, target_hw=(384, 512),
                 stereo: bool = False):
        super().__init__("euroc", dataset_dir, initial_k, final_k,
                         img_stride, buffer=buffer)
        self.target_hw = target_hw
        self.stereo = stereo
        self._parse()

    def _mav(self, *parts) -> str:
        d = self.dataset_dir
        if os.path.isdir(os.path.join(d, "mav0")):
            return os.path.join(d, "mav0", *parts)
        return os.path.join(d, *parts)

    def _parse(self):
        cam = load_sensor_yaml(self._mav("cam0", "sensor.yaml"))
        fx, fy, cx, cy = cam["intrinsics"]
        k1, k2, p1, p2 = cam["distortion_coefficients"]
        W, H = cam["resolution"]
        body_T_cam = np.array(cam["T_BS"]["data"]).reshape(4, 4)

        h1 = self.target_hw[0] - self.target_hw[0] % 8
        w1 = self.target_hw[1] - self.target_hw[1] % 8
        self.out_hw = (h1, w1)
        sx, sy = w1 / W, h1 / H
        self.K_orig = PinholeCameraModel(fx, fy, cx, cy)
        self.dist = RadTanDistortionModel(k1, k2, p1, p2)
        self.calib = CameraCalibration(
            camera_model=self.K_orig.scale_intrinsics(sx, sy),
            distortion_model=RadTanDistortionModel(),  # undistorted output
            resolution=Resolution(w1, h1), body_T_cam=body_T_cam,
            rate_hz=float(cam.get("rate_hz", 20.0)))

        # image list
        csv = np.genfromtxt(self._mav("cam0", "data.csv"), delimiter=",",
                            dtype=str, skip_header=1)
        final = self.final_k if self.final_k > 0 else csv.shape[0]
        csv = csv[self.initial_k:final:self.img_stride]
        self.timestamps = csv[:, 0].astype(np.int64)
        self.image_files = [self._mav("cam0", "data", name.strip())
                            for name in csv[:, 1]]

        # stereo: rectify cam0/cam1 to a shared pinhole, derived from the
        # sensor files (NeRF-SLAM bakes EuRoC's matrices in)
        self.stereo_rel = None
        self._maps_r = None
        if self.stereo:
            self._setup_stereo(np.array([fx, fy, cx, cy]),
                               np.array([k1, k2, p1, p2, 0.0]),
                               (W, H), body_T_cam)

        # IMU
        self.imu = None
        imu_yaml = self._mav("imu0", "sensor.yaml")
        if os.path.exists(imu_yaml):
            iy = load_sensor_yaml(imu_yaml)
            self.imu = ImuCalibration(
                body_T_imu=np.array(iy["T_BS"]["data"]).reshape(4, 4),
                a_n=float(iy.get("accelerometer_noise_density", 2e-3)),
                a_b=float(iy.get("accelerometer_random_walk", 3e-3)),
                g_n=float(iy.get("gyroscope_noise_density", 1.7e-4)),
                g_b=float(iy.get("gyroscope_random_walk", 2e-5)),
                rate_hz=float(iy.get("rate_hz", 200.0)))
            imu_csv = self._mav("imu0", "data.csv")
            if os.path.exists(imu_csv):
                self.imu_data = np.genfromtxt(imu_csv, delimiter=",",
                                              skip_header=1)
            else:
                self.imu_data = None

        # ground truth
        self.gt = None
        gt_csv = self._mav("state_groundtruth_estimate0", "data.csv")
        if os.path.exists(gt_csv):
            self.gt = np.genfromtxt(gt_csv, delimiter=",", skip_header=1)

        if not self.stereo:
            self._maps = None    # built lazily (mono undistort+resize)

    def _setup_stereo(self, K0_vec, d0, wh, body_T_cam0):
        """Joint cam0/cam1 rectification to a shared pinhole at out_hw.

        After rectification both cameras share P_rect's intrinsics, the
        relative pose collapses to a pure x-baseline, and epipolar lines
        are horizontal -- exactly the geometry the frontend's (i, i)
        stereo edges assume (stereo_rel = cam1_T_cam0 = [-b, 0, 0, id]).
        """
        cam1 = load_sensor_yaml(self._mav("cam1", "sensor.yaml"))
        fx1, fy1, cx1, cy1 = cam1["intrinsics"]
        dist1 = list(cam1["distortion_coefficients"]) + [0.0]
        body_T_cam1 = np.array(cam1["T_BS"]["data"]).reshape(4, 4)
        W, H = wh
        h1, w1 = self.out_hw

        K0 = np.array([[K0_vec[0], 0, K0_vec[2]],
                       [0, K0_vec[1], K0_vec[3]], [0, 0, 1.0]])
        K1 = np.array([[fx1, 0, cx1], [0, fy1, cy1], [0, 0, 1.0]])
        cam1_T_cam0 = np.linalg.inv(body_T_cam1) @ body_T_cam0
        R1, R2, P1, P2 = stereo_rectify(
            K0, np.asarray(d0[:4], np.float64),
            K1, np.asarray(dist1[:4], np.float64), (W, H),
            cam1_T_cam0[:3, :3], cam1_T_cam0[:3, 3], new_size=(w1, h1))
        self._maps = undistort_rectify_map(
            K0, np.asarray(d0[:4], np.float64), R1, P1[:3, :3], (w1, h1))
        self._maps_r = undistort_rectify_map(
            K1, np.asarray(dist1[:4], np.float64), R2, P2[:3, :3],
            (w1, h1))

        # shared rectified pinhole replaces the mono-resize intrinsics
        self.calib.camera_model = PinholeCameraModel(
            P1[0, 0], P1[1, 1], P1[0, 2], P1[1, 2])
        # rectification rotates cam0 by R1: x_rect = R1 @ x_cam0, so
        # body_T_cam0rect = body_T_cam0 @ R1^T (GT poses pick this up)
        rect = np.eye(4)
        rect[:3, :3] = R1.T
        self.calib.body_T_cam = body_T_cam0 @ rect
        baseline = float(-P2[0, 3] / P2[0, 0])
        self.baseline = baseline
        self.stereo_rel = np.array([-baseline, 0, 0, 0, 0, 0, 1.0],
                                   np.float32)

        # cam1 image list keyed by timestamp (EuRoC pairs share stamps)
        csv1 = np.genfromtxt(self._mav("cam1", "data.csv"), delimiter=",",
                             dtype=str, skip_header=1)
        t2f = {int(t): name.strip() for t, name in
               zip(csv1[:, 0], csv1[:, 1])}
        self.image_files_r = [
            self._mav("cam1", "data", t2f[int(t)])
            if int(t) in t2f else None for t in self.timestamps]

    def _undistort_maps(self):
        if self._maps is None:
            h1, w1 = self.out_hw
            K = self.K_orig.matrix()
            Knew = self.calib.camera_model.matrix()
            self._maps = undistort_rectify_map(
                K, self.dist.numpy(), None, Knew, (w1, h1))
        return self._maps

    def _gt_pose(self, t_ns: int) -> Optional[np.ndarray]:
        if self.gt is None:
            return None
        i = int(np.argmin(np.abs(self.gt[:, 0] - t_ns)))
        row = self.gt[i]
        world_T_body = np.eye(4)
        world_T_body[:3, 3] = row[1:4]
        world_T_body[:3, :3] = _quat_wxyz_to_mat(row[4:8])
        return world_T_body @ self.calib.body_T_cam

    def imu_between(self, t0_ns: int, t1_ns: int) -> Optional[np.ndarray]:
        """IMU rows (t, wx, wy, wz, ax, ay, az) in (t0, t1]."""
        if getattr(self, "imu_data", None) is None:
            return None
        m = (self.imu_data[:, 0] > t0_ns) & (self.imu_data[:, 0] <= t1_ns)
        return self.imu_data[m]

    def __len__(self):
        return len(self.image_files)

    def __getitem__(self, k: int) -> Dict:
        img = image_io.imread(self.image_files[k], image_io.IMREAD_GRAYSCALE)
        m1, m2 = self._undistort_maps()
        img = remap_bilinear(img, m1, m2)
        img = np.repeat(img[..., None], 3, axis=-1)
        t_ns = int(self.timestamps[k])
        pose = self._gt_pose(t_ns)
        pkt = {
            "k": k,
            "t_cams": t_ns * 1e-9,
            "poses": None if pose is None else pose.astype(np.float32),
            "images": np.ascontiguousarray(img, np.uint8),
            "depths": None,
            "intrinsics": self.calib.camera_model.numpy(),
            "calib": self.calib,
            "is_last_frame": k == len(self) - 1,
        }
        if k > 0:
            # inertial window (t_{k-1}, t_k] for the VIO frontend
            # (NeRF-SLAM's euroc_dataset.py packet's imu_t0_t1)
            pkt["imu_t0_t1"] = self.imu_between(
                int(self.timestamps[k - 1]), t_ns)
        if self.stereo and self.image_files_r[k] is not None:
            img_r = image_io.imread(self.image_files_r[k],
                                    image_io.IMREAD_GRAYSCALE)
            m1r, m2r = self._maps_r
            img_r = remap_bilinear(img_r, m1r, m2r)
            pkt["images_right"] = np.ascontiguousarray(
                np.repeat(img_r[..., None], 3, axis=-1), np.uint8)
            pkt["stereo_rel"] = self.stereo_rel
        return pkt
