"""Pose/color conversion helpers (numpy).

A copy of the JAX package's ``utils/conversions.py`` (NeRF-SLAM's
utils/utils.py:104-187): instant-ngp pose convention shuffles, aabb ->
unit-cube scale/offset, sRGB transforms, and image-error metrics.
"""
from __future__ import annotations

import numpy as np


def nerf_matrix_to_ngp(m: np.ndarray, scale: float = 1.0,
                       offset: float = 0.5) -> np.ndarray:
    """NeRF (OpenGL) c2w -> instant-ngp convention: flip y/z columns,
    scale+offset translation, cycle axes xyz<-yzx (utils.py:104-118)."""
    r = np.array(m, dtype=np.float64, copy=True)
    r[:3, 1] *= -1
    r[:3, 2] *= -1
    r[:3, 3] = r[:3, 3] * scale + offset
    r[[0, 1, 2], :] = r[[1, 2, 0], :]
    return r


def ngp_matrix_to_nerf(m: np.ndarray, scale: float = 1.0,
                       offset: float = 0.5) -> np.ndarray:
    """Exact inverse of nerf_matrix_to_ngp.  (NeRF-SLAM's version,
    utils.py:119-133, overwrites rows in place and is *not* a true
    inverse -- we implement the correct one and test the round trip.)"""
    r = np.array(m, dtype=np.float64, copy=True)
    r[[1, 2, 0], :] = r[[0, 1, 2], :]
    r[:3, 1] *= -1
    r[:3, 2] *= -1
    r[:3, 3] = (r[:3, 3] - offset) / scale
    return r


def opengl_to_opencv_c2w(m: np.ndarray) -> np.ndarray:
    """NeRF/OpenGL camera (x right, y up, z backward) -> OpenCV (x right,
    y down, z forward): flip the y and z camera axes."""
    r = np.array(m, dtype=np.float64, copy=True)
    r[:3, 1] *= -1
    r[:3, 2] *= -1
    return r


def get_scale_and_offset(aabb) -> tuple:
    """aabb [[min],[max]] -> isotropic (scale, offset) into the unit cube
    (utils.py:145-159)."""
    aabb = np.array(aabb, dtype=np.float64)
    d = aabb[1] - aabb[0]
    length = max(1e-6, float(np.abs(d).max()))
    scale = 1.0 / length
    offset = -(aabb[1] + aabb[0]) * 0.5 * scale + 0.5
    return scale, offset


def scale_offset_poses(poses: np.ndarray, scale: float,
                       offset: np.ndarray) -> np.ndarray:
    out = np.array(poses, copy=True)
    out[:, :3, 3] = out[:, :3, 3] * scale + offset
    return out


def srgb_to_linear(img: np.ndarray) -> np.ndarray:
    return np.where(img <= 0.04045, img / 12.92,
                    ((img + 0.055) / 1.055) ** 2.4)


def linear_to_srgb(img: np.ndarray) -> np.ndarray:
    return np.where(img > 0.0031308,
                    1.055 * np.maximum(img, 1e-8) ** (1 / 2.4) - 0.055,
                    12.92 * img)


def mse2psnr(x: float) -> float:
    return float(-10.0 * np.log(max(x, 1e-12)) / np.log(10.0))


def compute_error(img: np.ndarray, ref: np.ndarray) -> float:
    """Mean squared error with non-finite scrubbing (utils.py:168-187)."""
    img = np.array(img, copy=True)
    img[~np.isfinite(img)] = 0
    img = np.maximum(img, 0.0)
    m = (img - ref) ** 2
    m[~np.isfinite(m)] = 0
    return float(np.mean(m))
