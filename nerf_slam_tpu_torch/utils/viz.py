"""Visualization utilities (pure numpy, headless).

A copy of the JAX package's ``utils/viz.py`` (NeRF-SLAM's
utils/flow_viz.py): optical-flow colorization (Baker et al. color wheel),
depth / sigma heatmaps.  All functions return uint8 RGB arrays; callers
decide whether to write PNGs (no cv2 windows: the hosts are headless).
"""
from __future__ import annotations

import numpy as np


def make_colorwheel() -> np.ndarray:
    """55-color flow wheel (flow_viz.py:22-147 standard construction)."""
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    ncols = RY + YG + GC + CB + BM + MR
    wheel = np.zeros((ncols, 3))
    col = 0
    wheel[:RY, 0] = 255
    wheel[:RY, 1] = np.floor(255 * np.arange(RY) / RY)
    col += RY
    wheel[col:col + YG, 0] = 255 - np.floor(255 * np.arange(YG) / YG)
    wheel[col:col + YG, 1] = 255
    col += YG
    wheel[col:col + GC, 1] = 255
    wheel[col:col + GC, 2] = np.floor(255 * np.arange(GC) / GC)
    col += GC
    wheel[col:col + CB, 1] = 255 - np.floor(255 * np.arange(CB) / CB)
    wheel[col:col + CB, 2] = 255
    col += CB
    wheel[col:col + BM, 2] = 255
    wheel[col:col + BM, 0] = np.floor(255 * np.arange(BM) / BM)
    col += BM
    wheel[col:col + MR, 2] = 255 - np.floor(255 * np.arange(MR) / MR)
    wheel[col:col + MR, 0] = 255
    return wheel


_WHEEL = make_colorwheel()


def flow_to_rgb(flow: np.ndarray, flow_norm: float = None) -> np.ndarray:
    """(H, W, 2) flow -> (H, W, 3) uint8 colorization."""
    u = np.asarray(flow[..., 0], np.float64)
    v = np.asarray(flow[..., 1], np.float64)
    rad = np.sqrt(u * u + v * v)
    if flow_norm is None:
        flow_norm = max(rad.max(), 1e-6)
    u, v, rad = u / flow_norm, v / flow_norm, rad / flow_norm
    a = np.arctan2(-v, -u) / np.pi
    ncols = _WHEEL.shape[0]
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(int) % ncols
    k1 = (k0 + 1) % ncols
    f = fk - np.floor(fk)
    img = np.zeros(u.shape + (3,), np.uint8)
    for c in range(3):
        col0 = _WHEEL[k0, c] / 255.0
        col1 = _WHEEL[k1, c] / 255.0
        col = (1 - f) * col0 + f * col1
        col = np.where(rad <= 1, 1 - rad * (1 - col), col * 0.75)
        img[..., c] = np.floor(255 * col)
    return img


def colormap(values: np.ndarray, vmin=None, vmax=None,
             cmap: str = "turbo") -> np.ndarray:
    """(H, W) scalar field -> (H, W, 3) uint8 heatmap (no matplotlib)."""
    x = np.asarray(values, np.float64)
    vmin = np.nanmin(x) if vmin is None else vmin
    vmax = np.nanmax(x) if vmax is None else vmax
    t = np.clip((x - vmin) / max(vmax - vmin, 1e-12), 0, 1)
    if cmap == "turbo":
        # compact turbo polynomial fit (Google, public domain)
        r = np.clip(34.61 + t * (1172.33 + t * (-10793.56 + t * (
            33300.12 + t * (-38394.49 + t * 14825.05)))), 0, 255)
        g = np.clip(23.31 + t * (557.33 + t * (1225.33 + t * (
            -3574.96 + t * (1073.77 + t * 707.56)))), 0, 255)
        b = np.clip(27.2 + t * (3211.1 + t * (-15327.97 + t * (
            27814.0 + t * (-22569.18 + t * 6838.66)))), 0, 255)
    else:  # gray
        r = g = b = 255 * t
    return np.stack([r, g, b], -1).astype(np.uint8)


def depth_to_rgb(depth: np.ndarray, max_depth: float = None) -> np.ndarray:
    d = np.asarray(depth, np.float64)
    return colormap(d, 0.0, max_depth or np.nanpercentile(d, 98))


def sigma_to_rgb(cov: np.ndarray, sigma_max: float = None) -> np.ndarray:
    """Depth-sigma heatmap (viz_depth_sigma equivalent)."""
    s = np.sqrt(np.maximum(np.asarray(cov, np.float64), 0))
    return colormap(s, 0.0, sigma_max or np.nanpercentile(s, 98))


def pose_cov_ellipsoid(cov6: np.ndarray, nstd: float = 3.0):
    """Translation-block covariance -> ellipsoid (radii, axes) for
    rendering pose uncertainty (gui/open3d_gui.py:590-616 equivalent,
    geometry only).  cov6 is 6x6 in [w, v] order."""
    P = np.asarray(cov6)[3:, 3:]
    vals, vecs = np.linalg.eigh(P)
    radii = nstd * np.sqrt(np.maximum(vals, 0))
    return radii, vecs
