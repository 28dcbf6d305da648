"""ctypes bindings for the native frame-preprocessing library.

``frameops.cpp`` (a copy of the JAX package's) is compiled by ``g++ -O3
-fopenmp`` at first use into ``nerf_slam_tpu_torch/_build/`` under a name
that carries a hash of the source and flags, as ``ops/build.py`` builds
the CUDA kernels.  A failed build raises: nothing switches to another
implementation behind the caller's back.  Each entry point has a plain
numpy version (``*_plain``) that computes the same float32 arithmetic in
the same order; the tests hold the library to it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "frameops.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
FLAGS = ["-O3", "-fopenmp", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)


def _target() -> Path:
    h = hashlib.sha1(SRC.read_bytes() + " ".join(FLAGS).encode())
    return BUILD_DIR / f"libframeops_{h.hexdigest()[:12]}.so"


def _build() -> Path:
    target = _target()
    if target.exists():
        return target
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native frame library is "
                           "built with g++ at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    out = subprocess.run([gxx, *FLAGS, str(SRC), "-o", str(tmp)],
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        raise RuntimeError(f"g++ failed for {SRC.name}:\n{out.stderr}")
    os.replace(tmp, target)
    return target


def get_lib() -> ctypes.CDLL:
    """The library's ctypes handle, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            _declare(lib)
            _lib = lib
    return _lib


def _declare(lib):
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u16p = ctypes.POINTER(ctypes.c_uint16)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.resize_bilinear_u8.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, u8p,
        ctypes.c_int, ctypes.c_int]
    lib.normalize_image_u8.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int, f32p, f32p, f32p]
    lib.srgb_u8_to_linear_f32.argtypes = [u8p, ctypes.c_int64, f32p]
    lib.depth_u16_to_f32.argtypes = [u16p, ctypes.c_int64,
                                     ctypes.c_float, f32p]
    lib.resize_nearest_f32.argtypes = [
        f32p, ctypes.c_int, ctypes.c_int, f32p, ctypes.c_int,
        ctypes.c_int]
    for fn in (lib.resize_bilinear_u8, lib.normalize_image_u8,
               lib.srgb_u8_to_linear_f32, lib.depth_u16_to_f32,
               lib.resize_nearest_f32):
        fn.restype = None


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def resize_bilinear_u8(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Bilinear resize of a uint8 (H, W, C) image to (h, w, C)."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    H, W, C = img.shape
    out = np.empty((h, w, C), np.uint8)
    get_lib().resize_bilinear_u8(_ptr(img, ctypes.c_uint8), H, W, C,
                                 _ptr(out, ctypes.c_uint8), h, w)
    return out


def normalize_image_u8(img: np.ndarray, mean=_MEAN,
                       stdv=_STD) -> np.ndarray:
    """uint8 HWC -> float32 ``(x / 255 - mean) / std`` (DROID's input
    normalization)."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    H, W, C = img.shape
    mean = np.ascontiguousarray(mean, np.float32)
    stdv = np.ascontiguousarray(stdv, np.float32)
    if mean.shape != (C,) or stdv.shape != (C,):
        raise ValueError(f"mean {mean.shape} and std {stdv.shape} must have "
                         f"one value per channel ({C})")
    out = np.empty((H, W, C), np.float32)
    get_lib().normalize_image_u8(_ptr(img, ctypes.c_uint8), H * W, C,
                                 _ptr(mean, ctypes.c_float),
                                 _ptr(stdv, ctypes.c_float),
                                 _ptr(out, ctypes.c_float))
    return out


def srgb_u8_to_linear(img: np.ndarray) -> np.ndarray:
    """uint8 sRGB -> float32 linear."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    out = np.empty(img.shape, np.float32)
    get_lib().srgb_u8_to_linear_f32(_ptr(img, ctypes.c_uint8), img.size,
                                    _ptr(out, ctypes.c_float))
    return out


def depth_u16_to_f32(depth: np.ndarray, scale: float) -> np.ndarray:
    """uint16 depth -> float32 ``depth * scale`` (0 stays 0)."""
    depth = np.ascontiguousarray(depth, dtype=np.uint16)
    out = np.empty(depth.shape, np.float32)
    get_lib().depth_u16_to_f32(_ptr(depth, ctypes.c_uint16), depth.size,
                               ctypes.c_float(scale),
                               _ptr(out, ctypes.c_float))
    return out


def resize_nearest_f32(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Nearest-neighbour resize of a float32 (H, W) map."""
    img = np.ascontiguousarray(img, dtype=np.float32)
    H, W = img.shape
    out = np.empty((h, w), np.float32)
    get_lib().resize_nearest_f32(_ptr(img, ctypes.c_float), H, W,
                                 _ptr(out, ctypes.c_float), h, w)
    return out


# ----------------------------------------------------------------------
# plain numpy versions: the library's float32 arithmetic, op for op
# ----------------------------------------------------------------------
_F = np.float32


def _bilinear_taps(n_src: int, n_dst: int):
    s = _F(n_src) / _F(n_dst)
    f = (np.arange(n_dst, dtype=_F) + _F(0.5)) * s - _F(0.5)
    i0 = np.clip(np.floor(f).astype(np.int64), 0, n_src - 1)
    return i0, np.minimum(i0 + 1, n_src - 1), f - np.floor(f)


def resize_bilinear_u8_plain(img: np.ndarray, h: int, w: int) -> np.ndarray:
    img = np.asarray(img, np.uint8)
    H, W, _ = img.shape
    y0, y1, wy = _bilinear_taps(H, h)
    x0, x1, wx = _bilinear_taps(W, w)
    wy, wx = wy[:, None, None], wx[None, :, None]
    src = img.astype(_F)
    top = (_F(1) - wx) * src[y0][:, x0] + wx * src[y0][:, x1]
    bot = (_F(1) - wx) * src[y1][:, x0] + wx * src[y1][:, x1]
    v = (_F(1) - wy) * top + wy * bot
    return (v + _F(0.5)).astype(np.uint8)


def normalize_image_u8_plain(img: np.ndarray, mean=_MEAN,
                             stdv=_STD) -> np.ndarray:
    x = np.asarray(img, np.uint8).astype(_F) / _F(255.0)
    return (x - np.asarray(mean, _F)) / np.asarray(stdv, _F)


def srgb_u8_to_linear_plain(img: np.ndarray) -> np.ndarray:
    x = np.arange(256, dtype=_F) / _F(255.0)
    lut = np.where(x <= _F(0.04045), x / _F(12.92),
                   ((x + _F(0.055)) / _F(1.055)) ** _F(2.4)).astype(_F)
    return lut[np.asarray(img, np.uint8)]


def depth_u16_to_f32_plain(depth: np.ndarray, scale: float) -> np.ndarray:
    return np.asarray(depth, np.uint16).astype(_F) * _F(scale)


def resize_nearest_f32_plain(img: np.ndarray, h: int, w: int) -> np.ndarray:
    img = np.asarray(img, _F)
    H, W = img.shape
    ys = np.minimum((np.arange(h, dtype=_F) * (_F(H) / _F(h))).astype(
        np.int64), H - 1)
    xs = np.minimum((np.arange(w, dtype=_F) * (_F(W) / _F(w))).astype(
        np.int64), W - 1)
    return img[ys][:, xs]
