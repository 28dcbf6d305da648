"""The tracking hot loop's correlation-pyramid lookups (CUDA + plain).

Two functions, each a hand-written CUDA kernel (``csrc/corr_lookup.cu``)
with its plain PyTorch version beside it:

- :func:`lookup_pyramid_grouped4` -- the update-loop lookup from four
  pooled bf16 slabs (rows padded to 8), ``n_act``-gated.  Replaces
  ``nerf_slam_tpu/ops/corr_pallas.py:lookup_pyramid_grouped4_nhwc``.
- :func:`lookup_pyramid` -- the motion-filter lookup from four unpadded
  levels.  Replaces ``corr_pallas.py:lookup_pyramid_pallas_nhwc``.

A wrapper runs the plain version only for tensors on the CPU (the tests);
for CUDA tensors it launches its kernel or raises.  ``launches`` counts
kernel launches per wrapper; nothing else touches it.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from . import build

RD = 7            # window taps per axis (radius 3)
NSUP = 8          # support taps per axis
CHANNELS = 4 * RD * RD

launches = {"corr_lookup_grouped4": 0, "corr_lookup_pyramid": 0}

_MODE_HAT_BF16, _MODE_HAT_F32, _MODE_EXACT_F32 = 0, 1, 2


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def pyramid_dims(h: int, w: int, num_levels: int = 4):
    """Real (floor-cropped) level dims for an (h, w) level-0 volume."""
    dims = []
    for _ in range(num_levels):
        dims.append((h, w))
        h, w = h // 2, w // 2
    return tuple(dims)


# ---------------------------------------------------------------------------
# plain versions (the kernels' arithmetic, op by op)
# ---------------------------------------------------------------------------

def _taps(vol: torch.Tensor, yi: torch.Tensor, xi: torch.Tensor,
          h_ok: int, w_ok: int) -> torch.Tensor:
    """The 8x8 support [row, col] from rows yi.. and cols xi.. of each
    pixel's (H2, W2) plane, fp32, 0 outside [0, h_ok) x [0, w_ok)."""
    E, H1, W1, H2, W2 = vol.shape
    if H2 == 0 or W2 == 0:       # an empty level (tiny images): no taps
        return torch.zeros((E, H1, W1, NSUP, NSUP), device=vol.device)
    offs = torch.arange(NSUP, device=vol.device)
    rows = yi[..., None] + offs
    cols = xi[..., None] + offs
    ok = (((rows >= 0) & (rows < h_ok))[..., :, None]
          & ((cols >= 0) & (cols < w_ok))[..., None, :])
    idx = (rows.clamp(0, H2 - 1)[..., :, None] * W2
           + cols.clamp(0, W2 - 1)[..., None, :])
    t = torch.gather(vol.reshape(E, H1, W1, H2 * W2), -1,
                     idx.reshape(E, H1, W1, NSUP * NSUP))
    return t.float().reshape(E, H1, W1, NSUP, NSUP) * ok


def _start(f: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """Window start floor(x) - 3, clipped; NaN maps to the low bound, as
    the kernels' fmaxf does (its window is out of bounds either way)."""
    return torch.nan_to_num(f - 3.0, nan=lo).clamp(lo, hi)


def lookup_pyramid_grouped4_plain(levels: Sequence[torch.Tensor],
                                  coords: torch.Tensor, dims,
                                  n_act: Optional[torch.Tensor] = None
                                  ) -> torch.Tensor:
    """Plain version of :func:`lookup_pyramid_grouped4`."""
    E, H1, W1 = coords.shape[:3]
    x0, y0 = coords[..., 0].float(), coords[..., 1].float()
    outs = []
    for lvl, (vol, (hl, wl)) in enumerate(zip(levels, dims)):
        hs, ws = vol.shape[-2:]
        inv = 1.0 / (2 ** lvl)
        xl, yl = x0 * inv, y0 * inv
        fx, fy = torch.floor(xl), torch.floor(yl)
        dx, dy = xl - fx, yl - fy
        xi = _start(fx, -8.0, wl + 8.0)
        yi = _start(fy, -8.0, hl + 8.0)
        # a NaN coord leaves dx or dy NaN: its star moves far out and
        # every hat weight is 0 (the TPU kernel's nan_to_num)
        xs = torch.nan_to_num(xi + dx, nan=-1e4)
        ys = torch.nan_to_num(yi + dy, nan=-1e4)

        def hat(base, star):
            w = torch.clamp(1.0 - torch.abs(base - star), min=0.0)
            return w.to(torch.bfloat16).float()[..., None, None]

        wy0, wy1 = hat(yi, ys), hat(yi + 1.0, ys)
        wx0, wx1 = hat(xi, xs), hat(xi + 1.0, xs)
        t = _taps(vol, yi.long(), xi.long(), min(hl, hs),
                  min(wl, ws))                               # [row, col]
        r = (wy0 * t[..., :RD, :] + wy1 * t[..., 1:, :]) \
            .to(torch.bfloat16).float()                      # [b, col]
        o = wx0 * r[..., :, :RD] + wx1 * r[..., :, 1:]      # [b, a]
        outs.append(o.transpose(-1, -2).reshape(E, H1, W1, RD * RD))
    out = torch.cat(outs, dim=-1)
    if n_act is None:
        return out
    out = out.to(torch.bfloat16)
    out[int(n_act.reshape(-1)[0]):] = 0
    return out


def lookup_pyramid_plain(levels: Sequence[torch.Tensor],
                         coords: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`lookup_pyramid`."""
    E, H1, W1 = coords.shape[:3]
    x0, y0 = coords[..., 0].float(), coords[..., 1].float()
    outs = []
    for lvl, vol in enumerate(levels):
        hs, ws = vol.shape[-2:]
        inv = 1.0 / (2 ** lvl)
        xl, yl = x0 * inv, y0 * inv
        fx, fy = torch.floor(xl), torch.floor(yl)
        dx, dy = (xl - fx)[..., None], (yl - fy)[..., None]
        t = _taps(vol, _start(fy, -8.0, hs + 8.0).long(),
                  _start(fx, -8.0, ws + 8.0).long(), hs, ws)
        t0, t1 = t[..., :RD, :], t[..., 1:, :]               # rows b, b+1
        w00 = ((1 - dx) * (1 - dy))[..., None]
        w10 = (dx * (1 - dy))[..., None]
        w01 = ((1 - dx) * dy)[..., None]
        w11 = (dx * dy)[..., None]
        o = (w00 * t0[..., :RD] + w10 * t0[..., 1:]
             + w01 * t1[..., :RD] + w11 * t1[..., 1:])      # [b, a]
        outs.append(o.transpose(-1, -2).reshape(E, H1, W1, RD * RD))
    return torch.cat(outs, dim=-1)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

def _lib():
    fn = build.load("corr_lookup").corr_lookup_launch
    # without argtypes ctypes would pass each pointer as a 32-bit int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_int)]
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check_inputs(levels, coords: torch.Tensor):
    if len(levels) != 4:
        raise ValueError(f"expected 4 pyramid levels, got {len(levels)}")
    if coords.dtype != torch.float32 or coords.dim() != 4 \
            or coords.shape[-1] != 2 or not coords.is_contiguous():
        raise ValueError("coords must be contiguous float32 (E, H1, W1, 2)")
    E, H1, W1 = coords.shape[:3]
    for v in levels:
        if v.device != coords.device:
            raise ValueError("levels and coords must share a device")
        if v.dtype != torch.bfloat16 or not v.is_contiguous():
            raise ValueError("levels must be contiguous bfloat16")
        if v.dim() != 5 or tuple(v.shape[:3]) != (E, H1, W1):
            raise ValueError(f"level shape {tuple(v.shape)} does not match "
                             f"coords {(E, H1, W1)}")


def _launch(levels, coords, n_act, out, real_dims, mode):
    E, H1, W1 = coords.shape[:3]
    dims = ([v.shape[-2] for v in levels] + [v.shape[-1] for v in levels]
            + [d[0] for d in real_dims] + [d[1] for d in real_dims])
    arr = (ctypes.c_int * 16)(*dims)
    stream = torch.cuda.current_stream(coords.device).cuda_stream
    err = _lib()(*[v.data_ptr() for v in levels], arr, coords.data_ptr(),
                 None if n_act is None else n_act.data_ptr(),
                 out.data_ptr(), E, H1, W1, mode, stream)
    if err != 0:
        raise RuntimeError(f"corr_lookup kernel launch failed: CUDA error "
                           f"{err}")


def lookup_pyramid_grouped4(levels: Sequence[torch.Tensor],
                            coords: torch.Tensor,
                            dims: Tuple[Tuple[int, int], ...],
                            n_act: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """4-level lookup from pooled bf16 slabs, hat-rounded like the TPU
    kernel it replaces.

    levels: 4 x (E, H1, W1, H2p_l, W2_l) bf16 (rows may be padded);
    coords: (E, H1, W1, 2) level-0 [x, y] fp32; dims: real level dims.
    ``n_act``: optional int32 device tensor holding the number of active
    edge slots (a prefix); slots >= n_act are zero and the output is bf16,
    else fp32.  Returns (E, H1, W1, 196).
    """
    if coords.device.type == "cpu":
        return lookup_pyramid_grouped4_plain(levels, coords, dims, n_act)
    _check_inputs(levels, coords)
    if n_act is not None and (n_act.dtype != torch.int32
                              or n_act.device != coords.device
                              or n_act.numel() != 1):
        raise ValueError("n_act must be a one-element int32 tensor on the "
                         "coords' device")
    E, H1, W1 = coords.shape[:3]
    out = torch.empty((E, H1, W1, CHANNELS), device=coords.device,
                      dtype=torch.float32 if n_act is None
                      else torch.bfloat16)
    _launch(levels, coords, n_act, out, dims,
            _MODE_HAT_F32 if n_act is None else _MODE_HAT_BF16)
    launches["corr_lookup_grouped4"] += 1
    return out


def lookup_pyramid(levels: Sequence[torch.Tensor],
                   coords: torch.Tensor) -> torch.Tensor:
    """4-level lookup from unpadded bf16 levels (E, H1, W1, H_l, W_l):
    exact taps, fp32 bilinear weights.  Returns (E, H1, W1, 196) fp32."""
    if coords.device.type == "cpu":
        return lookup_pyramid_plain(levels, coords)
    _check_inputs(levels, coords)
    E, H1, W1 = coords.shape[:3]
    out = torch.empty((E, H1, W1, CHANNELS), device=coords.device,
                      dtype=torch.float32)
    _launch(levels, coords, None, out, [tuple(v.shape[-2:]) for v in levels],
            _MODE_EXACT_F32)
    launches["corr_lookup_pyramid"] += 1
    return out
