"""The tracking hot loop's correlation-pyramid lookups (CUDA + plain).

Five functions, each a hand-written CUDA kernel (``csrc/corr_lookup.cu``)
with its plain PyTorch version beside it:

- :func:`lookup_pyramid_grouped4` -- the update-loop lookup from four
  pooled bf16 slabs (rows padded to 8), ``n_act``-gated.  Replaces
  ``nerf_slam_tpu/ops/corr_pallas.py:lookup_pyramid_grouped4_nhwc``.
- :func:`lookup_pyramid` -- the motion-filter lookup from four unpadded
  levels.  Replaces ``corr_pallas.py:lookup_pyramid_pallas_nhwc``.
- :func:`lookup_level` (and its channel-major form
  :func:`lookup_level_cm`) -- one stored level, coords in level units.
  Replaces ``corr_pallas.py:lookup_level_pallas_nhwc``.
- :func:`lookup_level_grouped` -- the same function for the tracker's
  ``corr_impl="pallas_grouped"``.  Replaces
  ``corr_pallas.py:lookup_level_pallas_grouped_nhwc``.
- :func:`lookup_pyramid_l0` -- four levels from the level-0 slab alone
  (``corr_impl="pallas"``).  Replaces
  ``corr_pallas.py:lookup_pyramid_l0_nhwc``.

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

launches = {"corr_lookup_grouped4": 0, "corr_lookup_pyramid": 0,
            "corr_lookup_level": 0, "corr_lookup_level_grouped": 0,
            "corr_lookup_l0": 0}

# how lookup_pyramid_l0's kernel reaches a pixel's plane
L0_BULK, L0_COOP, L0_DIRECT = 0, 1, 2
# csrc/corr_lookup.cu: kL0Warps, kL0Stages, kL0Fixed, kL0SmemMax
L0_WARPS, L0_STAGES, L0_FIXED, L0_SMEM_MAX = 4, 2, 4480, 232448 - 1024


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


def _combine(t: torch.Tensor, dx: torch.Tensor, dy: torch.Tensor,
             scale: float = 1.0) -> torch.Tensor:
    """Bilinear recombination of the fp32 support t[row, col] (..., 8, 8)
    into the 49 window channels, a*7 + b: w00*S00 + w10*S10 + w01*S01 +
    w11*S11 in that order, fp32 weights (scaled by ``scale``)."""
    dx, dy = dx[..., None, None], dy[..., None, None]
    t0, t1 = t[..., :RD, :], t[..., 1:, :]                   # rows b, b+1
    w00 = scale * (1 - dx) * (1 - dy)
    w10 = scale * dx * (1 - dy)
    w01 = scale * (1 - dx) * dy
    w11 = scale * dx * dy
    o = (w00 * t0[..., :RD] + w10 * t0[..., 1:]
         + w01 * t1[..., :RD] + w11 * t1[..., 1:])          # [b, a]
    return o.transpose(-1, -2).reshape(*o.shape[:-2], RD * RD)


def lookup_level_plain(vol: torch.Tensor,
                       coords: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`lookup_level`: exact bf16 taps of one level
    (bounds = the slab as given), fp32 bilinear weights."""
    hs, ws = vol.shape[-2:]
    xl, yl = coords[..., 0].float(), coords[..., 1].float()
    fx, fy = torch.floor(xl), torch.floor(yl)
    t = _taps(vol, _start(fy, -8.0, hs + 8.0).long(),
              _start(fx, -8.0, ws + 8.0).long(), hs, ws)
    return _combine(t, xl - fx, yl - fy)


def lookup_level_grouped_plain(vol: torch.Tensor,
                               coords: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`lookup_level_grouped`.  The grouped TPU
    kernel samples the same taps with the same weights in the same term
    order as the per-pixel one (its 16-pixel grouping and y-major store
    only shape the work for the MXU), so this is :func:`lookup_level_plain`
    on the slab as given, padding rows included."""
    return lookup_level_plain(vol, coords)


def lookup_pyramid_plain(levels: Sequence[torch.Tensor],
                         coords: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`lookup_pyramid`."""
    c = coords.float()
    return torch.cat([lookup_level_plain(vol, c * (1.0 / (2 ** lvl)))
                      for lvl, vol in enumerate(levels)], dim=-1)


def lookup_pyramid_l0_plain(vol0: torch.Tensor, coords: torch.Tensor,
                            dims) -> torch.Tensor:
    """Plain version of :func:`lookup_pyramid_l0`, in the kernel's order:
    per level l the 2^l level-0 rows of a block are summed in fp32 (row
    after row) and rounded to bf16, the block's 2^l columns are summed in
    fp32 (column after column), and the support is sampled from those
    block sums with 4^-l folded into the fp32 weights.  Block rows and
    columns at or beyond ``dims[l]`` are never formed, so cropped and
    padded level-0 rows stay out."""
    E, H1, W1, H2p, W2 = vol0.shape
    x0, y0 = coords[..., 0].float(), coords[..., 1].float()
    v = vol0.float()
    outs = []
    for lvl, (hl, wl) in enumerate(dims):
        n = 2 ** lvl
        hl, wl = min(hl, H2p // n), min(wl, W2 // n)
        blk = v[..., :hl * n, :wl * n].reshape(E, H1, W1, hl, n, wl, n)
        rows = blk[..., 0, :, :]
        for k in range(1, n):
            rows = rows + blk[..., k, :, :]
        rows = rows.to(torch.bfloat16).float()               # (.., hl, wl, n)
        sums = rows[..., 0]
        for k in range(1, n):
            sums = sums + rows[..., k]                       # (.., hl, wl)
        inv = 1.0 / n
        xl, yl = x0 * inv, y0 * inv
        fx, fy = torch.floor(xl), torch.floor(yl)
        t = _taps(sums, _start(fy, -8.0, dims[lvl][0] + 8.0).long(),
                  _start(fx, -8.0, dims[lvl][1] + 8.0).long(), hl, wl)
        outs.append(_combine(t, xl - fx, yl - fy, inv * inv))
    return torch.cat(outs, dim=-1)


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

_VOID, _INT = ctypes.c_void_p, ctypes.c_int
# without argtypes ctypes would pass each pointer as a 32-bit int
_ARGTYPES = {
    "corr_lookup_launch": ([_VOID] * 4 + [ctypes.POINTER(_INT), _INT]
                           + [_VOID] * 2 + [_INT] * 3 + [_VOID]),
    "corr_lookup_grouped4_launch": ([_VOID] * 4 + [ctypes.POINTER(_INT), _INT]
                                    + [_VOID] * 3 + [_INT] * 4 + [_VOID]),
    "corr_lookup_level_launch": [_VOID] * 3 + [_INT] * 5 + [_VOID],
    "corr_lookup_l0_launch": ([_VOID, ctypes.POINTER(_INT), _VOID, _VOID]
                              + [_INT] * 7 + [_VOID]),
}


def _lib(entry: str = "corr_lookup_launch"):
    fn = getattr(build.load("corr_lookup"), entry)
    fn.argtypes = _ARGTYPES[entry]
    fn.restype = _INT
    return fn


def _check_inputs(levels, coords: torch.Tensor, n_levels: int = 4):
    if len(levels) != n_levels:
        raise ValueError(f"expected {n_levels} pyramid level(s), got "
                         f"{len(levels)}")
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


def load_width(addr: int, numel: int) -> int:
    """Bytes per load that the grouped4 kernel may use on one level: 4
    (aligned words of two taps) where the level's base address is 4-byte
    aligned and its element count even, so that the word around any
    in-bounds tap lies inside the tensor whatever the row pitch; else 2."""
    return 4 if addr % 4 == 0 and numel % 2 == 0 else 2


def l0_plan(addr: int, h2p: int, w2: int) -> Tuple[int, bool]:
    """How the level-0 kernel reaches a slab at ``addr`` with (h2p, w2)
    planes: (mode, pair).  ``L0_BULK``: planes are 16-byte aligned runs, so
    the copy engine stages them; ``L0_COOP``: staged by the warp with 2-byte
    loads; ``L0_DIRECT``: a plane does not fit the shared memory and is
    summed from device memory.  ``pair``: an even width keeps column pairs
    4-byte aligned, so two taps come with one load."""
    plane_bytes = h2p * w2 * 2
    stage = (plane_bytes + 15) // 16 * 16

    def fits(n_stages):
        return L0_WARPS * n_stages * stage + L0_FIXED <= L0_SMEM_MAX

    if addr % 16 == 0 and plane_bytes % 16 == 0 and fits(L0_STAGES):
        mode = L0_BULK
    elif fits(1):
        mode = L0_COOP
    else:
        mode = L0_DIRECT
    pair = w2 % 2 == 0 and (mode != L0_DIRECT or addr % 4 == 0)
    return mode, pair


def _vec_mask(levels) -> int:
    """Bit l set: the grouped4 kernel may read level l as 4-byte words."""
    return sum((load_width(v.data_ptr(), v.numel()) == 4) << lvl
               for lvl, v in enumerate(levels))


def _level_dims(levels, real_dims):
    dims = ([v.shape[-2] for v in levels] + [v.shape[-1] for v in levels]
            + [d[0] for d in real_dims] + [d[1] for d in real_dims])
    return (ctypes.c_int * 16)(*dims)


def _stream(coords: torch.Tensor) -> int:
    """The current stream of the coords' device.  Each launch runs with
    that device current (``torch.cuda.device``): the kernels launch on the
    current device, and a shard's tensors may lie on another."""
    return torch.cuda.current_stream(coords.device).cuda_stream


def _raise_on(err: int) -> None:
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
    with torch.cuda.device(coords.device):
        _raise_on(_lib("corr_lookup_grouped4_launch")(
            *[v.data_ptr() for v in levels], _level_dims(levels, dims),
            _vec_mask(levels), coords.data_ptr(),
            None if n_act is None else n_act.data_ptr(), out.data_ptr(), E,
            H1, W1, int(n_act is None), _stream(coords)))
    launches["corr_lookup_grouped4"] += 1
    return out


def lookup_pyramid(levels: Sequence[torch.Tensor],
                   coords: torch.Tensor) -> torch.Tensor:
    """4-level lookup from unpadded bf16 levels (E, H1, W1, H_l, W_l):
    exact taps, fp32 bilinear weights.  Returns (E, H1, W1, 196) fp32.
    Runs on the grouped4 kernel's exact mode (word loads as
    :func:`load_width` allows)."""
    if coords.device.type == "cpu":
        return lookup_pyramid_plain(levels, coords)
    _check_inputs(levels, coords)
    E, H1, W1 = coords.shape[:3]
    out = torch.empty((E, H1, W1, CHANNELS), device=coords.device,
                      dtype=torch.float32)
    with torch.cuda.device(coords.device):
        _raise_on(_lib()(
            *[v.data_ptr() for v in levels],
            _level_dims(levels, [tuple(v.shape[-2:]) for v in levels]),
            _vec_mask(levels), coords.data_ptr(), out.data_ptr(), E, H1, W1,
            _stream(coords)))
    launches["corr_lookup_pyramid"] += 1
    return out


def _launch_level(vol: torch.Tensor, coords: torch.Tensor,
                  counter: str) -> torch.Tensor:
    """One stored level through the single-level kernel, counted under
    ``counter``; an empty level has no taps and launches nothing."""
    _check_inputs([vol], coords, n_levels=1)
    E, H1, W1, H2, W2 = vol.shape
    if H2 == 0 or W2 == 0:
        return torch.zeros((E, H1, W1, RD * RD), device=coords.device,
                           dtype=torch.float32)
    out = torch.empty((E, H1, W1, RD * RD), device=coords.device,
                      dtype=torch.float32)
    with torch.cuda.device(coords.device):
        _raise_on(_lib("corr_lookup_level_launch")(
            vol.data_ptr(), coords.data_ptr(), out.data_ptr(), E, H1, W1, H2,
            W2, _stream(coords)))
    launches[counter] += 1
    return out


def lookup_level(vol: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Windowed lookup from ONE bf16 level (E, H1, W1, H2, W2) with coords
    (E, H1, W1, 2) in LEVEL units: exact taps, fp32 bilinear weights.
    Returns (E, H1, W1, 49) fp32, channels x-offset major; zeros for an
    empty level."""
    if coords.device.type == "cpu":
        return lookup_level_plain(vol, coords)
    return _launch_level(vol, coords, "corr_lookup_level")


def lookup_level_cm(vol: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """:func:`lookup_level`, channel-major: (E, 49, H1, W1)."""
    return lookup_level(vol, coords).permute(0, 3, 1, 2)


def lookup_level_grouped(vol: torch.Tensor,
                         coords: torch.Tensor) -> torch.Tensor:
    """The tracker's per-level lookup under ``corr_impl="pallas_grouped"``:
    :func:`lookup_level`'s function on a row-padded slab, whose padding
    rows are read as they are (zeros) because no real dims are given.
    Returns (E, H1, W1, 49) fp32."""
    if coords.device.type == "cpu":
        return lookup_level_grouped_plain(vol, coords)
    return _launch_level(vol, coords, "corr_lookup_level_grouped")


def lookup_pyramid_l0(vol0: torch.Tensor, coords: torch.Tensor,
                      dims: Tuple[Tuple[int, int], ...]) -> torch.Tensor:
    """4-level lookup from the level-0 slab alone: a level-l tap is the
    sum of its 2^l x 2^l level-0 block (row sums rounded to bf16, as the
    TPU kernel rounds them), 4^-l folded into the fp32 weights.

    vol0: (E, H1, W1, H2p, W2) bf16 (rows may be padded); coords: (E, H1,
    W1, 2) level-0 [x, y] fp32; dims: the four real (floor-halved) level
    dims, dims[l] * 2^l within the slab.  Returns (E, H1, W1, 196) fp32.
    """
    if coords.device.type == "cpu":
        return lookup_pyramid_l0_plain(vol0, coords, dims)
    _check_inputs([vol0], coords, n_levels=1)
    E, H1, W1, H2p, W2 = vol0.shape
    if len(dims) != 4 or any(hl * 2 ** l > H2p or wl * 2 ** l > W2
                             or hl < 0 or wl < 0
                             for l, (hl, wl) in enumerate(dims)):
        raise ValueError(f"dims {tuple(dims)} do not fit a level-0 slab of "
                         f"{(H2p, W2)}")
    out = torch.empty((E, H1, W1, CHANNELS), device=coords.device,
                      dtype=torch.float32)
    arr = (ctypes.c_int * 8)(*[d[0] for d in dims], *[d[1] for d in dims])
    mode, pair = l0_plan(vol0.data_ptr(), H2p, W2)
    with torch.cuda.device(coords.device):
        _raise_on(_lib("corr_lookup_l0_launch")(
            vol0.data_ptr(), arr, coords.data_ptr(), out.data_ptr(), E, H1,
            W1, H2p, W2, mode, int(pair), _stream(coords)))
    launches["corr_lookup_l0"] += 1
    return out
