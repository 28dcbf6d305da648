"""All-pairs correlation volumes and the reference windowed lookup.

Layout (the pretrained corr-encoder conv depends on it):
  - an edge's volume is (H1, W1, H2, W2) = <fmap1[y, x], fmap2[v, u]> / 16;
  - a lookup samples the (2r+1)^2 window around each pixel's flow coords
    with the x offset major: channel c = a*(2r+1) + b samples
    (x0 - r + a, y0 - r + b); out-of-bounds taps contribute zero;
  - 4 pyramid levels at coords / 2^l, concatenated level-major: 196
    channels.

The lookup kernels of the tracking hot loop live in ``corr_lookup``;
:func:`lookup_level` is the plain reference they are tested against.
:class:`CorrPyramidPallas` is the pyramid that looks up through those
kernels, :class:`CorrPyramid` the one that uses the reference (or, with
``onehot=True``, :func:`lookup_level_onehot`, the training lookup), and
:func:`alt_corr_level` correlates on the fly without a volume (global BA).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import corr_lookup


def build_volume(fmap1: torch.Tensor, fmap2: torch.Tensor) -> torch.Tensor:
    """(E, C, H, W) feature maps -> (E, H, W, H, W) fp32 volume / 16."""
    E, C, H, W = fmap1.shape
    f1 = fmap1.reshape(E, C, H * W).float() / 4.0
    f2 = fmap2.reshape(E, C, H * W).float() / 4.0
    return torch.matmul(f1.transpose(1, 2), f2).reshape(E, H, W, H, W)


def avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 average pool with floor semantics on the last two dims,
    accumulated in fp32 and returned in the input dtype."""
    *lead, H, W = x.shape
    H2, W2 = H // 2, W // 2
    xc = x[..., :H2 * 2, :W2 * 2].float()
    return xc.reshape(*lead, H2, 2, W2, 2).mean(dim=(-3, -1)).to(x.dtype)


def build_pyramid(volume: torch.Tensor, num_levels: int = 4):
    """(E, H1, W1, H2, W2) -> list of levels with target dims halved."""
    pyramid = [volume]
    for _ in range(num_levels - 1):
        pyramid.append(avg_pool2(pyramid[-1]))
    return pyramid


def build_pyramid_bf16(fmap1: torch.Tensor, fmap2: torch.Tensor,
                       num_levels: int = 4, pad_rows_to: int = 1):
    """Volume + pyramid in bf16, each level correlated against POOLED
    features (correlation is linear in fmap2, so this equals pooling the
    volume, floor-crop included).  ``pad_rows_to`` > 1 zero-pads each
    level's target rows up to a multiple (padded rows correlate to 0).

    The products are exact in fp32 (bf16 x bf16) and summed in fp32, then
    rounded to bf16 once.  On the card the sum runs on the tensor cores;
    on the CPU it runs as an fp32 matmul of the bf16 values, which keeps
    the summation close to the JAX package's for the parity tests.
    """
    E, C, H, W = fmap1.shape
    f1 = (fmap1.reshape(E, C, H * W).to(torch.bfloat16) / 4.0).transpose(1, 2)
    f2 = fmap2.to(torch.bfloat16) / 4.0
    levels = []
    for _ in range(num_levels):
        Hl, Wl = f2.shape[-2:]
        Hp = -(-Hl // pad_rows_to) * pad_rows_to
        f2p = torch.nn.functional.pad(f2, (0, 0, 0, Hp - Hl))
        rhs = f2p.reshape(E, C, Hp * Wl)
        if f1.is_cuda:
            vol = torch.matmul(f1, rhs)
        else:
            vol = torch.matmul(f1.float(), rhs.float()).to(torch.bfloat16)
        levels.append(vol.reshape(E, H, W, Hp, Wl))
        f2 = avg_pool2(f2)
    return levels


def lookup_level(volume: torch.Tensor, coords: torch.Tensor,
                 radius: int = 3) -> torch.Tensor:
    """Sample a (2r+1)^2 window from one level (gather reference).

    volume: (E, H1, W1, H2, W2); coords: (E, H1, W1, 2) [x, y] in level
    units.  Returns (E, (2r+1)^2, H1, W1), channels x-offset major.
    """
    E, H1, W1, H2, W2 = volume.shape
    rd = 2 * radius + 1
    n_sup = rd + 1
    if H2 == 0 or W2 == 0:          # an empty level (tiny images): no taps
        return torch.zeros((E, rd * rd, H1, W1), dtype=volume.dtype,
                           device=volume.device)
    x0, y0 = coords[..., 0], coords[..., 1]
    fx, fy = torch.floor(x0), torch.floor(y0)
    dx = (x0 - fx)[..., None]
    dy = (y0 - fy)[..., None]
    offs = torch.arange(n_sup, device=volume.device)
    xi = fx.long()[..., None] - radius + offs
    yi = fy.long()[..., None] - radius + offs
    in_x = (xi >= 0) & (xi < W2)
    in_y = (yi >= 0) & (yi < H2)
    idx = (yi.clamp(0, H2 - 1)[..., :, None] * W2
           + xi.clamp(0, W2 - 1)[..., None, :]).reshape(E, H1, W1, -1)
    S = torch.gather(volume.reshape(E, H1, W1, H2 * W2), -1, idx)
    S = S.reshape(E, H1, W1, n_sup, n_sup)          # [y_tap, x_tap]
    S = S * (in_y[..., :, None] & in_x[..., None, :]).to(S.dtype)
    out = _window(S, dx, dy, rd)                     # (E,H1,W1,b,a)
    return out.permute(0, 4, 3, 1, 2).reshape(E, rd * rd, H1, W1)


def lookup_level_onehot(volume: torch.Tensor, coords: torch.Tensor,
                        radius: int = 3) -> torch.Tensor:
    """:func:`lookup_level` as two one-hot matrix products, the JAX
    package's training lookup: the (2r+2) y taps and x taps of each pixel
    select rows and columns of its (H2, W2) slice, so the backward into
    the volume is a batched product too, summed in a fixed order (the
    gather's backward scatters with atomics).  The products run in f32:
    each output sums one volume value and zeros, so the forward equals the
    gather's exactly, and the volume's gradient is summed in f32 and
    rounded once to its dtype, as JAX's f32-accumulated contraction does.
    """
    E, H1, W1, H2, W2 = volume.shape
    rd = 2 * radius + 1
    n_sup = rd + 1
    x0, y0 = coords[..., 0], coords[..., 1]
    fx, fy = torch.floor(x0), torch.floor(y0)
    dx = (x0 - fx)[..., None]
    dy = (y0 - fy)[..., None]
    taps = torch.arange(n_sup, device=volume.device)
    yi = (fy.long() - radius)[..., None] + taps          # (E,H1,W1,8)
    xi = (fx.long() - radius)[..., None] + taps
    # out-of-range taps select nothing: the zero padding of the reference
    oy = (torch.arange(H2, device=volume.device) == yi[..., None]).float()
    ox = (torch.arange(W2, device=volume.device) == xi[..., None]).float()
    t1 = oy @ volume.float()                             # (E,H1,W1,8,W2)
    S = t1 @ ox.transpose(-1, -2)                        # [y_tap, x_tap]
    out = _window(S, dx, dy, rd)                         # (E,H1,W1,b,a)
    return out.permute(0, 4, 3, 1, 2).reshape(E, rd * rd, H1, W1)


def _select_span(blocks: torch.Tensor, sh: torch.Tensor,
                 n_sup: int) -> torch.Tensor:
    """The n_sup-wide x span starting at ``sh`` (0..7) of each 16-wide
    row of ``blocks`` (E, H1, W1, y_tap, 16), as a one-hot product."""
    k16 = torch.arange(16, device=blocks.device)
    taps = torch.arange(n_sup, device=blocks.device)
    shift = (k16[:, None] == sh[..., None, None] + taps).to(blocks.dtype)
    return torch.einsum("ehwyk,ehwkx->ehwyx", blocks, shift)


def _masked_window(S, xi, yi, x_pad: int, y_pad: int, H2: int, W2: int,
                   dx, dy, rd: int):
    """Zero the support taps outside the unpadded (H2, W2) level (the span
    starts at padded x ``xi``, y ``yi``), then the bilinear window as
    (E, rd * rd, H1, W1)."""
    n_sup = S.shape[-1]
    taps = torch.arange(n_sup, device=S.device)
    xs = (xi - x_pad)[..., None] + taps
    ys = (yi - y_pad)[..., None] + taps
    in_x = (xs >= 0) & (xs < W2)
    in_y = (ys >= 0) & (ys < H2)
    S = S * (in_y[..., :, None] & in_x[..., None, :]).to(S.dtype)
    E, H1, W1 = S.shape[:3]
    out = _window(S, dx, dy, rd)
    return out.permute(0, 4, 3, 1, 2).reshape(E, rd * rd, H1, W1)


def lookup_level_patch(volume: torch.Tensor, coords: torch.Tensor,
                       radius: int = 3) -> torch.Tensor:
    """:func:`lookup_level` through one (8 x 16) patch gather per pixel:
    the JAX package's TPU gather layout (a TPU gather costs a row,
    whatever its width), written in plain torch.  Same semantics."""
    E, H1, W1, H2, W2 = volume.shape
    rd = 2 * radius + 1
    n_sup = rd + 1
    x0, y0 = coords[..., 0], coords[..., 1]
    fx, fy = torch.floor(x0), torch.floor(y0)
    dx = (x0 - fx)[..., None]
    dy = (y0 - fy)[..., None]
    # y padded by n_sup on both sides, x by 8 in front and 24 behind, so
    # every (8, 16) slice lies in range after the shift
    volp = F.pad(volume, (8, 24, n_sup, n_sup))
    H2p, W2p = volp.shape[-2:]
    xi = torch.clamp(fx.long() - radius + 8, 0, W2p - 16)
    yi = torch.clamp(fy.long() - radius + n_sup, 0, H2p - n_sup)
    b0 = xi // 8
    dev = volume.device
    rows = yi[..., None] + torch.arange(n_sup, device=dev)
    cols = (b0 * 8)[..., None] + torch.arange(16, device=dev)
    idx = (rows[..., :, None] * W2p + cols[..., None, :]).reshape(
        E, H1, W1, n_sup * 16)
    blocks = torch.gather(volp.reshape(E, H1, W1, H2p * W2p), -1, idx)
    S = _select_span(blocks.reshape(E, H1, W1, n_sup, 16), xi - b0 * 8,
                     n_sup)
    return _masked_window(S, xi, yi, 8, n_sup, H2, W2, dx, dy, rd)


def lookup_level_blocks(volume: torch.Tensor, coords: torch.Tensor,
                        radius: int = 3) -> torch.Tensor:
    """:func:`lookup_level` through two aligned 8-wide block gathers per
    (pixel, y tap): the JAX package's TPU gather layout, written in plain
    torch.  Same semantics."""
    E, H1, W1, H2, W2 = volume.shape
    rd = 2 * radius + 1
    n_sup = rd + 1
    x0, y0 = coords[..., 0], coords[..., 1]
    fx, fy = torch.floor(x0), torch.floor(y0)
    dx = (x0 - fx)[..., None]
    dy = (y0 - fy)[..., None]
    # W2 padded to whole 8-wide blocks plus a spare one, 8 in front; H2 by
    # n_sup on both sides, so negative starts stay in range
    Wb_pad = ((W2 + 8 + 2 * 8 - 1) // 8 + 1) * 8
    volp = F.pad(volume, (8, Wb_pad - W2 - 8, n_sup, n_sup))
    H2p = H2 + 2 * n_sup
    Wb = volp.shape[-1] // 8
    vflat = volp.reshape(E, H1, W1, H2p * Wb, 8)
    xi = torch.clamp(fx.long() - radius + 8, 0, Wb * 8 - 16)
    yi = torch.clamp(fy.long() - radius + n_sup, 0, H2p - n_sup)
    b0 = xi // 8
    yrow = (yi[..., None] + torch.arange(n_sup, device=volume.device)) * Wb
    idx = torch.stack([yrow + b0[..., None], yrow + b0[..., None] + 1],
                      dim=-1).reshape(E, H1, W1, 2 * n_sup, 1)
    blocks = torch.gather(vflat, 3, idx.expand(-1, -1, -1, -1, 8))
    S = _select_span(blocks.reshape(E, H1, W1, n_sup, 16), xi - b0 * 8,
                     n_sup)
    return _masked_window(S, xi, yi, 8, n_sup, H2, W2, dx, dy, rd)


def _window(S: torch.Tensor, dx: torch.Tensor, dy: torch.Tensor,
            rd: int) -> torch.Tensor:
    """Bilinear recombination of a support S[..., y_tap, x_tap] into the
    (..., b, a) window."""
    return ((1 - dx) * (1 - dy))[..., None] * S[..., :rd, :rd] \
        + (dx * (1 - dy))[..., None] * S[..., :rd, 1:] \
        + ((1 - dx) * dy)[..., None] * S[..., 1:, :rd] \
        + (dx * dy)[..., None] * S[..., 1:, 1:]


def alt_corr_level(fmap1: torch.Tensor, fmap2: torch.Tensor,
                   coords: torch.Tensor, radius: int = 3,
                   chunk: int = 8) -> torch.Tensor:
    """On-the-fly windowed correlation, no volume: each pixel of ``fmap1``
    (E, C, H1, W1), the level-0 features, is dotted with the bilinear taps
    of ``fmap2`` (E, C, H2, W2), the features at this pyramid level, around
    ``coords`` (E, H1, W1, 2) in level units.  Returns (E, (2r+1)^2, H1,
    W1), channels x-offset major; ``chunk`` edges at a time bound the
    (chunk, H1, W1, (2r+2)^2, C) tap tensor."""
    E, C, H1, W1 = fmap1.shape
    H2, W2 = fmap2.shape[-2:]
    rd = 2 * radius + 1
    n_sup = rd + 1
    offs = torch.arange(n_sup, device=fmap1.device)
    outs = []
    for s in range(0, E, chunk):
        f1, f2, co = fmap1[s:s + chunk], fmap2[s:s + chunk], \
            coords[s:s + chunk]
        n = f1.shape[0]
        x0, y0 = co[..., 0], co[..., 1]
        fx, fy = torch.floor(x0), torch.floor(y0)
        dx, dy = (x0 - fx)[..., None], (y0 - fy)[..., None]
        xi = fx.long()[..., None] - radius + offs
        yi = fy.long()[..., None] - radius + offs
        ok = (((yi >= 0) & (yi < H2))[..., :, None]
              & ((xi >= 0) & (xi < W2))[..., None, :])
        idx = (yi.clamp(0, H2 - 1)[..., :, None] * W2
               + xi.clamp(0, W2 - 1)[..., None, :]).reshape(n, -1)
        f2f = (f2.reshape(n, C, H2 * W2).float() / 4.0).transpose(1, 2)
        taps = torch.gather(f2f, 1, idx[..., None].expand(-1, -1, C)) \
            .reshape(n, H1, W1, n_sup * n_sup, C)
        S = torch.einsum("nhwsc,nchw->nhws", taps, f1.float() / 4.0)
        S = S.reshape(n, H1, W1, n_sup, n_sup) * ok
        out = _window(S, dx, dy, rd)                        # (n,H1,W1,b,a)
        outs.append(out.permute(0, 4, 3, 1, 2).reshape(n, rd * rd, H1, W1))
    return torch.cat(outs, dim=0)


class CorrPyramid:
    """4-level correlation pyramid with the reference lookup, or with
    ``onehot=True`` the one-hot lookup (training: its backward has no
    atomics)."""

    def __init__(self, levels, radius: int = 3, onehot: bool = False):
        self.levels = list(levels)
        self.radius = radius
        self.onehot = onehot

    @staticmethod
    def build(fmap1, fmap2, num_levels: int = 4, radius: int = 3):
        return CorrPyramid(build_pyramid(build_volume(fmap1, fmap2),
                                         num_levels), radius)

    def __call__(self, coords: torch.Tensor) -> torch.Tensor:
        """coords: (E, H1, W1, 2) level-0 [x, y] -> (E, L*(2r+1)^2, H1, W1)."""
        if self.onehot:
            return torch.cat([lookup_level_onehot(v, coords / (2 ** lvl),
                                                  self.radius)
                              for lvl, v in enumerate(self.levels)], dim=1)
        return torch.cat([lookup_level(v.float(), coords / (2 ** lvl),
                                       self.radius)
                          for lvl, v in enumerate(self.levels)], dim=1)

    def cat(self, other: "CorrPyramid") -> "CorrPyramid":
        return CorrPyramid([torch.cat([a, b], dim=0) for a, b in
                            zip(self.levels, other.levels)], self.radius,
                           self.onehot)

    def __getitem__(self, index) -> "CorrPyramid":
        return CorrPyramid([lv[index] for lv in self.levels], self.radius,
                           self.onehot)


# the grouped TPU kernel takes 16-pixel groups of sublane-aligned rows;
# other shapes go to the per-pixel single-level kernel
_GROUP = 16


class CorrPyramidPallas:
    """Correlation pyramid (bf16 levels) that looks up through the CUDA
    kernels of ``corr_lookup``: ``nhwc(coords) -> (E, H1, W1, 196)`` and the
    channel-major ``__call__(coords) -> (E, 196, H1, W1)``.

    It calls the counterpart of whichever kernel the JAX class of the same
    name calls: four non-empty levels go to :func:`corr_lookup.
    lookup_pyramid` in one launch; another level count, an empty level, or
    ``grouped=True`` go level by level, to :func:`corr_lookup.
    lookup_level_grouped` where the grouped TPU kernel applies (W1 a
    multiple of 16, slab rows a multiple of 8) and to :func:`corr_lookup.
    lookup_level` otherwise.  The CUDA kernels themselves take every shape.
    """

    def __init__(self, levels, radius: int = 3, grouped: bool = False):
        if radius != 3:
            raise ValueError("the lookup kernels are specialized to radius 3")
        self.levels = [lv.to(torch.bfloat16).contiguous() for lv in levels]
        self.radius = radius
        self.grouped = grouped

    @staticmethod
    def from_volume(volume: torch.Tensor,
                    num_levels: int = 4) -> "CorrPyramidPallas":
        return CorrPyramidPallas(build_pyramid(volume, num_levels))

    def nhwc(self, coords: torch.Tensor) -> torch.Tensor:
        coords = coords.contiguous()
        ok4 = len(self.levels) == 4 and all(
            v.shape[-1] > 0 and v.shape[-2] > 0 for v in self.levels)
        if ok4 and not self.grouped:
            return corr_lookup.lookup_pyramid(self.levels, coords)
        outs = []
        for lvl, vol in enumerate(self.levels):
            takes_group = (self.grouped and vol.shape[2] % _GROUP == 0
                           and vol.shape[-2] % 8 == 0)
            fn = (corr_lookup.lookup_level_grouped if takes_group
                  else corr_lookup.lookup_level)
            outs.append(fn(vol, coords / (2 ** lvl)))
        return torch.cat(outs, dim=-1)

    def __call__(self, coords: torch.Tensor) -> torch.Tensor:
        coords = coords.contiguous()
        return torch.cat([corr_lookup.lookup_level_cm(vol, coords / (2 ** lvl))
                          for lvl, vol in enumerate(self.levels)], dim=1)
