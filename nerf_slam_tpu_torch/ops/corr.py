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
"""
from __future__ import annotations

import torch


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
    out = ((1 - dx) * (1 - dy))[..., None] * S[..., :rd, :rd] \
        + (dx * (1 - dy))[..., None] * S[..., :rd, 1:] \
        + ((1 - dx) * dy)[..., None] * S[..., 1:, :rd] \
        + (dx * dy)[..., None] * S[..., 1:, 1:]      # (E,H1,W1,b,a)
    return out.permute(0, 4, 3, 1, 2).reshape(E, rd * rd, H1, W1)


class CorrPyramid:
    """4-level correlation pyramid with the reference lookup."""

    def __init__(self, levels, radius: int = 3):
        self.levels = list(levels)
        self.radius = radius

    @staticmethod
    def build(fmap1, fmap2, num_levels: int = 4, radius: int = 3):
        return CorrPyramid(build_pyramid(build_volume(fmap1, fmap2),
                                         num_levels), radius)

    def __call__(self, coords: torch.Tensor) -> torch.Tensor:
        """coords: (E, H1, W1, 2) level-0 [x, y] -> (E, L*(2r+1)^2, H1, W1)."""
        return torch.cat([lookup_level(v.float(), coords / (2 ** lvl),
                                       self.radius)
                          for lvl, v in enumerate(self.levels)], dim=1)
