"""Convex-combination 8x upsampling of dense fields (PyTorch).

Each fine pixel is a softmax-weighted convex combination of its 3x3
coarse neighborhood; out-of-image neighbors are masked out, and an
optional ``pow`` is applied to the weights.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _gather_patches(data: torch.Tensor) -> torch.Tensor:
    """(B, H, W, D) -> (B, 9, H, W, D): zero-padded 3x3 neighborhoods."""
    H, W = data.shape[1:3]
    padded = F.pad(data, (0, 0, 1, 1, 1, 1))
    return torch.stack([padded[:, dy:dy + H, dx:dx + W, :]
                        for dy in range(3) for dx in range(3)], dim=1)


def cvx_upsample(data: torch.Tensor, mask: torch.Tensor,
                 pow: float = 1.0) -> torch.Tensor:
    """(B, H, W, D) -> (B, 8H, 8W, D); mask: (B, 576, H, W) logits."""
    B, H, W, D = data.shape
    logits = mask.reshape(B, 9, 8, 8, H, W)
    dev = data.device
    nbr = torch.arange(9, device=dev)
    row = torch.arange(H, device=dev)
    col = torch.arange(W, device=dev)
    top = (nbr < 3)[:, None, None] & (row == 0)[None, :, None]
    bottom = (nbr >= 6)[:, None, None] & (row == H - 1)[None, :, None]
    left = (nbr % 3 == 0)[:, None, None] & (col == 0)[None, None, :]
    right = (nbr % 3 == 2)[:, None, None] & (col == W - 1)[None, None, :]
    invalid = (top | bottom | left | right)[None, :, None, None]
    logits = torch.where(invalid, torch.finfo(logits.dtype).min, logits)
    weights = torch.softmax(logits, dim=1)
    if pow != 1.0:
        weights = weights ** pow
    up = torch.einsum("bnuvhw,bnhwd->buvhwd", weights, _gather_patches(data))
    return up.permute(0, 3, 1, 4, 2, 5).reshape(B, 8 * H, 8 * W, D)


def upsample_disp(disp: torch.Tensor, mask: torch.Tensor,
                  pow: float = 1.0) -> torch.Tensor:
    """(B, H, W) field + (B, 576, H, W) mask -> (B, 8H, 8W)."""
    return cvx_upsample(disp[..., None], mask, pow=pow)[..., 0]
