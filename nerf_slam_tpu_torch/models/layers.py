"""Shared NN building blocks (NHWC at the public boundary).

Modules keep the JAX package's names (``conv1``, ``layer1_0``, ...) so the
flat weight keys map one to one (models/convert.py).  Convolutions run on
NHWC tensors through a channels-last view, so no layout copy is made.
Instance/none norms carry no parameters.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-sample, per-channel normalization over H, W of an NHWC tensor,
    computed in fp32 and returned in the input dtype."""
    xf = x.float()
    mean = xf.mean(dim=(-3, -2), keepdim=True)
    var = xf.var(dim=(-3, -2), keepdim=True, unbiased=False)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def apply_norm(x: torch.Tensor, norm: str) -> torch.Tensor:
    if norm == "instance":
        return instance_norm(x)
    if norm == "none":
        return x
    raise ValueError(f"norm '{norm}' not supported")


class _GradientClip(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ok = torch.isfinite(g) & (g.abs() < 0.01)
        return torch.where(ok, g, torch.zeros_like(g))


def gradient_clip(x: torch.Tensor) -> torch.Tensor:
    """Identity forward; zeroes gradients with |g| >= 0.01 or non-finite."""
    return _GradientClip.apply(x)


class Conv(nn.Conv2d):
    """Conv2d on NHWC tensors with torch-style symmetric padding; the
    input, weight and bias are cast to the compute dtype (``compute_dtype``,
    by default the weight's: training keeps f32 weights and computes in
    bf16, as flax's ``dtype`` does), the output is NHWC."""

    compute_dtype = None

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: int = -1):
        pad = kernel // 2 if padding < 0 else padding
        super().__init__(cin, cout, kernel, stride=stride, padding=pad)

    @property
    def cdtype(self) -> torch.dtype:
        return self.compute_dtype or self.weight.dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.cdtype
        y = F.conv2d(x.to(cd).permute(0, 3, 1, 2), self.weight.to(cd),
                     self.bias.to(cd), self.stride, self.padding)
        return y.permute(0, 2, 3, 1)


class ResidualBlock(nn.Module):
    """Two 3x3 convs + optional strided 1x1 downsample; ReLU on the second
    conv before the skip add and again after it (as the reference)."""

    def __init__(self, cin: int, planes: int, norm: str, stride: int):
        super().__init__()
        self.norm = norm
        self.conv1 = Conv(cin, planes, 3, stride, 1)
        self.conv2 = Conv(planes, planes, 3, 1, 1)
        self.downsample = (Conv(cin, planes, 1, stride, 0)
                           if stride != 1 else None)

    def forward(self, x):
        y = F.relu(apply_norm(self.conv1(x), self.norm))
        y = F.relu(apply_norm(self.conv2(y), self.norm))
        if self.downsample is not None:
            x = apply_norm(self.downsample(x), self.norm)
        return F.relu(x.to(y.dtype) + y)


class BasicEncoder(nn.Module):
    """RAFT encoder: 7x7/2 stem + 3 residual stages (32 -> 64 -> 128
    channels, 1/8 resolution) + 1x1 head.  (..., H, W, 3) -> (..., H/8,
    W/8, output_dim)."""

    def __init__(self, output_dim: int = 128, norm: str = "instance"):
        super().__init__()
        self.norm = norm
        self.conv1 = Conv(3, 32, 7, 2, 3)
        cin = 32
        for stage, (planes, stride) in enumerate(
                [(32, 1), (64, 2), (128, 2)], start=1):
            setattr(self, f"layer{stage}_0",
                    ResidualBlock(cin, planes, norm, stride))
            setattr(self, f"layer{stage}_1",
                    ResidualBlock(planes, planes, norm, 1))
            cin = planes
        self.conv2 = Conv(128, output_dim, 1, 1, 0)

    def forward(self, x):
        lead = x.shape[:-3]
        x = x.reshape((-1,) + tuple(x.shape[-3:]))
        x = F.relu(apply_norm(self.conv1(x), self.norm))
        for stage in (1, 2, 3):
            x = getattr(self, f"layer{stage}_0")(x)
            x = getattr(self, f"layer{stage}_1")(x)
        x = self.conv2(x)
        return x.reshape(tuple(lead) + tuple(x.shape[-3:]))
