"""Frozen copy of ``nerf_slam_tpu_torch/fusion/ngp.py``, the benchmark's plain
reference: later changes to the port do not reach it.

The hash-grid radiance field and volume rendering: instant-ngp's
multiresolution hash grid (``hashgrid.py``) into a 64-wide density MLP
and a 3-layer colour MLP (:class:`NGPField`), stratified and
depth-guided ray samples and the volume-rendering integral.  Dense layers
compute in ``compute_dtype`` on f32 weights; the random draws come in as
tensors.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .hashgrid import HashGridConfig, encode_chunked, init_table


@dataclass(frozen=True)
class NGPConfig:
    encoding: str = "pe"            # "pe" | "hash"
    grid: HashGridConfig = field(default_factory=HashGridConfig)
    pe_degrees: int = 10            # frequency bands for "pe"
    hidden: int = 64                # density-MLP width for "hash", and
                                    # the color MLP's
    pe_hidden: int = 256            # trunk width for "pe"
    pe_depth: int = 4               # trunk layers for "pe"
    geo_features: int = 15          # density head's extra outputs
    n_uniform: int = 96             # stratified samples / ray
    n_depth: int = 32               # depth-guided samples / ray
    near: float = 0.05
    far: float = 1.2                # normalized scene units
    depth_sigma_floor: float = 0.012
    rgb_weight: float = 1.0
    depth_weight: float = 0.5
    lr: float = 1e-2                # Adam rate for "hash"
    pe_lr: float = 5e-4             # and for "pe"
    density_activation: str = "exp"  # exp (instant-ngp) | softplus
    hash_chunk: int = 131072        # points per hash gather (0: one op)


def sh_encode_deg4(dirs: torch.Tensor) -> torch.Tensor:
    """Real spherical harmonics up to degree 4 (16 components) of unit
    directions (..., 3), instant-ngp's view encoding."""
    x, y, z = dirs.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    return torch.stack([
        0.28209479177387814 * torch.ones_like(x),
        -0.48860251190291987 * y,
        0.48860251190291987 * z,
        -0.48860251190291987 * x,
        1.0925484305920792 * xy,
        -1.0925484305920792 * yz,
        0.94617469575755997 * zz - 0.31539156525251999,
        -1.0925484305920792 * xz,
        0.54627421529603959 * (xx - yy),
        0.59004358992664352 * y * (-3.0 * xx + yy),
        2.8906114426405538 * xy * z,
        0.45704579946446572 * y * (1.0 - 5.0 * zz),
        0.3731763325901154 * z * (5.0 * zz - 3.0),
        0.45704579946446572 * x * (1.0 - 5.0 * zz),
        1.4453057213202769 * z * (xx - yy),
        0.59004358992664352 * x * (-xx + 3.0 * yy),
    ], dim=-1)


class Dense(nn.Linear):
    """Linear layer computing in ``compute_dtype`` (master weights stay
    f32 for the optimizer)."""

    def __init__(self, cin: int, cout: int, compute_dtype: torch.dtype):
        super().__init__(cin, cout)
        self.compute_dtype = compute_dtype

    # the control's lower precision (see layers.Conv.quant)
    quant = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        x, w = x.to(dt), self.weight.to(dt)
        if self.quant is not None:
            x, w = self.quant(x), self.quant(w)
        return F.linear(x, w, self.bias.to(dt))


def _lecun_init(module: nn.Module,
                generator: Optional[torch.Generator]) -> None:
    """flax's Dense init: LeCun-normal kernels (truncated at two standard
    deviations), zero biases."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, Dense):
                std = 1.0 / math.sqrt(m.in_features) / 0.87962566103423978
                w = torch.empty(m.weight.shape)
                nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                                      generator=generator)
                m.weight.copy_(w * std)
                m.bias.zero_()


def _density(raw: torch.Tensor, cfg: NGPConfig) -> torch.Tensor:
    if cfg.density_activation == "exp":
        return torch.exp(torch.clamp(raw, -15.0, 12.0))
    return F.softplus(raw)


class NGPField(nn.Module):
    """Hash-grid radiance field: density and color MLPs on hash features
    (layer names as the JAX package's flax ``NGPField``).  The (L, T, F)
    f32 table is the parameter ``table``; :func:`query` encodes positions
    with it and hands the features to :meth:`forward`."""

    def __init__(self, cfg: NGPConfig,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.density_0 = Dense(cfg.grid.out_dim, cfg.hidden, compute_dtype)
        self.density_1 = Dense(cfg.hidden, 1 + cfg.geo_features,
                               compute_dtype)
        self.rgb_0 = Dense(cfg.geo_features + 16, cfg.hidden, compute_dtype)
        self.rgb_1 = Dense(cfg.hidden, cfg.hidden, compute_dtype)
        self.rgb_2 = Dense(cfg.hidden, 3, compute_dtype)
        _lecun_init(self, generator)
        self.table = nn.Parameter(init_table(cfg.grid, generator))

    def forward(self, feat: torch.Tensor, dirs: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """feat: (N, L*F) hash features; dirs: (N, 3) unit.
        Returns (sigma (N,) f32, rgb (N, 3) f32)."""
        dt = self.density_0.compute_dtype
        h = self.density_1(F.relu(self.density_0(feat.to(dt))))
        sigma = _density(h[..., 0].float(), self.cfg)
        c = torch.cat([h[..., 1:], sh_encode_deg4(dirs).to(dt)], dim=-1)
        c = F.relu(self.rgb_0(c))
        c = F.relu(self.rgb_1(c))
        return sigma, torch.sigmoid(self.rgb_2(c).float())


def query(field: nn.Module, pos: torch.Tensor, dirs: torch.Tensor):
    """pos, dirs: (..., 3) -> (sigma (...), rgb (..., 3)), through the
    hash encoding first for a hash field."""
    lead = pos.shape[:-1]
    pos, dirs = pos.reshape(-1, 3), dirs.reshape(-1, 3)
    cfg = field.cfg
    if cfg.encoding == "hash":
        pos = encode_chunked(field.table, pos, cfg.grid, cfg.hash_chunk)
    sigma, rgb = field(pos, dirs)
    return sigma.reshape(lead), rgb.reshape(lead + (3,))


# ---------------------------------------------------------------------------
# sampling + rendering
# ---------------------------------------------------------------------------

def sample_along_rays(depth_guess: torch.Tensor, depth_valid: torch.Tensor,
                      cfg: NGPConfig, draws) -> torch.Tensor:
    """Sorted sample distances (R, n_uniform + n_depth): stratified over
    [near, far] plus a Gaussian around the supervised depth (uniform where
    a ray has none).  ``draws`` from :func:`draw_ray_samples`."""
    u_strat, z, u_fallback = draws
    dev = depth_guess.device
    edges = torch.linspace(cfg.near, cfg.far, cfg.n_uniform + 1, device=dev)
    lo, hi = edges[:-1][None], edges[1:][None]
    tu = lo + (hi - lo) * u_strat
    sigma = torch.clamp(0.05 * depth_guess.abs(),
                        min=cfg.depth_sigma_floor)[:, None]
    td = depth_guess[:, None] + sigma * z
    td_fallback = cfg.near + (cfg.far - cfg.near) * u_fallback
    td = torch.where(depth_valid[:, None] > 0, td, td_fallback)
    td = torch.clamp(td, cfg.near, cfg.far)
    return torch.sort(torch.cat([tu, td], dim=-1), dim=-1).values


def render_rays(field: nn.Module, cfg: NGPConfig, origins: torch.Tensor,
                dirs: torch.Tensor, t: torch.Tensor):
    """Volume rendering of rays o + t d (dirs not necessarily unit; t in
    units of |d|).  Returns (rgb (R, 3), depth (R,), acc (R,),
    weights (R, S))."""
    S = t.shape[-1]
    pos = origins[:, None, :] + t[..., None] * dirs[:, None, :]
    dnorm = torch.linalg.norm(dirs, dim=-1, keepdim=True)
    view = (dirs / dnorm)[:, None, :].expand(pos.shape)
    sigma, rgb = query(field, pos, view)
    inside = ((pos >= 0.0) & (pos <= 1.0)).all(dim=-1)
    sigma = torch.where(inside, sigma, torch.zeros_like(sigma))
    dt = torch.diff(t, dim=-1,
                    append=t[..., -1:] + (cfg.far - cfg.near) / S)
    alpha = 1.0 - torch.exp(-sigma * dt * dnorm)
    trans = torch.cumprod(1.0 - alpha + 1e-10, dim=-1)
    trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]],
                      dim=-1)
    weights = alpha * trans
    rgb_out = (weights[..., None] * rgb).sum(dim=-2)
    depth_out = (weights * t).sum(dim=-1)
    acc = weights.sum(dim=-1)
    return rgb_out, depth_out, acc, weights
