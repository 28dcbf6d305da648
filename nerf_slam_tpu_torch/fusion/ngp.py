"""Frequency-encoded radiance field and volume rendering (PyTorch).

The mapping backbone of the main path (the JAX package's default
``NGPConfig.encoding="pe"``; the hash grid is not ported yet): a
NeRF positional encoding into a 4-layer, 256-wide MLP with a skip, an
exp density head and an SH-conditioned color head.  Its layers compute
in bf16 on f32 master weights, as the JAX package's ``dtype=bf16`` dense
layers do.

Randomness is drawn outside the math: every sampling function takes its
uniform/normal draws as tensors (see :func:`draw_ray_samples`), so a test
can feed the same numbers to this package and the JAX one.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


@dataclass(frozen=True)
class NGPConfig:
    pe_degrees: int = 10            # frequency bands
    hidden: int = 64                # color-MLP width
    pe_hidden: int = 256            # trunk width
    pe_depth: int = 4               # trunk layers
    geo_features: int = 15          # density head's extra outputs
    n_uniform: int = 96             # stratified samples / ray
    n_depth: int = 32               # depth-guided samples / ray
    near: float = 0.05
    far: float = 1.2                # normalized scene units
    depth_sigma_floor: float = 0.012
    rgb_weight: float = 1.0
    depth_weight: float = 0.5
    pe_lr: float = 5e-4


def positional_encoding(x: torch.Tensor, degrees: int) -> torch.Tensor:
    """NeRF frequency encoding of [0,1]^3 positions -> (..., 6*degrees),
    per band [sin(x, y, z), cos(x, y, z)]."""
    x = 2.0 * x - 1.0
    freqs = (2.0 ** torch.arange(degrees, dtype=x.dtype,
                                 device=x.device)) * math.pi
    xb = x[..., None, :] * freqs[:, None]               # (..., deg, 3)
    enc = torch.cat([torch.sin(xb), torch.cos(xb)], dim=-1)
    return enc.reshape(x.shape[:-1] + (6 * degrees,))


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class PEField(nn.Module):
    """Frequency-encoded MLP radiance field.  Layer names follow the JAX
    package's flax module (``trunk_i``, ``density_out``, ``rgb_0/1``), so
    its parameters convert one to one (models/convert.py)."""

    def __init__(self, cfg: NGPConfig = NGPConfig(),
                 compute_dtype: torch.dtype = torch.bfloat16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        n_pe = 6 * cfg.pe_degrees
        cin = n_pe
        for i in range(cfg.pe_depth):
            setattr(self, f"trunk_{i}", Dense(cin, cfg.pe_hidden,
                                              compute_dtype))
            cin = cfg.pe_hidden + (n_pe if i == cfg.pe_depth // 2 - 1
                                   else 0)
        self.density_out = Dense(cin, 1 + cfg.geo_features, compute_dtype)
        self.rgb_0 = Dense(cfg.geo_features + 16, cfg.hidden, compute_dtype)
        self.rgb_1 = Dense(cfg.hidden, 3, compute_dtype)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """flax's Dense init: LeCun-normal kernels (truncated at two
        standard deviations), zero biases."""
        for m in self.modules():
            if isinstance(m, Dense):
                std = 1.0 / math.sqrt(m.in_features) / 0.87962566103423978
                w = torch.empty(m.weight.shape)
                nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0,
                                      generator=generator)
                m.weight.copy_(w * std)
                m.bias.zero_()

    def forward(self, pos: torch.Tensor, dirs: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """pos: (N, 3) in [0,1]^3; dirs: (N, 3) unit.
        Returns (sigma (N,) f32, rgb (N, 3) f32)."""
        cfg = self.cfg
        dt = self.trunk_0.compute_dtype
        h = positional_encoding(pos, cfg.pe_degrees).to(dt)
        skip = h
        for i in range(cfg.pe_depth):
            h = F.relu(getattr(self, f"trunk_{i}")(h))
            if i == cfg.pe_depth // 2 - 1:
                h = torch.cat([h, skip], dim=-1)
        raw = self.density_out(h)
        sigma = torch.exp(torch.clamp(raw[..., 0].float(), -15.0, 12.0))
        c = torch.cat([raw[..., 1:], sh_encode_deg4(dirs).to(dt)], dim=-1)
        c = self.rgb_1(F.relu(self.rgb_0(c)))
        return sigma, torch.sigmoid(c.float())


def query(field: PEField, pos: torch.Tensor, dirs: torch.Tensor):
    """pos, dirs: (..., 3) -> (sigma (...), rgb (..., 3))."""
    lead = pos.shape[:-1]
    sigma, rgb = field(pos.reshape(-1, 3), dirs.reshape(-1, 3))
    return sigma.reshape(lead), rgb.reshape(lead + (3,))


# ---------------------------------------------------------------------------
# sampling + rendering
# ---------------------------------------------------------------------------

def draw_ray_samples(n_rays: int, cfg: NGPConfig, generator: torch.Generator,
                     device) -> Tuple[torch.Tensor, ...]:
    """The random draws of :func:`sample_along_rays`: stratified jitter
    (R, n_uniform), depth-guided normals (R, n_depth) and their uniform
    fallback (R, n_depth)."""
    kw = dict(generator=generator, device=device)
    return (torch.rand((n_rays, cfg.n_uniform), **kw),
            torch.randn((n_rays, cfg.n_depth), **kw),
            torch.rand((n_rays, cfg.n_depth), **kw))


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


def occupancy_grid(field: PEField, res: int, device) -> torch.Tensor:
    """Dense sigma grid over the unit cube, (res, res, res) [z, y, x]."""
    g = (torch.arange(res, dtype=torch.float32, device=device) + 0.5) / res
    zz, yy, xx = torch.meshgrid(g, g, g, indexing="ij")
    pos = torch.stack([xx, yy, zz], dim=-1).reshape(-1, 3)
    dirs = torch.zeros_like(pos)
    dirs[:, 2] = 1.0                                  # sigma ignores dirs
    sigma, _ = query(field, pos, dirs)
    return sigma.reshape(res, res, res)


def ray_occ_interval(occ_mask: torch.Tensor, origins: torch.Tensor,
                     dirs: torch.Tensor, cfg: NGPConfig, n_coarse: int = 64):
    """Per-ray [t_lo, t_hi] around the occupied probes of ``n_coarse``
    points along [near, far], padded by one probe spacing; rays that hit
    nothing keep the full interval.  Returns (t_lo, t_hi, any_hit)."""
    res = occ_mask.shape[0]
    tc = torch.linspace(cfg.near, cfg.far, n_coarse, device=origins.device)
    pos = origins[:, None, :] + tc[None, :, None] * dirs[:, None, :]
    inside = ((pos >= 0.0) & (pos < 1.0)).all(dim=-1)
    idx = torch.clamp((pos * res).to(torch.int64), 0, res - 1)
    hit = occ_mask[idx[..., 2], idx[..., 1], idx[..., 0]] & inside
    any_hit = hit.any(dim=-1)
    hit_i = hit.to(torch.int8)
    first = torch.argmax(hit_i, dim=-1)
    last = (n_coarse - 1) - torch.argmax(hit_i.flip(-1), dim=-1)
    pad = (cfg.far - cfg.near) / n_coarse
    t_lo = torch.where(any_hit, tc[first] - pad, cfg.near)
    t_hi = torch.where(any_hit, tc[last] + pad, cfg.far)
    return (torch.clamp(t_lo, cfg.near, cfg.far),
            torch.clamp(t_hi, cfg.near, cfg.far), any_hit)


def sample_in_interval(t_lo: torch.Tensor, t_hi: torch.Tensor,
                       u: torch.Tensor) -> torch.Tensor:
    """Stratified samples inside per-ray [t_lo, t_hi]; ``u`` (R, n)
    uniform jitter.  Sorted."""
    n = u.shape[-1]
    edges = torch.linspace(0.0, 1.0, n + 1, device=u.device)
    s = edges[:-1][None] + (edges[1:] - edges[:-1])[None] * u
    return t_lo[:, None] + (t_hi - t_lo)[:, None] * s


def render_rays(field: PEField, cfg: NGPConfig, origins: torch.Tensor,
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
