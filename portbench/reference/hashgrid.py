"""Frozen copy of ``nerf_slam_tpu_torch/fusion/hashgrid.py``, the benchmark's plain
reference: later changes to the port do not reach it.

Multiresolution hash-grid encoding (PyTorch), instant-ngp's backbone.

The port of the JAX package's ``fusion/hashgrid.py``: all levels share one
flat gather per trilinear corner, and the backward is the JAX package's
hand-written VJP written out as a ``torch.autograd.Function`` (a gather
forward; a fixed-order scatter of the table gradient and the explicit
position gradient).  Defaults follow instant-ngp's base.json: 16 levels
x 2 features, a 2^19 table, base resolution 16, finest about 2048.

The hash encode is no TPU kernel: the JAX package writes it in plain
jnp, so its port is plain PyTorch.  The table gradient adds many corner
contributions into each table row.  ``index_add_`` would add them with
atomics on the card, in an order that changes between runs, so that no
two fits gave the same bits; :func:`_scatter_rows` adds each row's
contributions one after another in the order the JAX VJP scatters them
(corner by corner, then level, then point), with no atomics, so a fit
repeats to the bit.

The JAX hash works in wrapping uint32 products.  Here the low
``log2_table_size`` bits of the XOR, the only ones kept, depend only on
the low bits of each product's factors, so the primes are reduced mod T
and the products (a corner coordinate of at most 2049 times a number
below T) fit int32 at the default sizes (int64 otherwise): ``& (T - 1)``
gives the JAX indices without wrapping.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

# spatial hash primes (instant-ngp convention)
_PRIMES = (1, 2654435761, 805459861)


class HashGridConfig(NamedTuple):
    n_levels: int = 16
    n_features: int = 2
    log2_table_size: int = 19
    base_resolution: int = 16
    finest_resolution: int = 2048

    @property
    def table_size(self) -> int:
        return 1 << self.log2_table_size

    @property
    def out_dim(self) -> int:
        return self.n_levels * self.n_features

    def resolutions(self) -> np.ndarray:
        if self.n_levels == 1:
            return np.array([self.base_resolution])
        b = np.exp((np.log(self.finest_resolution)
                    - np.log(self.base_resolution)) / (self.n_levels - 1))
        return np.floor(self.base_resolution
                        * b ** np.arange(self.n_levels)).astype(np.int64)


def init_table(cfg: HashGridConfig,
               generator: Optional[torch.Generator] = None,
               dtype=torch.float32) -> torch.Tensor:
    """(L, T, F) feature table, U(-1e-4, 1e-4) as in instant-ngp (on the
    CPU, where ``generator`` draws)."""
    u = torch.rand((cfg.n_levels, cfg.table_size, cfg.n_features),
                   generator=generator, dtype=dtype)
    return u * 2e-4 - 1e-4


# corner c of a cell at offset ((c >> 2) & 1, (c >> 1) & 1, c & 1)
_CORNERS = [[(c >> 2) & 1, (c >> 1) & 1, c & 1] for c in range(8)]


def _corner_indices_weights(pos_flat: torch.Tensor, cfg: HashGridConfig):
    """Index math shared by forward and backward, for all eight corners at
    once: (idx (8, L*N) flat table indices, cw (8, L, N) trilinear
    weights, w (L, N, 3) fracs)."""
    p = torch.clamp(pos_flat, 0.0, 1.0)
    dev = p.device
    L, T = cfg.n_levels, cfg.table_size
    res_np = cfg.resolutions()
    # int32 holds every index, and (below) every hash product once the
    # primes are reduced mod T, while (res + 1) * T < 2^31
    itype = (torch.int32 if (int(res_np.max()) + 1) * T < 2 ** 31
             else torch.int64)
    res = torch.as_tensor(res_np, dtype=p.dtype, device=dev)
    res_i = torch.as_tensor(res_np, dtype=itype, device=dev)
    x = p[None, :, :] * res[:, None, None]                      # (L, N, 3)
    x0 = torch.minimum(torch.clamp(torch.floor(x).to(itype), min=0),
                       (res_i - 1)[:, None, None])
    w = x - x0.to(x.dtype)
    off = torch.tensor(_CORNERS, dtype=itype, device=dev)       # (8, 3)
    c = x0[None] + off[:, None, None, :]                        # (8,L,N,3)
    # levels whose (res + 1)^3 corners fit the table (a prefix: the
    # resolutions rise) index it densely, the rest hash
    nd = int(((res_np + 1) ** 3 <= T).sum())
    cd, ch = c[:, :nd], c[:, nd:]
    r1 = (res_i[:nd] + 1)[None, :, None]
    dense = (cd[..., 0] * r1 + cd[..., 1]) * r1 + cd[..., 2]
    # the low log2(T) bits of a product depend only on the low bits of
    # its factors: the primes mod T give JAX's wrapped uint32 hash bits
    pr = [q & (T - 1) for q in _PRIMES]
    hashed = ((ch[..., 0] * pr[0]) ^ (ch[..., 1] * pr[1])
              ^ (ch[..., 2] * pr[2])) & (T - 1)
    lvl_off = (torch.arange(L, dtype=itype, device=dev) * T)[None, :, None]
    idx = torch.cat([dense, hashed], dim=1) + lvl_off           # (8, L, N)
    sel = torch.where(off[:, None, None, :].bool(), w[None], 1 - w[None])
    cw = sel[..., 0] * sel[..., 1] * sel[..., 2]
    return idx.reshape(8, -1), cw, w


def _scatter_rows(idx: torch.Tensor, vals: torch.Tensor,
                  n_rows: int) -> torch.Tensor:
    """(n_rows, F) table whose row r is the sum of the rows of ``vals``
    (K, F) with ``idx == r``, each row's terms added one after another in
    their order in ``idx``, starting from 0.  A stable sort groups the
    terms by row and keeps their order within it; ``searchsorted`` gives
    every table row's run (empty for untouched rows), and
    ``segment_reduce`` sums each run in sequence (one thread a (row,
    feature) on the card).  No step adds with atomics and none waits for
    the host, so the same inputs give the same bits on every call."""
    sidx, perm = torch.sort(idx, stable=True)
    rows = torch.arange(n_rows + 1, dtype=sidx.dtype, device=sidx.device)
    offsets = torch.searchsorted(sidx, rows)
    return torch.segment_reduce(vals[perm], "sum", offsets=offsets, axis=0,
                                unsafe=True)


class _EncodeFlat(torch.autograd.Function):
    """(L, T, F) table + (N, 3) positions -> (N, L*F) features, with the
    JAX package's explicit backward (all eight corners in one gather and
    one fixed-order scatter)."""

    @staticmethod
    def forward(ctx, table, pos_flat, cfg):
        L, T, F = table.shape
        N = pos_flat.shape[0]
        idx, cw, _ = _corner_indices_weights(pos_flat, cfg)
        vals = table.reshape(L * T, F).index_select(0, idx.reshape(-1))
        prod = cw[..., None] * vals.reshape(8, L, N, F)
        out = prod[0]
        for c in range(1, 8):        # corner by corner, as the JAX sum
            out = out + prod[c]
        ctx.save_for_backward(table, pos_flat, idx, cw)
        ctx.cfg = cfg
        return out.permute(1, 0, 2).reshape(N, L * F)

    @staticmethod
    def backward(ctx, g):
        table, pos_flat, idx, cw = ctx.saved_tensors
        cfg = ctx.cfg
        L, T, F = table.shape
        N = pos_flat.shape[0]
        gl = g.reshape(N, L, F).permute(1, 0, 2)[None]         # (1,L,N,F)
        want_table, want_pos = ctx.needs_input_grad[:2]
        dtable = dpos = None
        if want_table:
            # g * cw scattered at the corner entries
            dtable = _scatter_rows(idx.reshape(-1),
                                   (cw[..., None] * gl).reshape(-1, F),
                                   L * T).reshape(L, T, F)
        if want_pos:
            # d(cw)/dw per axis: +/- the product of the other two axes'
            # weights, times the level's resolution
            _, _, w = _corner_indices_weights(pos_flat, cfg)
            vals = table.reshape(L * T, F).index_select(0, idx.reshape(-1))
            gv = (gl * vals.reshape(8, L, N, F)).sum(dim=-1)   # (8, L, N)
            off = torch.tensor(_CORNERS, dtype=torch.bool,
                               device=w.device)[:, None, None, :]
            sel = torch.where(off, w[None], 1 - w[None])        # (8,L,N,3)
            sign = off.to(w.dtype) * 2 - 1
            dcw = sign * torch.stack([sel[..., 1] * sel[..., 2],
                                      sel[..., 0] * sel[..., 2],
                                      sel[..., 0] * sel[..., 1]], dim=-1)
            res = torch.as_tensor(cfg.resolutions(), dtype=w.dtype,
                                  device=w.device)[None, :, None, None]
            dpos = (gv[..., None] * dcw * res).sum(dim=(0, 1))
        return dtable, dpos, None


def encode(table: torch.Tensor, pos: torch.Tensor,
           cfg: HashGridConfig) -> torch.Tensor:
    """pos (..., 3) in [0, 1]^3 -> (..., L*F) features.  Positions outside
    the cube are clamped (the caller masks them).  Differentiable in the
    table and the positions."""
    lead = pos.shape[:-1]
    out = _EncodeFlat.apply(table, pos.reshape(-1, 3), cfg)
    return out.reshape(lead + (cfg.out_dim,))


def encode_chunked(table: torch.Tensor, pos: torch.Tensor,
                   cfg: HashGridConfig, chunk: int) -> torch.Tensor:
    """:func:`encode` over chunks of ``chunk`` points (each gather and
    scatter then touches at most ``chunk * n_levels`` rows); autograd sums
    the chunks' table gradients.  ``chunk <= 0``: one chunk."""
    lead = pos.shape[:-1]
    flat = pos.reshape(-1, 3)
    if chunk <= 0 or flat.shape[0] <= chunk:
        return encode(table, pos, cfg)
    out = torch.cat([_EncodeFlat.apply(table, p, cfg)
                     for p in flat.split(chunk)])
    return out.reshape(lead + (cfg.out_dim,))
