"""DROID update operator: ConvGRU + flow/weight heads + graph aggregation.

NHWC tensors at every public method; per-view pooling is a segment mean
over depth-slot indices (``seg < 0`` marks a padded edge, dropped), so the
operator runs on padded edge sets; the mean sums in f32 in a fixed order
(``ops/segment.py``), so the same inputs give the same bits.
``DroidNet(dtype=...)`` holds its weights in that dtype (bf16 on the card,
fp32 in the algorithm tests) and computes in it; with ``param_dtype`` it
holds them in that dtype and computes in ``dtype``, as the JAX package's
``DroidNet(dtype=...)`` does with its f32 parameters (training).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.segment import segment_mean
from .layers import BasicEncoder, Conv, gradient_clip


def _conv_slice(conv: Conv, x: torch.Tensor, k: torch.Tensor,
                with_bias: bool) -> torch.Tensor:
    """``conv`` restricted to the input channels whose kernel slice is
    ``k`` (O, I', kh, kw); same padding and compute dtype as the full
    conv."""
    cd = conv.cdtype
    y = F.conv2d(x.to(cd).permute(0, 3, 1, 2), k.to(cd),
                 conv.bias.to(cd) if with_bias else None, 1, conv.padding)
    return y.permute(0, 2, 3, 1)


class ConvGRU(nn.Module):
    """3x3 ConvGRU with a sigmoid-gated global-context path."""

    def __init__(self, h_planes: int = 128, i_planes: int = 320):
        super().__init__()
        self.h_planes, self.i_planes = h_planes, i_planes
        c = h_planes + i_planes
        self.convz = Conv(c, h_planes, 3)
        self.convr = Conv(c, h_planes, 3)
        self.convq = Conv(c, h_planes, 3)
        self.w = Conv(h_planes, h_planes, 1)
        self.convz_glo = Conv(h_planes, h_planes, 1)
        self.convr_glo = Conv(h_planes, h_planes, 1)
        self.convq_glo = Conv(h_planes, h_planes, 1)

    def precompute_inp(self, inp: torch.Tensor):
        """Each gate conv's contribution from the context block ``inp``
        (input channels h..h+ci), constant across an update round's
        iterations.  Returns (z_inp, r_inp, q_inp)."""
        h, ci = self.h_planes, inp.shape[-1]
        return tuple(_conv_slice(c, inp, c.weight[:, h:h + ci], False)
                     for c in (self.convz, self.convr, self.convq))

    def forward(self, net, *inputs, gates_inp=None):
        dt = self.convz.cdtype
        net = net.to(dt)
        glo = torch.sigmoid(self.w(net)) * net
        glo = glo.mean(dim=(-3, -2), keepdim=True)        # (E, 1, 1, 128)
        if gates_inp is not None:
            # ``inputs`` exclude the context block; each gate is one conv
            # over [net ++ rest] plus the precomputed context part
            z_i, r_i, q_i = gates_inp
            h = self.h_planes
            rest = torch.cat([t.to(dt) for t in inputs], dim=-1)
            ci = self.i_planes - rest.shape[-1]

            def k(conv):
                return torch.cat([conv.weight[:, :h],
                                  conv.weight[:, h + ci:]], dim=1)

            net_rest = torch.cat([net, rest], dim=-1)
            z = torch.sigmoid(_conv_slice(self.convz, net_rest,
                                          k(self.convz), True)
                              + z_i + self.convz_glo(glo))
            r = torch.sigmoid(_conv_slice(self.convr, net_rest,
                                          k(self.convr), True)
                              + r_i + self.convr_glo(glo))
            q = torch.tanh(_conv_slice(self.convq,
                                       torch.cat([r * net, rest], dim=-1),
                                       k(self.convq), True)
                           + q_i + self.convq_glo(glo))
            return (1 - z) * net + z * q
        inp = torch.cat([t.to(dt) for t in inputs], dim=-1)
        net_inp = torch.cat([net, inp], dim=-1)
        z = torch.sigmoid(self.convz(net_inp) + self.convz_glo(glo))
        r = torch.sigmoid(self.convr(net_inp) + self.convr_glo(glo))
        q = torch.tanh(self.convq(torch.cat([r * net, inp], dim=-1))
                       + self.convq_glo(glo))
        return (1 - z) * net + z * q


class GraphAgg(nn.Module):
    """Pool hidden states per source view -> damping eta + upsample mask."""

    def __init__(self):
        super().__init__()
        self.conv1 = Conv(128, 128, 3)
        self.conv2 = Conv(128, 128, 3)
        self.eta_0 = Conv(128, 1, 3)
        self.upmask_0 = Conv(128, 8 * 8 * 9, 1)

    def _pooled(self, net, seg, n_seg: int):
        x = F.relu(self.conv1(net))
        return F.relu(self.conv2(segment_mean(x, seg, n_seg)))

    def eta(self, net, seg, n_seg: int) -> torch.Tensor:
        e = self.eta_0(self._pooled(net, seg, n_seg))
        return 0.01 * F.softplus(gradient_clip(e.float()))[..., 0]

    def forward(self, net, seg, n_seg: int):
        y = self._pooled(net, seg, n_seg)
        eta = 0.01 * F.softplus(gradient_clip(self.eta_0(y).float()))[..., 0]
        return eta, self.upmask_0(y).float()     # (K,H,W), (K,H,W,576)


class UpdateModule(nn.Module):
    """RAFT-SLAM update operator."""

    def __init__(self):
        super().__init__()
        self.corr_encoder_0 = Conv(196, 128, 1)
        self.corr_encoder_2 = Conv(128, 128, 3)
        self.flow_encoder_0 = Conv(4, 128, 7)
        self.flow_encoder_2 = Conv(128, 64, 3)
        self.weight_0 = Conv(128, 128, 3)
        self.weight_2 = Conv(128, 2, 3)
        self.delta_0 = Conv(128, 128, 3)
        self.delta_2 = Conv(128, 2, 3)
        self.gru = ConvGRU(128, 320)
        self.agg = GraphAgg()

    def forward(self, net, inp, corr, flow=None, seg=None,
                n_seg: Optional[int] = None, with_upmask: bool = True,
                gates_inp=None):
        """net/inp: (E, H, W, 128); corr: (E, H, W, 196); flow: (E, H, W,
        4).  Returns (net, delta, weight[, eta[, upmask]]), delta/weight
        (E, H, W, 2) fp32.  With ``gates_inp`` the context ``inp`` is
        ignored."""
        E, H, W, _ = net.shape
        if flow is None:
            flow = torch.zeros((E, H, W, 4), dtype=net.dtype,
                               device=net.device)
        c = F.relu(self.corr_encoder_2(F.relu(self.corr_encoder_0(corr))))
        f = F.relu(self.flow_encoder_2(F.relu(self.flow_encoder_0(flow))))
        if gates_inp is not None:
            net = self.gru(net, c, f, gates_inp=gates_inp)
        else:
            net = self.gru(net, inp, c, f)
        d = self.delta_2(F.relu(self.delta_0(net)))
        delta = gradient_clip(d.float())
        w = self.weight_2(F.relu(self.weight_0(net)))
        weight = torch.sigmoid(gradient_clip(w.float()))
        if seg is None:
            return net, delta, weight
        if with_upmask:
            eta, upmask = self.agg(net, seg, n_seg)
            return net, delta, weight, eta, upmask
        return net, delta, weight, self.agg.eta(net, seg, n_seg)


class DroidNet(nn.Module):
    """Feature encoder + context encoder + update operator."""

    def __init__(self, dtype: torch.dtype = torch.bfloat16,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.feature_net = BasicEncoder(128, "instance")
        self.context_net = BasicEncoder(256, "none")
        self.update_net = UpdateModule()
        self.to(param_dtype or dtype)
        if param_dtype is not None and param_dtype != dtype:
            for m in self.modules():
                if isinstance(m, Conv):
                    m.compute_dtype = dtype

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype."""
        return self.feature_net.conv1.cdtype

    def features(self, images: torch.Tensor) -> torch.Tensor:
        """(..., H, W, 3) normalized images -> (..., H/8, W/8, 128)."""
        return self.feature_net(images)

    def context(self, images: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (hidden init tanh (..128), context relu (..128))."""
        ctx = self.context_net(images)
        net, inp = ctx.split(128, dim=-1)
        return torch.tanh(net), F.relu(inp)

    def update(self, net, inp, corr, flow=None, seg=None, n_seg=None,
               with_upmask=True, gates_inp=None):
        return self.update_net(net, inp, corr, flow, seg, n_seg,
                               with_upmask, gates_inp)

    def update_precompute(self, inp):
        return self.update_net.gru.precompute_inp(inp)

    def aggregate(self, net, seg, n_seg):
        return self.update_net.agg(net, seg, n_seg)
