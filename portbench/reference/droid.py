"""The tracker's plain reference: DroidNet from the weight file, the
encoders, the correlation pyramid and its windowed lookup, the motion
filter's magnitude, and an update round's iterations (projective
transform, lookup, update operator, damping pool, dense BA), with a
stereo rig's (i, i) edges and an RGB-D sensor's inverse depths.

Plain PyTorch in float32 with TF32 off, from frozen copies of the
algorithm (``layers``, ``update``, ``camera``, ``se3``, ``dba``,
``segment`` beside this file).  ``quant`` (``fp8``) rounds every
convolution's input and kernel to float8 e4m3 with a per-tensor scale:
the control, one precision below the bfloat16 the tracker computes in.
The dense BA's control rounds its inputs to bfloat16 and takes TF32
products, below the float32 it states.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from . import camera, dba
from .layers import Conv
from .update import DroidNet

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
RADIUS = 3


def fp8(x: torch.Tensor) -> torch.Tensor:
    """Round to float8 e4m3 with a per-tensor scale (amax to 448), back in
    x's dtype; gradients pass the rounding unchanged (straight through)."""
    amax = x.detach().abs().amax().float().clamp(min=1e-12)
    s = 448.0 / amax
    q = ((x.detach().float() * s).to(torch.float8_e4m3fn).float()
         / s).to(x.dtype)
    return x + (q - x.detach())


def bf16(x: torch.Tensor) -> torch.Tensor:
    """Round to bfloat16, back in x's dtype."""
    return x.to(torch.bfloat16).to(x.dtype)


def plain_precision():
    """Float32 products without TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def load_net(weights_path: str, device, quant: Optional[Callable] = None
             ) -> DroidNet:
    """DroidNet in float32 from the flat flax keys of the weight file
    (conv kernels HWIO -> OIHW)."""
    net = DroidNet(dtype=torch.float32)
    sd = {}
    with np.load(weights_path, allow_pickle=False) as z:
        for key in z.files:
            if not key.startswith("params."):
                continue
            path, leaf = key[len("params."):].rsplit(".", 1)
            v = np.array(z[key], np.float32)
            if leaf == "kernel":
                v = v.transpose(3, 2, 0, 1)
                sd[f"{path}.weight"] = torch.from_numpy(v.copy())
            else:
                sd[f"{path}.bias"] = torch.from_numpy(v)
    net.load_state_dict(sd)
    for m in net.modules():
        if isinstance(m, Conv):
            m.quant = quant
    return net.to(device).eval().requires_grad_(False)


def _normalize(images_u8: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(MEAN, device=images_u8.device)
    std = torch.tensor(STD, device=images_u8.device)
    return (images_u8.float() / 255.0 - mean) / std


@torch.no_grad()
def encode(net: DroidNet, images_u8: torch.Tensor):
    """(N, H, W, 3) uint8 -> features (N, h, w, 128), hidden init (tanh)
    and context (relu)."""
    x = _normalize(images_u8)
    f = net.features(x)
    net_h, inp = net.context(x)
    return f, net_h, inp


def avg_pool2(x: torch.Tensor) -> torch.Tensor:
    *lead, H, W = x.shape
    H2, W2 = H // 2, W // 2
    return x[..., :H2 * 2, :W2 * 2].reshape(*lead, H2, 2, W2, 2).mean(
        dim=(-3, -1))


def pyramid(f1: torch.Tensor, f2: torch.Tensor, levels: int = 4):
    """(E, h, w, C) feature pairs -> the correlation volume / 16 at each
    level, (E, h, w, h_l, w_l), its targets pooled 2x2 with floor."""
    E, h, w, C = f1.shape
    a = f1.reshape(E, h * w, C) / 4.0
    b = f2.permute(0, 3, 1, 2) / 4.0
    out = []
    for _ in range(levels):
        hl, wl = b.shape[-2:]
        out.append(torch.bmm(a, b.reshape(E, C, hl * wl)).reshape(
            E, h, w, hl, wl))
        b = avg_pool2(b)
    return out


def lookup_level(volume: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of the 7x7 window around ``coords`` (E, h, w, 2)
    [x, y] in level units; out-of-range taps read zero.  (E, h, w, 49),
    channel a*7+b samples (x0-3+a, y0-3+b)."""
    E, h, w, H2, W2 = volume.shape
    rd, ns = 2 * RADIUS + 1, 2 * RADIUS + 2
    if H2 == 0 or W2 == 0:
        return volume.new_zeros((E, h, w, rd * rd))
    x0, y0 = coords[..., 0], coords[..., 1]
    fx, fy = torch.floor(x0), torch.floor(y0)
    dx, dy = (x0 - fx)[..., None, None], (y0 - fy)[..., None, None]
    offs = torch.arange(ns, device=volume.device)
    xi = fx.long()[..., None] - RADIUS + offs
    yi = fy.long()[..., None] - RADIUS + offs
    ok = ((yi >= 0) & (yi < H2))[..., :, None] \
        & ((xi >= 0) & (xi < W2))[..., None, :]
    idx = yi.clamp(0, H2 - 1)[..., :, None] * W2 \
        + xi.clamp(0, W2 - 1)[..., None, :]
    S = torch.gather(volume.reshape(E, h, w, H2 * W2), -1,
                     idx.reshape(E, h, w, -1)).reshape(E, h, w, ns, ns)
    S = S * ok.to(S.dtype)                          # [y tap, x tap]
    out = ((1 - dy) * (1 - dx) * S[..., :rd, :rd]
           + (1 - dy) * dx * S[..., :rd, 1:]
           + dy * (1 - dx) * S[..., 1:, :rd]
           + dy * dx * S[..., 1:, 1:])              # [b (y), a (x)]
    return out.transpose(-1, -2).reshape(E, h, w, rd * rd)


def lookup(levels, coords: torch.Tensor) -> torch.Tensor:
    """Four levels at coords / 2^l, level-major: (E, h, w, 196)."""
    return torch.cat([lookup_level(v, coords / (2 ** i))
                      for i, v in enumerate(levels)], dim=-1)


@torch.no_grad()
def motion_magnitude(net: DroidNet, img_cur: torch.Tensor,
                     img_kf: torch.Tensor) -> float:
    """The motion filter: the mean norm of the update operator's flow
    delta at the identity coords between the last keyframe ``img_kf`` and
    the current frame ``img_cur`` (uint8 (H, W, 3))."""
    f, h0, inp = encode(net, torch.stack([img_kf, img_cur]))
    lv = pyramid(f[:1], f[1:])
    h, w = f.shape[1:3]
    coords0 = camera.coords_grid(h, w, device=f.device)[None]
    _, delta, _ = net.update(h0[:1], inp[:1], lookup(lv, coords0))
    return float(torch.linalg.norm(delta, dim=-1).mean())


@torch.no_grad()
def update_step(net: DroidNet, cap: dict, before: dict,
                images_u8: torch.Tensor, K: np.ndarray, cfg: dict,
                right_u8: Optional[torch.Tensor] = None) -> dict:
    """One iteration of an update round from the carry the program held
    before it (poses, inverse depths, damping, GRU hidden states, flows,
    weights) and the round's plan, with features, contexts and
    correlation pyramids recomputed from the frames: projective
    transform, lookup, update operator.  ``images_u8``: the pre-made
    frames on the device, indexed by the keyframes' frame ids.  With a
    rig pose ``cfg["stereo_rel"]``, the live (i, i) edges are stereo
    edges: they correlate the left features of i with the right
    features of i (from ``right_u8``, the right views) and project
    through the rig pose.  Returns the flow targets and weights after
    it."""
    dev = images_u8.device
    p = dba.DBAPlan(**cap["plan"])
    c = {k: v.float() for k, v in before.items()}
    ea = c["hidden"].shape[0]
    B = cap["timestamps"].shape[0]
    frame = cap["timestamps"].round().long()
    # every slot the plan's live edges read, encoded once
    slots = torch.unique(torch.cat([p.ii[:ea], p.jj[:ea]]))
    f_s, _, inp_s = encode(net, images_u8[frame[slots]])
    C = f_s.shape[-1]
    h, w = f_s.shape[1:3]
    feat = torch.zeros((B, h, w, C), device=dev)
    ctx = torch.zeros((B, h, w, C), device=dev)
    feat[slots], ctx[slots] = f_s, inp_s
    intr = intrinsics(K, B, cfg, dev)
    on = (p.edge_valid[:ea] > 0)[:, None, None, None]
    ii, jj = p.ii[:ea], p.jj[:ea]
    rig = cfg.get("stereo_rel")
    f_j = feat[jj]
    if rig is not None:
        stereo = on[:, 0, 0, 0] & (ii == jj)
        s_slots = torch.unique(ii[stereo])
        if s_slots.numel():
            feat_r = torch.zeros_like(feat)
            feat_r[s_slots] = net.features(_normalize(
                right_u8[frame[s_slots]]))
            f_j = torch.where(stereo[:, None, None, None], feat_r[jj], f_j)
    coords1, _, _ = camera.projective_transform(c["poses"], c["disps"], intr,
                                                ii, jj, stereo_rel=rig)
    coords0 = camera.coords_grid(h, w, device=dev)
    motion = torch.cat([coords1 - coords0, c["flow"] - coords1],
                       -1).clamp(-64.0, 64.0)
    cvals = lookup(pyramid(feat[ii], f_j), coords1) * on
    _, delta, weight = net.update(c["hidden"], None, cvals, motion,
                                  gates_inp=net.update_precompute(ctx[ii]))
    return {"flow": torch.where(on, coords1 + delta, c["flow"]),
            "flow_w": torch.where(on, weight, c["flow_w"])}


def intrinsics(K: np.ndarray, B: int, cfg: dict, dev) -> torch.Tensor:
    """The frames' pinhole at feature resolution, for every slot."""
    return torch.as_tensor(np.asarray(K, np.float32) / cfg["dsf"],
                           device=dev).repeat(B, 1)


def sensed_idepths(cap: dict, depths: Optional[torch.Tensor], cfg: dict
                   ) -> torch.Tensor:
    """The round's sensed inverse depths, (K, h, w) by depth slot, from
    the frames' z-depths ``depths`` (n, H, W) by the tracker's stated
    rule: the pixel at dsf // 2 + dsf * i of each dsf x dsf block, 1 / d
    where d > 1e-3, else 0.  Zeros where the rig senses no depth."""
    p = dba.DBAPlan(**cap["plan"])
    if depths is None:
        hw = cap["steps"][0][0]["disps"].shape[1:]
        return torch.zeros((p.kx.shape[0],) + tuple(hw), device=p.kx.device)
    s = cfg["dsf"]
    frame = cap["timestamps"].round().long()
    d = depths[frame[p.kx]][:, s // 2::s, s // 2::s]
    return torch.where(d > 1e-3, 1.0 / d.clamp(min=1e-3),
                       torch.zeros_like(d))


@torch.no_grad()
def dba_step(cap: dict, before: dict, after: dict, K: np.ndarray,
             cfg: dict, sensed: torch.Tensor, lower: bool = False) -> dict:
    """The iteration's dense BA from the poses and inverse depths before
    it, on the flow targets, weights and damping the program's update
    operator left (its own outputs, so this stage is judged alone), with
    the sensed inverse depths ``sensed`` (:func:`sensed_idepths`) and the
    rig pose ``cfg["stereo_rel"]``.  ``lower``: the control, with the
    targets, weights, damping and sensed depths rounded to bfloat16 and
    the products in TF32."""
    p = dba.DBAPlan(**cap["plan"])
    B = cap["timestamps"].shape[0]
    dev = before["poses"].device
    targets = torch.cat([after["flow"].float(), cap["in_flow"].float()])
    weights = torch.cat([after["flow_w"].float(),
                         cap["in_weight"].float()])
    eta_k = cfg["damping_scale"] * after["damping"].float()[p.kx] \
        + cfg["damping_offset"]
    sensed = sensed.float()
    if lower:
        targets, weights, eta_k, sensed = (
            bf16(targets), bf16(weights), bf16(eta_k), bf16(sensed))
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = lower
    try:
        poses, disps = dba.dba_iterations(
            before["poses"].float(), before["disps"].float(),
            intrinsics(K, B, cfg, dev), targets, weights, eta_k, sensed, p,
            iters=cfg["gn_iters"], ep=cfg["ep"], lm=cfg["lm"],
            stereo_rel=cfg.get("stereo_rel"))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return {"poses": poses, "disps": disps}


def flow_gap(cap: dict, prog: dict, ref: dict, stereo: bool = False
             ) -> float:
    """Median over the live edges' pixels of the distance (pixels)
    between two flow targets.  A median, because a few pixels that
    project far outside the frame amplify any rounding.  ``stereo``: the
    median of the stereo (i, i) edges and that of the others, the worse
    (the stereo edges are a minority that one median would outvote)."""
    p = dba.DBAPlan(**cap["plan"])
    ea = prog["flow"].shape[0]
    on = p.edge_valid[:ea] > 0
    gap = (prog["flow"].float() - ref["flow"].float()).norm(dim=-1)
    kinds = [on]
    if stereo:
        same = p.ii[:ea] == p.jj[:ea]
        kinds = [k for k in (on & ~same, on & same) if k.any()]
    return max(float(gap[k].median()) for k in kinds)


def disp_gap(cap: dict, prog: dict, ref: dict) -> float:
    """Median over the depth slots' pixels of |program - reference| /
    |reference| of the inverse depths."""
    p = dba.DBAPlan(**cap["plan"])
    kx = p.kx[p.k_valid > 0]
    r = ref["disps"][kx].float()
    return float(((prog["disps"][kx].float() - r).abs()
                  / r.abs().clamp(min=1e-6)).median())
