"""The maps' plain reference: a NeRF training step of the hash-grid field
(rendering, loss, gradient, Adam), the packet ingest into the NeRF
training set, and a TSDF integration of a packet.

Float32 with TF32 off, from frozen copies of the algorithm (``ngp``,
``hashgrid``, ``se3`` beside this file).  The controls: ``quant`` rounds
each dense layer's input and weight (the field computes in bfloat16, so
the control is float8 e4m3); ``dtype=torch.bfloat16`` runs the float32
ingest and integration one precision lower.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from . import se3
from .hashgrid import HashGridConfig
from .ngp import (Dense, NGPConfig, NGPField, render_rays,
                  sample_along_rays)


def srgb_to_linear(img: torch.Tensor) -> torch.Tensor:
    return torch.where(img <= 0.04045, img / 12.92,
                       ((img + 0.055) / 1.055) ** 2.4)


def ngp_config(m: dict) -> NGPConfig:
    return NGPConfig(encoding=m["encoding"], grid=HashGridConfig(**m["grid"]),
                     hidden=m["hidden"], n_uniform=m["n_uniform"],
                     n_depth=m["n_depth"], rgb_weight=m["rgb_weight"],
                     depth_weight=m["depth_weight"], lr=m["lr"])


def ngp_step(m: dict, before: dict, train_set: Dict[str, torch.Tensor],
             batch, quant: Optional[Callable] = None, half: bool = False):
    """One training step of the hash-grid field from the state it started
    from (``before``: parameters, Adam's moments and step count by
    parameter name) on one batch's draws (pixels of the training set's
    views, stratified and depth-guided samples): the rays rendered, the
    loss (colour; depth weighted by the inverse variance, after the
    opacity's normalization; opacity), its gradient and Adam's step at
    the configuration's rate, betas and epsilon.  ``half``: the loss over
    the first half of the rendered rays only (a planted fault).

    Returns {"grad": {name: gradient}, "change": {name: the parameter's
    change}}."""
    cfg = ngp_config(m)
    params = before["params"]
    field = NGPField(cfg, compute_dtype=torch.float32)
    field.load_state_dict({k: v.float() for k, v in params.items()})
    for mod in field.modules():
        if isinstance(mod, Dense):
            mod.quant = quant
    field = field.to(params["table"].device)
    img_idx, uv, samples = batch
    ts = train_set
    H, W = ts["images"].shape[1:3]
    xi = torch.round(uv[:, 0] * (W - 1)).long()
    yi = torch.round(uv[:, 1] * (H - 1)).long()
    fx, fy, cx, cy = ts["intrinsics"][img_idx].unbind(-1)
    dirs_cam = torch.stack([(xi + 0.5 - cx) / fx, (yi + 0.5 - cy) / fy,
                            torch.ones_like(fx)], dim=-1)
    tgt_rgb = ts["images"][img_idx, yi, xi]
    tgt_depth = ts["depths"][img_idx, yi, xi]
    tgt_cov = ts["depths_cov"][img_idx, yi, xi]
    d_valid = (tgt_depth > 0).float()
    c2w = ts["c2w"][img_idx]
    dirs = torch.einsum("rij,rj->ri", c2w[:, :3, :3], dirs_cam)
    t = sample_along_rays(tgt_depth, d_valid, cfg, samples)
    with torch.enable_grad():
        rgb, depth, acc, _ = render_rays(field, cfg, c2w[:, :3, 3], dirs, t)
        if half:
            n = rgb.shape[0] // 2
            rgb, depth, acc, tgt_rgb, tgt_depth, tgt_cov, d_valid = (
                x[:n] for x in (rgb, depth, acc, tgt_rgb, tgt_depth,
                                tgt_cov, d_valid))
        l_rgb = ((rgb - tgt_rgb) ** 2).mean()
        depth = depth / torch.clamp(acc, min=0.25)
        w = d_valid / (tgt_cov / (m["scene_scale"] ** 2) + 1e-2)
        nv = torch.clamp(d_valid.sum(), min=1.0)
        l_d = (w * (depth - tgt_depth) ** 2).sum() / nv
        l_acc = (d_valid * (1.0 - acc) ** 2).sum() / nv
        loss = cfg.rgb_weight * l_rgb + cfg.depth_weight * (l_d + l_acc)
        names = [k for k, _ in field.named_parameters()]
        grads = torch.autograd.grad(loss, [p for _, p in
                                           field.named_parameters()])
    b1, b2, eps, lr = m["adam_b1"], m["adam_b2"], m["adam_eps"], m["lr"]
    change = {}
    for k, g in zip(names, grads):
        m0 = before["exp_avg"].get(k, torch.zeros_like(g)).float()
        v0 = before["exp_avg_sq"].get(k, torch.zeros_like(g)).float()
        step = float(before["step"].get(k, torch.tensor(0.0))) + 1.0
        m1 = b1 * m0 + (1.0 - b1) * g
        v1 = b2 * v0 + (1.0 - b2) * g * g
        change[k] = -lr * (m1 / (1.0 - b1 ** step)) / (
            torch.sqrt(v1 / (1.0 - b2 ** step)) + eps)
    return {"grad": dict(zip(names, grads)), "change": change}


def program_change(before: dict, after: dict) -> Dict[str, torch.Tensor]:
    """Each parameter's change over the program's step."""
    return {k: p1.float() - before["params"][k].float()
            for k, p1 in after["params"].items()}


def moved_leaves(grad: Dict[str, torch.Tensor]) -> list:
    """The leaves whose reference gradient is not nought to rounding: at
    least a thousandth of the median leaf's norm (a leaf below it moves
    under Adam by round-off alone)."""
    norms = {k: float(torch.linalg.norm(g.float())) for k, g in grad.items()}
    med = float(torch.tensor(list(norms.values())).median())
    return [k for k, v in norms.items() if v >= 1e-3 * med]


def change_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
               leaves) -> float:
    """||program - reference|| / ||reference|| of the parameters' change,
    over the given leaves taken together."""
    num = sum(float(torch.linalg.norm(prog[k].float() - ref[k].float())) ** 2
              for k in leaves)
    den = sum(float(torch.linalg.norm(ref[k].float())) ** 2 for k in leaves)
    return (num / max(den, 1e-60)) ** 0.5


@torch.no_grad()
def ingest_rows(packet: dict, scale: float, offset,
                dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """The training-set rows a packet's views become: c2w in the
    normalized scene, linear RGB, normalized z-depth (-1 where none), its
    variance, the intrinsics at full resolution."""
    n = int(packet["viz_count"])
    packet = {k: packet[k][:n] for k in ("cam0_poses", "cam0_idepths_up",
                                         "cam0_images", "cam0_depths_cov_up",
                                         "cam0_intrinsics")}
    poses = packet["cam0_poses"].to(dtype)
    c2w = se3.matrix(se3.inv(poses.float())).to(dtype)
    c2w[:, :3, 3] = c2w[:, :3, 3] * scale + torch.tensor(
        offset, dtype=dtype, device=c2w.device)
    idepth = packet["cam0_idepths_up"].to(dtype)
    depth = torch.where(idepth > 1e-6, 1.0 / torch.clamp(idepth, min=1e-6),
                        -1.0)
    return {"c2w": c2w,
            "images": srgb_to_linear(packet["cam0_images"].to(dtype)
                                     / 255.0),
            "depths": torch.where(depth > 0, depth * scale, -1.0),
            "depths_cov": packet["cam0_depths_cov_up"].to(dtype)
            * (scale * scale),
            "intrinsics": packet["cam0_intrinsics"].to(dtype) * 8.0}


def rows_gap(prog: Dict[str, torch.Tensor],
             ref: Dict[str, torch.Tensor]) -> float:
    """Largest |program - reference| of any entry, relative to the largest
    |reference| of its kind."""
    return max(float((prog[k].float() - ref[k].float()).abs().max())
               / max(float(ref[k].float().abs().max()), 1e-30)
               for k in ref)


@torch.no_grad()
def tsdf_integrate(volume, packet: dict, m: dict, sigma_thresh: float,
                   dtype=torch.float32):
    """Integrate every view of ``packet`` into a copy of ``volume``
    ([tsdf, weight, color (3, G, G, G)]): per voxel, project into the
    view, read the depth at the rounded pixel, weight 1/sigma (0 above the
    threshold), truncate and average; weights saturate."""
    G, extent = m["grid_size"], m["volume_extent"]
    origin, trunc_vox = m["volume_origin"], m["sdf_trunc_voxels"]
    max_depth, max_weight = m["max_depth"], m["max_weight"]
    vs = extent / G
    trunc = trunc_vox * vs
    tsdf, weight, color = (v.to(dtype).clone() for v in volume)
    dev = tsdf.device
    n = int(packet["viz_count"])
    w2c = se3.matrix(packet["cam0_poses"][:n].float()).to(dtype)
    idepth = packet["cam0_idepths_up"][:n].to(dtype)
    depths = torch.where(idepth > 1e-6, 1.0 / torch.clamp(idepth, min=1e-6),
                         torch.zeros_like(idepth))
    cov = packet["cam0_depths_cov_up"][:n].to(dtype)
    colors = packet["cam0_images"][:n].to(dtype) / 255.0
    intr = packet["cam0_intrinsics"][:n].to(dtype) * 8.0
    ax = torch.arange(G, dtype=dtype, device=dev)
    X = (origin[0] + (ax + 0.5) * vs)[:, None, None]
    Y = (origin[1] + (ax + 0.5) * vs)[None, :, None]
    Z = (origin[2] + (ax + 0.5) * vs)[None, None, :]
    for i in range(n):
        H, W = depths.shape[1:]
        R, t = w2c[i, :3, :3], w2c[i, :3, 3]
        cx_ = R[0, 0] * X + R[0, 1] * Y + R[0, 2] * Z + t[0]
        cy_ = R[1, 0] * X + R[1, 1] * Y + R[1, 2] * Z + t[1]
        d = R[2, 0] * X + R[2, 1] * Y + R[2, 2] * Z + t[2]
        fx, fy, cx, cy = intr[i]
        u = torch.round(fx * cx_ / d + cx).long()
        v = torch.round(fy * cy_ / d + cy).long()
        in_img = (d > 0) & (u >= 0) & (v >= 0) & (u < W) & (v < H)
        idx = v.clamp(0, H - 1) * W + u.clamp(0, W - 1)
        reading = depths[i].reshape(-1)[idx]
        sig = torch.sqrt(torch.clamp(cov[i], min=0))
        wgt = torch.where(sig > sigma_thresh, torch.zeros_like(sig),
                          1.0 / torch.sqrt(torch.clamp(cov[i], min=1e-12)))
        wr = wgt.reshape(-1)[idx]
        col = colors[i].reshape(-1, 3)[idx]
        sdf = reading - d
        inlier = in_img & (reading > 0) & (reading < max_depth) \
            & (sdf >= -trunc)
        sdf = torch.clamp(sdf, max=trunc) / trunc
        wr = torch.where(inlier, wr, torch.zeros_like(wr))
        wp = weight + wr
        wp_safe = torch.clamp(wp, min=1e-8)
        keep = wr > 0
        tsdf = torch.where(keep, (weight * tsdf + wr * sdf) / wp_safe, tsdf)
        color = torch.stack([torch.where(
            keep, (weight * color[c] + wr * col[..., c]) / wp_safe, color[c])
            for c in range(3)])
        weight = torch.where(keep, torch.clamp(wp, max=max_weight), weight)
    return [tsdf, weight, color]


def volume_gap(before, prog, ref) -> float:
    """How far the program's integration lies from the reference's,
    relative to the reference's own change: the largest over the tsdf,
    the weights and the colours of ||program - reference|| / ||reference
    - before|| (a voxel whose depth pixel rounds the other way counts by
    its size, not as a failure of the whole volume)."""
    out = 0.0
    for b, p, r in zip(before, prog, ref):
        step = torch.linalg.norm(r.float() - b.float())
        gap = torch.linalg.norm(p.float() - r.float())
        out = max(out, float(gap / step.clamp(min=1e-30)))
    return out
