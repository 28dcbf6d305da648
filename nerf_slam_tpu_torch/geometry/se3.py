"""SE(3) / SO(3) on quaternion+translation 7-vectors (PyTorch).

Conventions (identical to DROID / lietorch and the JAX package):
  - a pose is ``[tx, ty, tz, qx, qy, qz, qw]`` (xyzw quaternion);
  - ``act``: ``Y = R @ X + t`` (homogeneous variant for [x, y, z, d]);
  - tangent vectors are ``[v(3), w(3)]``, translation first;
  - ``retr(g, xi) = exp(xi) * g`` (left retraction).

Every function broadcasts over leading batch dims and is meant for fp32.
"""
from __future__ import annotations

import torch


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product q1 * q2, xyzw convention."""
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 + y1 * w2 + z1 * x2 - x1 * z2,
        w1 * z2 + z1 * w2 + x1 * y2 - y1 * x2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ], dim=-1)


def quat_inv(q: torch.Tensor) -> torch.Tensor:
    """Conjugate (the inverse of a unit quaternion)."""
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def quat_act(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Rotate 3-vectors x by unit quaternions q: uv = 2 q_v x x;
    y = x + q_w uv + q_v x uv."""
    qv = q[..., :3]
    qw = q[..., 3:4]
    uv = 2.0 * _cross(qv, x)
    return x + qw * uv + _cross(qv, uv)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> 3x3 rotation matrix."""
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def matrix_to_quat(m: torch.Tensor) -> torch.Tensor:
    """3x3 rotation matrix -> unit quaternion (xyzw): the candidate built
    around the largest squared component, normalized."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    qw2 = 1.0 + m00 + m11 + m22
    qx2 = 1.0 + m00 - m11 - m22
    qy2 = 1.0 - m00 + m11 - m22
    qz2 = 1.0 - m00 - m11 + m22
    cands = torch.stack([
        torch.stack([m21 - m12, m02 - m20, m10 - m01, qw2], dim=-1),
        torch.stack([qx2, m01 + m10, m02 + m20, m21 - m12], dim=-1),
        torch.stack([m01 + m10, qy2, m12 + m21, m02 - m20], dim=-1),
        torch.stack([m02 + m20, m12 + m21, qz2, m10 - m01], dim=-1),
    ], dim=-2)                                       # (..., 4 cand, 4)
    best = torch.stack([qw2, qx2, qy2, qz2], dim=-1).argmax(dim=-1)
    q = torch.gather(cands, -2, best[..., None, None].expand(
        best.shape + (1, 4))).squeeze(-2)
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def identity(shape=(), dtype=torch.float32, device=None) -> torch.Tensor:
    out = torch.zeros(tuple(shape) + (7,), dtype=dtype, device=device)
    out[..., 6] = 1.0
    return out


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Compose: (a * b) acts as a(b(x))."""
    ta, qa = a[..., :3], a[..., 3:7]
    tb, qb = b[..., :3], b[..., 3:7]
    return torch.cat([ta + quat_act(qa, tb), quat_mul(qa, qb)], dim=-1)


def inv(g: torch.Tensor) -> torch.Tensor:
    t, q = g[..., :3], g[..., 3:7]
    qi = quat_inv(q)
    return torch.cat([-quat_act(qi, t), qi], dim=-1)


def act(g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Apply to 3-points: R x + t."""
    return quat_act(g[..., 3:7], x) + g[..., :3]


def act4(g: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Apply to homogeneous [x, y, z, d] points: Y[:3] = R X[:3] + d t,
    Y[3] = d."""
    x3 = quat_act(g[..., 3:7], X[..., :3]) + X[..., 3:4] * g[..., :3]
    return torch.cat([x3, X[..., 3:4]], dim=-1)


def relpose(gi: torch.Tensor, gj: torch.Tensor) -> torch.Tensor:
    """Gij = gj * gi^{-1}."""
    return mul(gj, inv(gi))


def matrix(g: torch.Tensor) -> torch.Tensor:
    """Pose 7-vector -> 4x4 homogeneous matrix."""
    R = quat_to_matrix(g[..., 3:7])
    top = torch.cat([R, g[..., :3, None]], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def from_matrix(m: torch.Tensor) -> torch.Tensor:
    return torch.cat([m[..., :3, 3], matrix_to_quat(m[..., :3, :3])], dim=-1)


def exp_so3(phi: torch.Tensor) -> torch.Tensor:
    """so(3) -> unit quaternion, with DROID's small-angle series."""
    theta_sq = (phi * phi).sum(-1, keepdim=True)
    theta_p4 = theta_sq * theta_sq
    small = theta_sq < 1e-8
    imag_small = 0.5 - (1.0 / 48.0) * theta_sq + (1.0 / 3840.0) * theta_p4
    real_small = 1.0 - (1.0 / 8.0) * theta_sq + (1.0 / 384.0) * theta_p4
    theta = torch.sqrt(torch.where(small, torch.ones_like(theta_sq),
                                   theta_sq))
    imag = torch.where(small, imag_small, torch.sin(0.5 * theta) / theta)
    real = torch.where(small, real_small, torch.cos(0.5 * theta))
    return torch.cat([imag * phi, real], dim=-1)


def exp(xi: torch.Tensor) -> torch.Tensor:
    """se(3) tangent [v, w] -> pose 7-vector."""
    tau, phi = xi[..., :3], xi[..., 3:6]
    q = exp_so3(phi)
    theta_sq = (phi * phi).sum(-1, keepdim=True)
    small = theta_sq < 1e-8
    th_sq = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    th = torch.sqrt(th_sq)
    a = torch.where(small, 0.5 - theta_sq / 24.0, (1.0 - torch.cos(th)) / th_sq)
    b = torch.where(small, 1.0 / 6.0 - theta_sq / 120.0,
                    (th - torch.sin(th)) / (th * th_sq))
    c1 = _cross(phi, tau)
    c2 = _cross(phi, c1)
    return torch.cat([tau + a * c1 + b * c2, q], dim=-1)


def log_so3(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> so(3) vector (principal branch)."""
    sign = torch.where(q[..., 3:4] < 0, -1.0, 1.0)
    qv = q[..., :3] * sign
    qw = q[..., 3:4] * sign
    n_sq = (qv * qv).sum(-1, keepdim=True)
    small = n_sq < 1e-16
    n = torch.sqrt(torch.where(small, torch.ones_like(n_sq), n_sq))
    angle = 2.0 * torch.atan2(n, qw)
    scale = torch.where(small, 2.0 / torch.clamp(qw, min=1e-8), angle / n)
    return scale * qv


def log(g: torch.Tensor) -> torch.Tensor:
    """Pose -> se(3) tangent [v, w] (inverse of exp)."""
    t = g[..., :3]
    phi = log_so3(g[..., 3:7])
    theta_sq = (phi * phi).sum(-1, keepdim=True)
    small = theta_sq < 1e-8
    th_sq = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    half = 0.5 * torch.sqrt(th_sq)
    cot_term = half * torch.cos(half) / torch.sin(half)
    e = torch.where(small, 1.0 / 12.0 + theta_sq / 720.0,
                    (1.0 - cot_term) / th_sq)
    c1 = _cross(phi, t)
    c2 = _cross(phi, c1)
    return torch.cat([t - 0.5 * c1 + e * c2, phi], dim=-1)


def retr(g: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """Left retraction exp(xi) * g."""
    return mul(exp(xi), g)


def skew(v: torch.Tensor) -> torch.Tensor:
    x, y, z = v.unbind(-1)
    o = torch.zeros_like(x)
    m = torch.stack([o, -z, y, z, o, -x, -y, x, o], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def adj_matrix(g: torch.Tensor) -> torch.Tensor:
    """6x6 adjoint on [v, w] tangents: [[R, [t]x R], [0, R]]."""
    R = quat_to_matrix(g[..., 3:7])
    top = torch.cat([R, skew(g[..., :3]) @ R], dim=-1)
    bot = torch.cat([torch.zeros_like(R), R], dim=-1)
    return torch.cat([top, bot], dim=-2)


def adjT_apply(g: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    """row @ Adj(g) for a (..., 6) row covector [v_part, w_part]."""
    t, q = g[..., :3], g[..., 3:7]
    qi = quat_inv(q)
    a = quat_act(qi, row[..., :3])
    b = quat_act(qi, row[..., 3:6]) + quat_act(qi, _cross(row[..., :3], t))
    return torch.cat([a, b], dim=-1)


def normalize(g: torch.Tensor) -> torch.Tensor:
    q = g[..., 3:7]
    return torch.cat([g[..., :3], q / torch.linalg.norm(q, dim=-1,
                                                        keepdim=True)], -1)
