"""Trajectory and reconstruction evaluation: ATE-RMSE with Umeyama
(Sim3/SE3) alignment, and ground-truth meshes (OBJ/PLY loading, depth
rendering on the device)."""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def umeyama_alignment(src: np.ndarray, dst: np.ndarray,
                      with_scale: bool = True
                      ) -> Tuple[np.ndarray, np.ndarray, float]:
    """Least-squares similarity transform with dst ~ s * R @ src + t.
    src, dst: (N, 3).  Returns (R, t, s)."""
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    U, D, Vt = np.linalg.svd(xd.T @ xs / src.shape[0])
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = 1.0
    if with_scale:
        var_s = (xs ** 2).sum() / src.shape[0]
        # a degenerate (coincident) source leaves the scale unobservable:
        # keep s = 1 so ATE reports the honest, large error, not NaN
        if var_s > 1e-12:
            s = float(np.trace(np.diag(D) @ S) / var_s)
    return R, mu_d - s * R @ mu_s, s


def ate_rmse(est_positions: np.ndarray, gt_positions: np.ndarray,
             align_scale: bool = True) -> float:
    """Absolute trajectory error (RMSE, metres) after Sim3 alignment."""
    est = np.asarray(est_positions, np.float64)
    gt = np.asarray(gt_positions, np.float64)
    if est.shape != gt.shape or est.shape[1] != 3:
        raise ValueError(f"shapes {est.shape} and {gt.shape} differ")
    R, t, s = umeyama_alignment(est, gt, with_scale=align_scale)
    err = (s * (R @ est.T)).T + t - gt
    return float(np.sqrt((err ** 2).sum(axis=1).mean()))


def to_numpy(x) -> np.ndarray:
    """A host numpy array of a tensor (any device) or an array-like."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def _pose_to_c2w_translation(poses7: np.ndarray) -> np.ndarray:
    """Camera centres of cam_T_world 7-vectors [t, q_xyzw]: -R^T t."""
    t = poses7[:, :3].astype(np.float64)
    x, y, z, w = (poses7[:, 3 + i].astype(np.float64) for i in range(4))
    R = np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1).reshape(-1, 3, 3)
    return -np.einsum("nji,nj->ni", R, t)


def trajectory_from_packet(packet) -> Tuple[np.ndarray, np.ndarray]:
    """(est_positions, gt_positions) from a frontend viz packet."""
    poses = to_numpy(packet["cam0_poses"])
    n = int(packet.get("viz_count", poses.shape[0]))
    return (_pose_to_c2w_translation(poses[:n]),
            to_numpy(packet["gt_poses"])[:n, :3, 3])


# ----------------------------------------------------------------------
# ground-truth meshes: loading and depth rendering
# (NeRF-SLAM's utils/evaluation.py:7-68)
# ----------------------------------------------------------------------

def load_mesh(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """A triangle mesh: (verts (V, 3) f32, faces (F, 3) i32).

    OBJ (the mesher's output format) and ASCII or binary little-endian PLY
    (Replica's ground-truth meshes); polygons are fan-triangulated."""
    if path.endswith(".obj"):
        verts, faces = [], []
        with open(path) as f:
            for line in f:
                p = line.split()
                if not p:
                    continue
                if p[0] == "v":
                    verts.append([float(x) for x in p[1:4]])
                elif p[0] == "f":
                    idx = [int(t.split("/")[0]) - 1 for t in p[1:]]
                    for a in range(1, len(idx) - 1):
                        faces.append([idx[0], idx[a], idx[a + 1]])
        return (np.asarray(verts, np.float32),
                np.asarray(faces, np.int32).reshape(-1, 3))
    return _load_ply(path)


_PLY_TYPES = {"float": "f4", "float32": "f4", "double": "f8", "int": "i4",
              "int32": "i4", "uint": "u4", "uint32": "u4", "uchar": "u1",
              "uint8": "u1", "short": "i2", "ushort": "u2", "char": "i1"}


def _load_ply(path: str) -> Tuple[np.ndarray, np.ndarray]:
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elems = []           # [name, count, [(type, name) or list props]]
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: no end_header")
            line = line.split()
            if not line or line[0] == b"comment":
                continue
            if line[0] == b"format":
                fmt = line[1].decode()
            elif line[0] == b"element":
                elems.append([line[1].decode(), int(line[2]), []])
            elif line[0] == b"property":
                if line[1] == b"list":
                    elems[-1][2].append(("list", line[2].decode(),
                                         line[3].decode(),
                                         line[4].decode()))
                else:
                    elems[-1][2].append((line[1].decode(),
                                         line[2].decode()))
            elif line[0] == b"end_header":
                break
        verts = faces = None
        for name, count, props in elems:
            if fmt == "ascii":
                rows = [f.readline().split() for _ in range(count)]
                if name == "vertex":
                    verts = np.array(
                        [[float(r[k]) for k in range(3)] for r in rows],
                        np.float32).reshape(-1, 3)
                elif name == "face":
                    faces = _fan([[int(x) for x in r[1:1 + int(r[0])]]
                                  for r in rows])
            elif fmt == "binary_little_endian":
                if name == "vertex":
                    dt = np.dtype([(f"p{i}", "<" + _PLY_TYPES[t[0]])
                                   for i, t in enumerate(props)])
                    data = np.frombuffer(f.read(dt.itemsize * count),
                                         dtype=dt)
                    verts = np.stack([data["p0"], data["p1"],
                                      data["p2"]], -1).astype(np.float32)
                elif name == "face":
                    cdt = np.dtype("<" + _PLY_TYPES[props[0][1]])
                    idt = np.dtype("<" + _PLY_TYPES[props[0][2]])
                    polys = []
                    for _ in range(count):
                        n = int(np.frombuffer(f.read(cdt.itemsize),
                                              cdt)[0])
                        polys.append(np.frombuffer(
                            f.read(idt.itemsize * n), idt).tolist())
                    faces = _fan(polys)
            else:
                raise ValueError(f"unsupported PLY format {fmt}")
        if verts is None or faces is None:
            raise ValueError(f"{path}: missing vertex or face element")
        return verts, faces


def _fan(polys) -> np.ndarray:
    tris = []
    for p in polys:
        for a in range(1, len(p) - 1):
            tris.append([p[0], p[a], p[a + 1]])
    return np.asarray(tris, np.int32).reshape(-1, 3)


class MeshRenderer:
    """Render a mesh's z-depth at camera poses, on ``device``.

    Moller-Trumbore ray casting of blocks of ``px_chunk`` pixels against
    fixed-size slabs of ``tri_chunk`` triangles with a running minimum of
    the hit distance, as the JAX package's renderer scans its slabs (no
    BVH).  Rays leave pixel centres (+0.5) with unit z, so the distance
    along a ray is its z-depth; pixels that miss get 0.0."""

    def __init__(self, mesh, intrinsics, resolution,
                 tri_chunk: int = 4096, px_chunk: int = 4096,
                 device="cuda"):
        verts, faces = (load_mesh(mesh) if isinstance(mesh, str)
                        else mesh)
        self.device = torch.device(device)
        tris = np.asarray(verts, np.float32)[
            np.asarray(faces).reshape(-1)].reshape(-1, 3, 3)
        pad = (-len(tris)) % tri_chunk
        if pad:   # degenerate pad triangles never intersect
            tris = np.concatenate(
                [tris, np.zeros((pad, 3, 3), np.float32)], 0)
        self._slabs = torch.as_tensor(tris.reshape(-1, tri_chunk, 3, 3),
                                      device=self.device)
        self.fx, self.fy, self.cx, self.cy = [float(v) for v in intrinsics]
        self.w, self.h = int(resolution[0]), int(resolution[1])
        self.px_chunk = px_chunk

    @staticmethod
    def _cast(slabs: torch.Tensor, origin: torch.Tensor,
              dirs: torch.Tensor) -> torch.Tensor:
        """(P,) nearest hit distance of rays ``origin + t dirs`` (inf on a
        miss) over all slabs."""
        tmin = torch.full(dirs.shape[:1], float("inf"), device=dirs.device)
        o = origin[None, None, :]
        for tri in slabs:
            v0 = tri[:, 0]
            e1 = tri[:, 1] - v0
            e2 = tri[:, 2] - v0
            # (P, T, 3): P rays against T triangles
            pvec = torch.linalg.cross(dirs[:, None, :].expand(-1, len(tri),
                                                              -1),
                                      e2[None].expand(len(dirs), -1, -1))
            det = (pvec * e1[None]).sum(-1)
            ok = det.abs() > 1e-12
            inv = torch.where(ok, 1.0 / det, torch.zeros_like(det))
            tvec = o - v0[None]
            u = (tvec * pvec).sum(-1) * inv
            qvec = torch.linalg.cross(tvec.expand(len(dirs), -1, -1),
                                      e1[None].expand(len(dirs), -1, -1))
            v = (dirs[:, None, :] * qvec).sum(-1) * inv
            t = (e2[None] * qvec).sum(-1) * inv
            hit = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 1e-4)
            t = torch.where(hit, t, torch.full_like(t, float("inf")))
            tmin = torch.minimum(tmin, t.min(dim=1).values)
        return tmin

    @torch.no_grad()
    def render_mesh(self, c2w: np.ndarray) -> np.ndarray:
        """Depth image (h, w) float32 at a camera-to-world pose (+z
        forward); 0.0 where the mesh is missed."""
        c2w = np.asarray(c2w, np.float32)
        xs = (np.arange(self.w) + 0.5 - self.cx) / self.fx
        ys = (np.arange(self.h) + 0.5 - self.cy) / self.fy
        xx, yy = np.meshgrid(xs, ys)
        # unit-z camera dirs: t along the ray IS the z-depth
        d_cam = np.stack([xx, yy, np.ones_like(xx)], -1).reshape(-1, 3)
        dirs = torch.as_tensor((d_cam @ c2w[:3, :3].T).astype(np.float32),
                               device=self.device)
        origin = torch.as_tensor(c2w[:3, 3], device=self.device)
        out = torch.cat([self._cast(self._slabs, origin, blk)
                         for blk in dirs.split(self.px_chunk)])
        out = torch.where(torch.isfinite(out), out, torch.zeros_like(out))
        return out.reshape(self.h, self.w).cpu().numpy()
