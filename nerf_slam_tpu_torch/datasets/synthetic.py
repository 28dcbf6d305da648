"""Procedural synthetic RGB-D dataset (a textured box room).

Stands in for Replica-style data in environments without datasets: exact
GT poses and depths, analytic rendering, enough texture for
correlation-based tracking.  Emits NeRF-SLAM's packet contract
(datasets/nerf_dataset.py:155-162):
``{k, t_cams, poses, images, depths, calibs, is_last_frame}`` with poses
as world_T_cam (camera-to-world) 4x4 matrices, OpenCV camera convention
(+z forward, +x right, +y down).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


@dataclass
class SyntheticConfig:
    n_frames: int = 60
    height: int = 120
    width: int = 160
    fov_deg: float = 70.0
    room_half: float = 2.0        # half-extent of the cubic room [m]
    room_height: float = 2.5
    orbit_radius: float = 0.8
    seed: int = 0
    # None: a full orbit spread over n_frames (legacy).  Set to a few
    # degrees for realistic inter-frame motion (real indoor sequences
    # move ~1-5 deg/frame; the full-orbit default gives 360/n_frames).
    deg_per_frame: Optional[float] = None
    start_deg: float = 0.0
    # stereo: also render a rectified right camera offset `baseline`
    # metres along +x of the camera frame; packets gain
    # ``images_right`` (reference datasets/euroc_dataset.py:37-62)
    stereo: bool = False
    baseline: float = 0.1
    # imu: simulate a body-mounted IMU by differentiating the continuous
    # orbit trajectory; packets gain ``imu_t0_t1`` rows in the EuRoC
    # layout (N, 7) [t_ns, wx, wy, wz, ax, ay, az] covering
    # (t_{k-1}, t_k] (reference datasets/euroc_dataset.py:164-199)
    imu: bool = False
    imu_rate_hz: float = 200.0
    fps: float = 30.0
    gravity: tuple = (0.0, 0.0, -9.81)
    # interior objects (spheres + boxes) for parallax / occlusion /
    # depth discontinuities; 0 keeps the legacy empty room (and
    # bit-identical renders for existing tests and the bench sequence)
    n_objects: int = 0
    # vertical bob amplitude and look-target jitter of the orbit
    # trajectory (training diversity; defaults match the legacy orbit)
    bob_amp: float = 0.2
    target_jitter: float = 0.0


def _texture(p: np.ndarray, normal_axis: int,
             ph=(1.7, 0.5, 2.9, 0.0)) -> np.ndarray:
    """Smooth but feature-rich RGB texture as a function of 3D position.
    ``ph``: per-scene phase offsets so different seeds see different
    rooms (otherwise every "scene" shares one texture)."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    r = 0.5 + 0.25 * np.sin(3.1 * x + ph[0]) * np.cos(2.3 * y + ph[3])
    g = 0.5 + 0.25 * np.sin(2.7 * y + ph[1]) * np.cos(3.7 * z + ph[3])
    b = 0.5 + 0.25 * np.sin(4.1 * z + ph[2]) * np.cos(1.9 * x + ph[3])
    # checker layer for high-frequency gradients
    c = (np.floor(2.5 * x + ph[3]) + np.floor(2.5 * y)
         + np.floor(2.5 * z)) % 2
    shade = 0.85 + 0.15 * (normal_axis / 2.0)
    rgb = np.stack([r + 0.15 * c, g + 0.12 * c, b + 0.1 * c], axis=-1)
    return np.clip(rgb * shade[..., None], 0.0, 1.0)


def _render(c2w: np.ndarray, K: np.ndarray, h: int, w: int,
            half: float, room_h: float, ph=(1.7, 0.5, 2.9, 0.0),
            objects=()):
    """Ray-cast the interior of an axis-aligned box; returns (rgb, depth).

    Box: x,y in [-half, half], z in [0, room_h] (world frame).
    Camera: OpenCV convention, rays r = R @ K^-1 [u,v,1].
    ``objects``: optional interior primitives -- dicts
    {"type": "sphere", "c": (3,), "r": float, "ph": 4-tuple} or
    {"type": "box", "lo": (3,), "hi": (3,), "ph": 4-tuple} -- ray-cast
    with occlusion against the room and each other (training-curriculum
    parallax; empty tuple reproduces the legacy room bit-exactly).
    """
    u, v = np.meshgrid(np.arange(w) + 0.5, np.arange(h) + 0.5)
    fx, fy, cx, cy = K
    dirs_cam = np.stack([(u - cx) / fx, (v - cy) / fy, np.ones_like(u)],
                        axis=-1)
    R = c2w[:3, :3]
    t = c2w[:3, 3]
    dirs = dirs_cam @ R.T
    # intersection with the 6 planes
    lo = np.array([-half, -half, 0.0])
    hi = np.array([half, half, room_h])
    tmax = np.full((h, w), np.inf)
    hit_axis = np.zeros((h, w), dtype=np.int64)
    hit_obj = np.full((h, w), -1, dtype=np.int64)   # -1: room wall
    for ax in range(3):
        for bound in (lo[ax], hi[ax]):
            d = dirs[..., ax]
            with np.errstate(divide="ignore", invalid="ignore"):
                s = (bound - t[ax]) / d
            s = np.where(np.abs(d) < 1e-9, np.inf, s)
            p = t[None, None, :] + s[..., None] * dirs
            ok = (s > 1e-6)
            for other in range(3):
                if other != ax:
                    ok &= (p[..., other] >= lo[other] - 1e-6) & \
                          (p[..., other] <= hi[other] + 1e-6)
            better = ok & (s < tmax)
            tmax = np.where(better, s, tmax)
            hit_axis = np.where(better, ax, hit_axis)

    for oi, ob in enumerate(objects):
        if ob["type"] == "sphere":
            oc = np.asarray(ob["c"]) - t
            b = np.sum(dirs * oc[None, None, :], axis=-1)
            d2 = np.sum(dirs * dirs, axis=-1)
            disc = b * b - d2 * (np.dot(oc, oc) - ob["r"] ** 2)
            with np.errstate(invalid="ignore", divide="ignore"):
                s = (b - np.sqrt(np.maximum(disc, 0.0))) / d2
            ok = (disc > 0) & (s > 1e-6)
            better = ok & (s < tmax)
            if better.any():
                pn = t[None, None, :] + s[..., None] * dirs \
                    - np.asarray(ob["c"])
                nax = np.argmax(np.abs(pn), axis=-1)
                tmax = np.where(better, s, tmax)
                hit_axis = np.where(better, nax, hit_axis)
                hit_obj = np.where(better, oi, hit_obj)
        else:  # axis-aligned box, exterior hit via the slab method
            blo, bhi = np.asarray(ob["lo"]), np.asarray(ob["hi"])
            with np.errstate(divide="ignore", invalid="ignore"):
                inv = 1.0 / dirs
            t1 = (blo[None, None, :] - t) * inv
            t2 = (bhi[None, None, :] - t) * inv
            tn = np.min(np.stack([t1, t2]), axis=0)
            tf = np.max(np.stack([t1, t2]), axis=0)
            s_in = np.max(tn, axis=-1)
            s_out = np.min(tf, axis=-1)
            nax = np.argmax(tn, axis=-1)
            ok = (s_in < s_out) & (s_in > 1e-6)
            better = ok & (s_in < tmax)
            if better.any():
                tmax = np.where(better, s_in, tmax)
                hit_axis = np.where(better, nax, hit_axis)
                hit_obj = np.where(better, oi, hit_obj)

    pts = t[None, None, :] + tmax[..., None] * dirs
    rgb = _texture(pts, hit_axis, ph)
    for oi, ob in enumerate(objects):
        m = hit_obj == oi
        if m.any():
            rgb = np.where(m[..., None],
                           _texture(pts, hit_axis, ob["ph"]), rgb)
    # rays are parameterized with unit z-component in the camera frame, so
    # the parameter s IS the camera z-depth
    return (rgb * 255).astype(np.uint8), tmax.astype(np.float32)


def look_at(eye: np.ndarray, target: np.ndarray,
            up=np.array([0.0, 0.0, 1.0])) -> np.ndarray:
    """OpenCV c2w: z toward target, y down-ish."""
    z = target - eye
    z = z / np.linalg.norm(z)
    x = np.cross(z, up)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    c2w = np.eye(4)
    c2w[:3, 0] = x
    c2w[:3, 1] = y
    c2w[:3, 2] = z
    c2w[:3, 3] = eye
    return c2w


class SyntheticDataset:
    """Index- and stream-style access, mirroring datasets/dataset.py."""

    def __init__(self, cfg: Optional[SyntheticConfig] = None):
        self.cfg = cfg or SyntheticConfig()
        c = self.cfg
        f = 0.5 * c.width / np.tan(np.radians(c.fov_deg) / 2)
        self.K = np.array([f, f, c.width / 2, c.height / 2],
                          dtype=np.float32)
        rng = np.random.RandomState(c.seed)
        self.tex_phases = tuple(rng.uniform(0, 2 * np.pi, 4)) \
            if c.seed else (1.7, 0.5, 2.9, 0.0)
        self.objects = self._make_objects(rng)
        # smooth look-target jitter (sinusoids -> analytic, so the IMU
        # simulation's central differences stay exact)
        self.jit_ph = rng.uniform(0, 2 * np.pi, 6)
        self.poses = self._trajectory()

    def _make_objects(self, rng):
        c = self.cfg
        objs = []
        for _ in range(c.n_objects):
            ph = tuple(rng.uniform(0, 2 * np.pi, 4))
            # keep object centers away from the camera orbit annulus
            for _try in range(50):
                r_c = rng.uniform(0.0, c.room_half - 0.3)
                if abs(r_c - c.orbit_radius) > 0.45:
                    break
            ang = rng.uniform(0, 2 * np.pi)
            z = rng.uniform(0.3, c.room_height - 0.3)
            ctr = np.array([r_c * np.cos(ang), r_c * np.sin(ang), z])
            if rng.rand() < 0.5:
                objs.append({"type": "sphere", "c": ctr,
                             "r": rng.uniform(0.12, 0.35), "ph": ph})
            else:
                he = rng.uniform(0.1, 0.3, 3)
                objs.append({"type": "box", "lo": ctr - he,
                             "hi": ctr + he, "ph": ph})
        return objs

    def _pose_at(self, fi: float) -> np.ndarray:
        """c2w at continuous frame index ``fi`` (the orbit is analytic,
        so the same formula serves rendering and IMU simulation)."""
        c = self.cfg
        if c.deg_per_frame is not None:
            a = np.radians(c.start_deg + fi * c.deg_per_frame)
        else:
            a = 2 * np.pi * fi / c.n_frames
        eye = np.array([c.orbit_radius * np.cos(a),
                        c.orbit_radius * np.sin(a),
                        0.5 * c.room_height + c.bob_amp * np.sin(2 * a)])
        j = c.target_jitter
        p = self.jit_ph if j else np.zeros(6)
        target = np.array([
            2.0 * np.cos(a + 0.7) + j * np.sin(2.3 * a + p[0]),
            2.0 * np.sin(a + 0.7) + j * np.sin(3.1 * a + p[1]),
            0.5 * c.room_height + j * np.sin(2.7 * a + p[2])])
        return look_at(eye, target)

    def _trajectory(self):
        return np.stack([self._pose_at(float(i))
                         for i in range(self.cfg.n_frames)])

    def _log_so3(self, R: np.ndarray) -> np.ndarray:
        ct = np.clip((np.trace(R) - 1) / 2, -1.0, 1.0)
        th = np.arccos(ct)
        if th < 1e-9:
            return 0.5 * np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                                   R[1, 0] - R[0, 1]])
        return th / (2 * np.sin(th)) * np.array(
            [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])

    def simulate_imu(self, t0: float, t1: float) -> np.ndarray:
        """Perfect-IMU rows over (t0, t1]: gyro = body angular rate,
        accel = specific force R^T (a_world - g), both from central
        differences of the analytic trajectory."""
        c = self.cfg
        n = max(2, int(round((t1 - t0) * c.imu_rate_hz)) + 1)
        ts = np.linspace(t0, t1, n)
        eps = 1e-4  # seconds, for central differences
        g = np.asarray(c.gravity)
        rows = np.zeros((n, 7))
        for r, t in enumerate(ts):
            fi = t * c.fps
            dfi = eps * c.fps
            Pm = self._pose_at(fi - dfi)
            P0 = self._pose_at(fi)
            Pp = self._pose_at(fi + dfi)
            R0 = P0[:3, :3]
            w_body = self._log_so3(Pm[:3, :3].T @ Pp[:3, :3]) / (2 * eps)
            a_world = (Pp[:3, 3] - 2 * P0[:3, 3] + Pm[:3, 3]) / eps ** 2
            a_body = R0.T @ (a_world - g)
            rows[r] = [t * 1e9, *w_body, *a_body]
        return rows

    def __len__(self):
        return self.cfg.n_frames

    def __getitem__(self, k: int) -> Dict:
        c = self.cfg
        rgb, depth = _render(self.poses[k], self.K, c.height, c.width,
                             c.room_half, c.room_height,
                             self.tex_phases, self.objects)
        out = {
            "k": k,
            "t_cams": float(k) / c.fps,
            "poses": self.poses[k].astype(np.float32),
            "images": rgb,
            "depths": depth,
            "intrinsics": self.K.copy(),
            "is_last_frame": k == c.n_frames - 1,
        }
        if c.imu and k > 0:
            out["imu_t0_t1"] = self.simulate_imu((k - 1) / c.fps,
                                                 k / c.fps)
        if c.stereo:
            c2w_r = self.poses[k].copy()
            # right camera: +baseline along the camera x axis
            c2w_r[:3, 3] = c2w_r[:3, 3] + c2w_r[:3, 0] * c.baseline
            rgb_r, _ = _render(c2w_r, self.K, c.height, c.width,
                               c.room_half, c.room_height,
                               self.tex_phases, self.objects)
            out["images_right"] = rgb_r
            # cam1_T_cam0 7-vec [t, q]: pure translation -baseline in x
            out["stereo_rel"] = np.array(
                [-c.baseline, 0, 0, 0, 0, 0, 1], np.float32)
        return out

    def velocity_at(self, t: float) -> np.ndarray:
        """World-frame velocity of the analytic trajectory (for seeding
        a VIO NavState)."""
        eps = 1e-4
        fps = self.cfg.fps
        return (self._pose_at((t + eps) * fps)[:3, 3]
                - self._pose_at((t - eps) * fps)[:3, 3]) / (2 * eps)

    def __iter__(self) -> Iterator[Dict]:
        for k in range(len(self)):
            yield self[k]
