"""Sensor files, undistortion and stereo rectification for EuRoC (numpy).

The JAX package's EuRoC loader reads its ``sensor.yaml`` files with PyYAML
and rectifies with OpenCV (``cv2.stereoRectify``,
``cv2.initUndistortRectifyMap``, ``cv2.remap``); the port runs where
neither may be installed, so this module computes the same things:

- ``load_sensor_yaml``: the YAML subset of the EuRoC sensor files;
- ``rodrigues`` and ``undistort_points``: OpenCV's rotation-vector
  conversion and iterative radial-tangential point undistortion;
- ``stereo_rectify``: Bouguet's rectification as ``cv2.stereoRectify``
  computes it with ``CALIB_ZERO_DISPARITY`` and ``alpha=0``;
- ``undistort_rectify_map``: ``cv2.initUndistortRectifyMap`` (float32
  maps, the radial-tangential model k1, k2, p1, p2);
- ``remap_bilinear``: ``cv2.remap(..., INTER_LINEAR)`` with zero borders
  for uint8 images, in OpenCV 5's float arithmetic (OpenCV 4's fixed
  point differs by at most 2 gray levels).
"""
from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

import numpy as np

# ----------------------------------------------------------------------
# sensor.yaml
# ----------------------------------------------------------------------

_KEY = re.compile(r"^([A-Za-z_][\w.-]*)\s*:\s*(.*)$")


def _strip_comment(line: str) -> str:
    """The line without a ``#`` comment (EuRoC values hold no quoted
    ``#``)."""
    i = line.find("#")
    return line if i < 0 else line[:i]


# YAML 1.1's plain-scalar types, as PyYAML's safe loader resolves them
# (decimal ints and floats; a float needs its dot, as in "2.0e-3")
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?$"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?$")
_BOOL = {"yes": True, "true": True, "on": True, "no": False, "false": False,
         "off": False}


def _scalar(text: str, where: str):
    t = text.strip()
    if not t:
        raise ValueError(f"{where}: empty value")
    if t[0] in "'\"":
        if len(t) < 2 or t[-1] != t[0]:
            raise ValueError(f"{where}: unterminated string {t!r}")
        return t[1:-1]
    if t in ("~", "null", "Null", "NULL"):
        return None
    if t.lower() in _BOOL and t in (t.lower(), t.capitalize(), t.upper()):
        return _BOOL[t.lower()]
    if _INT.match(t):
        return int(t.replace("_", ""))
    if _FLOAT.match(t):
        return float(t.replace("_", ""))
    if re.fullmatch(r"[-+]?\.(?:inf|Inf|INF)", t):
        return float("-inf") if t[0] == "-" else float("inf")
    if re.fullmatch(r"\.(?:nan|NaN|NAN)", t):
        return float("nan")
    if t[0] in "[]{}&*!|>%@`-?," or ": " in t:
        raise ValueError(f"{where}: unsupported YAML value {t!r}")
    return t


def _flow_list(text: str, where: str) -> list:
    inner = text.strip()[1:-1]
    if any(c in inner for c in "[]{}"):
        raise ValueError(f"{where}: nested flow collections are not "
                         f"supported")
    items = [p for p in (s.strip() for s in inner.split(","))]
    if items and items[-1] == "":
        items.pop()                           # a trailing comma
    return [_scalar(p, where) for p in items]


def load_sensor_yaml(path: str) -> Dict:
    """A EuRoC ``sensor.yaml`` as ``yaml.safe_load`` reads it.  The subset:
    an optional ``%YAML:1.0`` first line, ``#`` comments, ``key: scalar``,
    ``key: [a, b, ...]`` flow lists (which may wrap over lines), and one
    nested level (``T_BS:`` then indented ``rows``/``cols``/``data``).
    Anything else raises ``ValueError``."""
    with open(path) as f:
        text = f.read()
    return parse_sensor_yaml(text, path)


def parse_sensor_yaml(text: str, where: str = "<yaml>") -> Dict:
    lines = text.splitlines()
    if lines and lines[0].startswith("%YAML"):
        lines = lines[1:]
    out: Dict = {}
    parent: Optional[Dict] = None
    parent_indent = 0
    i = 0
    while i < len(lines):
        raw = _strip_comment(lines[i]).rstrip()
        i += 1
        if not raw.strip():
            continue
        if raw.strip() == "---":
            continue
        indent = len(raw) - len(raw.lstrip(" "))
        if "\t" in raw[:indent + 1]:
            raise ValueError(f"{where}:{i}: tab indentation")
        m = _KEY.match(raw.strip())
        if m is None:
            raise ValueError(f"{where}:{i}: not a 'key: value' line: "
                             f"{raw.strip()!r}")
        key, value = m.group(1), m.group(2).strip()
        if value.startswith("["):
            # a flow list may wrap: gather lines until the bracket closes
            while "]" not in value:
                if i >= len(lines):
                    raise ValueError(f"{where}: unterminated list for "
                                     f"{key!r}")
                value += " " + _strip_comment(lines[i]).strip()
                i += 1
            if not value.endswith("]"):
                raise ValueError(f"{where}:{i}: text after the list of "
                                 f"{key!r}")
            value = _flow_list(value, f"{where}:{i}")
        elif value:
            value = _scalar(value, f"{where}:{i}")
        if indent == 0:
            if value == "":
                parent, parent_indent = {}, None
                out[key] = parent
            else:
                parent = None
                out[key] = value
            continue
        if parent is None:
            raise ValueError(f"{where}:{i}: indented line outside a "
                             f"mapping: {raw.strip()!r}")
        if parent_indent is None:
            parent_indent = indent
        if indent != parent_indent or value == "":
            raise ValueError(f"{where}:{i}: only one nested level is "
                             f"supported")
        parent[key] = value
    for key, v in out.items():
        if isinstance(v, dict) and not v:
            out[key] = None                   # 'key:' with nothing under it
    return out


# ----------------------------------------------------------------------
# rotations and point undistortion (OpenCV's formulas)
# ----------------------------------------------------------------------

def rodrigues(x: np.ndarray) -> np.ndarray:
    """``cv2.Rodrigues``: a rotation vector (3,) -> matrix (3, 3), or a
    matrix -> vector (made orthonormal through its SVD first)."""
    x = np.asarray(x, np.float64)
    if x.size == 3:
        r = x.reshape(3)
        theta = float(np.sqrt(r @ r))
        if theta < np.finfo(np.float64).eps:
            return np.eye(3)
        c, s = np.cos(theta), np.sin(theta)
        r = r * (1.0 / theta)
        rx = np.array([[0, -r[2], r[1]], [r[2], 0, -r[0]],
                       [-r[1], r[0], 0]])
        return c * np.eye(3) + (1.0 - c) * np.outer(r, r) + s * rx
    U, _, Vt = np.linalg.svd(x.reshape(3, 3))
    R = U @ Vt
    r = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    s = np.sqrt((r @ r) * 0.25)
    c = np.clip((R[0, 0] + R[1, 1] + R[2, 2] - 1) * 0.5, -1.0, 1.0)
    theta = np.arccos(c)
    if s < 1e-5:
        if c > 0:
            return np.zeros(3)
        t = (R[0, 0] + 1) * 0.5
        r = np.array([np.sqrt(max(t, 0.0)), 0.0, 0.0])
        t = (R[1, 1] + 1) * 0.5
        r[1] = np.sqrt(max(t, 0.0)) * (-1.0 if R[0, 1] < 0 else 1.0)
        t = (R[2, 2] + 1) * 0.5
        r[2] = np.sqrt(max(t, 0.0)) * (-1.0 if R[0, 2] < 0 else 1.0)
        if (abs(r[0]) < abs(r[1]) and abs(r[0]) < abs(r[2])
                and (R[1, 2] > 0) != (r[1] * r[2] > 0)):
            r[2] = -r[2]
        return r * (theta / np.sqrt(r @ r))
    return r * (theta / (2 * s))


def _dist4(dist) -> np.ndarray:
    d = np.zeros(4) if dist is None else np.asarray(dist, np.float64)
    d = d.reshape(-1)
    if d.size > 4 and np.any(d[4:] != 0):
        raise ValueError("only the radial-tangential model (k1, k2, p1, "
                         "p2) is supported")
    return np.pad(d[:4], (0, 4 - min(4, d.size)))


def undistort_points(pts: np.ndarray, K: np.ndarray, dist,
                     R: Optional[np.ndarray] = None,
                     P: Optional[np.ndarray] = None) -> np.ndarray:
    """``cv2.undistortPoints`` on (N, 2) pixels: normalize, undo the
    distortion by 5 fixed-point steps (OpenCV's default count),
    rotate by R and project with P.  float64 points come back float64,
    others float32, as OpenCV returns them."""
    pts = np.asarray(pts)
    out_dtype = np.float64 if pts.dtype == np.float64 else np.float32
    pts = pts.astype(out_dtype).reshape(-1, 2).astype(np.float64)
    K = np.asarray(K, np.float64)
    k1, k2, p1, p2 = _dist4(dist)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    x = (pts[:, 0] - cx) * (1.0 / fx)
    y = (pts[:, 1] - cy) * (1.0 / fy)
    x0, y0 = x.copy(), y.copy()
    for _ in range(5):
        r2 = x * x + y * y
        icdist = 1.0 / (1 + (k2 * r2 + k1) * r2)
        bad = icdist < 0
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        x = np.where(bad, x, (x0 - dx) * icdist)
        y = np.where(bad, y, (y0 - dy) * icdist)
    RR = np.eye(3) if R is None else np.asarray(R, np.float64)
    if P is not None:
        RR = np.asarray(P, np.float64)[:3, :3] @ RR
    xx = RR[0, 0] * x + RR[0, 1] * y + RR[0, 2]
    yy = RR[1, 0] * x + RR[1, 1] * y + RR[1, 2]
    ww = 1.0 / (RR[2, 0] * x + RR[2, 1] * y + RR[2, 2])
    return np.stack([xx * ww, yy * ww], -1).astype(out_dtype)


def _inner_rectangle(K, dist, R, P, size: Tuple[int, int]):
    """OpenCV's ``getUndistortRectangles`` inner rectangle (x, y, w, h):
    the largest axis-aligned box inside a 9x9 grid of image points
    (corners at pixel 0 and size - 1, float64) after undistortion and
    rectification."""
    w, h = size
    n = 9
    xs = np.arange(n) * (w - 1) / (n - 1.0)
    ys = np.arange(n) * (h - 1) / (n - 1.0)
    grid = np.stack(np.meshgrid(xs, ys), -1).reshape(-1, 2)
    p = undistort_points(grid, K, dist, R, P).reshape(n, n, 2)
    px, py = p[..., 0], p[..., 1]
    x0, x1 = px[:, 0].max(), px[:, -1].min()
    y0, y1 = py[0].max(), py[-1].min()
    return x0, y0, x1 - x0, y1 - y0


def stereo_rectify(K0, d0, K1, d1, size: Tuple[int, int], R, T,
                   new_size: Optional[Tuple[int, int]] = None):
    """``cv2.stereoRectify(K0, d0, K1, d1, size, R, T,
    flags=cv2.CALIB_ZERO_DISPARITY, alpha=0, newImageSize=new_size)``:
    (R1, R2, P1, P2).  ``size``/``new_size`` are (width, height); R, T
    take camera 0's points into camera 1's frame.

    Bouguet's method: both cameras rotate half the relative rotation
    (``rodrigues(-om / 2)``), then one rotation aligns the baseline with
    the x (or y) axis; the new focal is the mean of the two cameras' focal
    across the baseline times the size ratio; the principal points centre
    the undistorted image corners, averaged over the cameras; last, the
    focal is scaled so the valid (inner) rectangles of both images fill
    the new size (``alpha=0``)."""
    K0, K1 = np.asarray(K0, np.float64), np.asarray(K1, np.float64)
    T = np.asarray(T, np.float64).reshape(3)
    w, h = size
    nw, nh = new_size if new_size and new_size[0] * new_size[1] else size
    om = rodrigues(R) if np.asarray(R).size == 9 else \
        np.asarray(R, np.float64).reshape(3)
    r_r = rodrigues(om * -0.5)
    t = r_r @ T
    idx = 0 if abs(t[0]) > abs(t[1]) else 1
    c = t[idx]
    nt = float(np.sqrt(t @ t))
    if not nt > 0:
        raise ValueError("stereo_rectify: zero baseline")
    uu = np.zeros(3)
    uu[idx] = 1.0 if c > 0 else -1.0
    ww = np.cross(t, uu)
    nw_ = float(np.sqrt(ww @ ww))
    if nw_ > 0:
        ww = ww * (np.arccos(abs(c) / nt) / nw_)
    wR = rodrigues(ww)
    R1 = wR @ r_r.T
    R2 = wR @ r_r
    t = R2 @ T

    ratio = (nw / w / 2) if idx == 1 else (nh / h / 2)
    fc_new = (K0[idx ^ 1, idx ^ 1] + K1[idx ^ 1, idx ^ 1]) * ratio
    corners = np.array([[0, 0], [w - 1, 0], [0, h - 1], [w - 1, h - 1]],
                       np.float32)
    cc = []
    for K, d, Rk in ((K0, d0, R1), (K1, d1, R2)):
        und = undistort_points(corners, K, d).astype(np.float64)
        X = np.concatenate([und, np.ones((4, 1))], 1).astype(np.float32)
        p = X.astype(np.float64) @ Rk.T
        proj = (fc_new * (p[:, :2] * (1.0 / p[:, 2:3]))).astype(np.float32)
        avg = proj.astype(np.float64).mean(0)
        cc.append([(w - 1) / 2 - avg[0], (h - 1) / 2 - avg[1]])
    cc = np.asarray(cc)
    cc[:] = (cc[0] + cc[1]) * 0.5             # CALIB_ZERO_DISPARITY

    P1 = np.zeros((3, 4))
    P1[0, 0] = P1[1, 1] = fc_new
    P1[:2, 2], P1[2, 2] = cc[0], 1.0
    P2 = P1.copy()
    P2[:2, 2] = cc[1]
    P2[idx, 3] = t[idx] * fc_new

    in0 = _inner_rectangle(K0, d0, R1, P1, size)
    in1 = _inner_rectangle(K1, d1, R2, P2, size)
    cx1_0, cy1_0 = cc[0]
    cx2_0, cy2_0 = cc[1]
    cx1, cy1 = nw * cx1_0 / w, nh * cy1_0 / h
    cx2, cy2 = nw * cx2_0 / w, nh * cy2_0 / h

    def inner_scale(rect, cx, cy, cx0, cy0):
        x, y, rw, rh = (float(v) for v in rect)
        return max(cx / (cx0 - x), cy / (cy0 - y),
                   (nw - 1 - cx) / (x + rw - cx0),
                   (nh - 1 - cy) / (y + rh - cy0))

    s = max(inner_scale(in1, cx2, cy2, cx2_0, cy2_0),
            inner_scale(in0, cx1, cy1, cx1_0, cy1_0))
    fc_new *= s
    for P, (cx, cy) in ((P1, (cx1, cy1)), (P2, (cx2, cy2))):
        P[0, 0] = P[1, 1] = fc_new
        P[0, 2], P[1, 2] = cx, cy
    P2[idx, 3] *= s
    return R1, R2, P1, P2


# ----------------------------------------------------------------------
# maps and remapping
# ----------------------------------------------------------------------

def undistort_rectify_map(K, dist, R, P, size: Tuple[int, int]
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """``cv2.initUndistortRectifyMap(K, dist, R, P, size, cv2.CV_32FC1)``:
    for each output pixel of ``size`` (width, height), the source pixel
    (float32 x map, y map).  Rays start at ``(P[:3, :3] @ R)^-1 [u, v,
    1]``, advanced along a row by repeated addition as OpenCV does, then
    distort (k1, k2, p1, p2) and project with K, in float64."""
    K = np.asarray(K, np.float64)
    k1, k2, p1, p2 = _dist4(dist)
    fx, fy, u0, v0 = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    Rm = np.eye(3) if R is None else np.asarray(R, np.float64)
    Pm = K if P is None else np.asarray(P, np.float64)[:3, :3]
    ir = np.linalg.inv(Pm @ Rm).reshape(-1)
    w, h = size
    i = np.arange(h, dtype=np.float64)[:, None]

    def along_row(c0, step):
        # OpenCV's `_x += ir[0]` walk: a running sum from the row start
        steps = np.concatenate([c0, np.broadcast_to(step, (h, w - 1))], 1)
        return np.cumsum(steps, axis=1)

    _x = along_row(i * ir[1] + ir[2], ir[0])
    _y = along_row(i * ir[4] + ir[5], ir[3])
    _w = along_row(i * ir[7] + ir[8], ir[6])
    ww = 1.0 / _w
    x, y = _x * ww, _y * ww
    x2, y2 = x * x, y * y
    r2 = x2 + y2
    _2xy = 2 * x * y
    kr = 1 + (k2 * r2 + k1) * r2
    u = fx * (x * kr + p1 * _2xy + p2 * (r2 + 2 * x2)) + u0
    v = fy * (y * kr + p1 * (r2 + 2 * y2) + p2 * _2xy) + v0
    return u.astype(np.float32), v.astype(np.float32)


def remap_bilinear(img: np.ndarray, map_x: np.ndarray, map_y: np.ndarray
                   ) -> np.ndarray:
    """``cv2.remap(img, map_x, map_y, cv2.INTER_LINEAR)`` for uint8 (H, W)
    or (H, W, C) images with the constant-0 border: float32 bilinear
    weights from the coordinates' fractions, taps outside the image read
    0, the sum rounded to nearest.  This is OpenCV 5's arithmetic for
    float maps; OpenCV 4 first rounds each coordinate to 1/32 pixel and
    weighs in 10-bit fixed point, which moves a pixel by at most 2 gray
    levels."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"remap_bilinear takes uint8 images, not "
                         f"{img.dtype}")
    H, W = img.shape[:2]
    f32 = np.float32
    mx, my = np.asarray(map_x, f32), np.asarray(map_y, f32)
    fx0, fy0 = np.floor(mx), np.floor(my)
    fx, fy = (mx - fx0)[..., None], (my - fy0)[..., None]
    x0, y0 = fx0.astype(np.int64), fy0.astype(np.int64)
    src = img.reshape(H, W, -1).astype(f32)

    def tap(dy, dx):
        yy, xx = y0 + dy, x0 + dx
        inside = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
        v = src[np.clip(yy, 0, H - 1), np.clip(xx, 0, W - 1)]
        return np.where(inside[..., None], v, f32(0))

    one = f32(1)
    top = (one - fx) * tap(0, 0) + fx * tap(0, 1)
    bot = (one - fx) * tap(1, 0) + fx * tap(1, 1)
    out = np.clip(np.rint((one - fy) * top + fy * bot), 0, 255)
    return out.astype(np.uint8).reshape(mx.shape + img.shape[2:])
