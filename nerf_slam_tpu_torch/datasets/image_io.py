"""Image file reading and resizing for the dataset loaders (numpy).

The JAX package's loaders read and resize every frame with OpenCV
(``cv2.imread``, ``cv2.resize`` with ``INTER_AREA`` and ``INTER_NEAREST``);
the port runs where OpenCV may be absent, so this module holds its own:

- a PNG codec on the standard library's ``zlib``: 8- and 16-bit gray,
  gray + alpha, RGB and RGBA, every row filter, non-interlaced images
  (palettes, bit depths below 8 and interlaced images raise a
  ``ValueError`` that names them);
- ``imread`` in ``cv2.imread``'s modes, returning RGB (not OpenCV's BGR:
  the loaders convert to RGB right after reading, so the packets are the
  same);
- ``resize_area`` and ``resize_nearest``, computed as OpenCV computes
  ``INTER_AREA`` and ``INTER_NEAREST``.

JPEG is not decoded here: ``read_jpeg_rgb`` hands it to OpenCV or Pillow,
whichever imports, and raises ``ImportError`` naming both when neither
does.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> channels (3, the palette, is refused)
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
_COLOR_NAMES = {0: "gray", 2: "RGB", 3: "palette", 4: "gray+alpha",
                6: "RGBA"}

IMREAD_UNCHANGED, IMREAD_GRAYSCALE, IMREAD_COLOR = -1, 0, 1


# ----------------------------------------------------------------------
# PNG
# ----------------------------------------------------------------------

def _chunks(data: bytes, path: str):
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0]
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"{path}: CRC mismatch in chunk {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError(f"{path}: truncated PNG (no IEND chunk)")


def _unfilter(raw: np.ndarray, height: int, stride: int, bpp: int
              ) -> np.ndarray:
    """Undo the per-row filters of a decompressed image: (height,
    stride) bytes.  A reconstructed byte depends on the byte ``bpp`` to
    its left (a), the one above (b) and the one above-left (c), so the
    pixels are reconstructed one anti-diagonal at a time, every pixel of a
    diagonal in one vectorized step.  In the skewed layout ``S[d, y]`` =
    pixel (y, d - y) a diagonal is a row, and a, b, c are slices of the two
    rows before it; row and column 0 of ``S`` stay 0 (outside the image)."""
    rows = raw.reshape(height, stride + 1)
    ftype = rows[:, 0].astype(np.int64)
    if ftype.max(initial=0) > 4:
        raise ValueError(f"PNG row filter type {int(ftype.max())} is not "
                         f"one of the five defined")
    filt = rows[:, 1:].reshape(height, -1, bpp)
    width = filt.shape[1]
    if not (ftype != 0).any():
        return np.ascontiguousarray(rows[:, 1:])
    ys, xs = np.mgrid[:height, :width]
    S = np.zeros((height + width + 1, height + 1, bpp), np.int16)
    F = np.zeros_like(S)
    F[(ys + xs + 2).ravel(), (ys + 1).ravel()] = filt.reshape(-1, bpp)
    kind = np.zeros((height + 1, 1), np.int64)
    kind[1:, 0] = ftype
    is_sub, is_up, is_avg, is_paeth = (kind == t for t in (1, 2, 3, 4))
    for d in range(2, height + width + 1):
        lo, hi = max(1, d - width), min(height, d - 1) + 1
        a = S[d - 1, lo:hi]
        b = S[d - 1, lo - 1:hi - 1]
        c = S[d - 2, lo - 1:hi - 1]
        sl = slice(lo, hi)
        pred = np.where(is_sub[sl], a, 0) + np.where(is_up[sl], b, 0) \
            + np.where(is_avg[sl], (a + b) >> 1, 0)
        if is_paeth[sl].any():
            pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
            paeth = np.where((pa <= pb) & (pa <= pc), a,
                             np.where(pb <= pc, b, c))
            pred = pred + np.where(is_paeth[sl], paeth, 0)
        S[d, lo:hi] = (F[d, lo:hi] + pred) & 0xFF
    out = S[(ys + xs + 2), (ys + 1)]
    return out.astype(np.uint8).reshape(height, stride)


def read_png(path: str) -> np.ndarray:
    """A PNG file as stored: (H, W) for gray, (H, W, C) otherwise, uint8
    or uint16 (big-endian samples made native), channels in file order
    (RGB, RGBA, gray + alpha)."""
    with open(path, "rb") as f:
        data = f.read()
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, color, _, _, interlace = header
    if color not in _CHANNELS:
        raise ValueError(f"{path}: {_COLOR_NAMES.get(color, color)} PNGs "
                         f"(colour type {color}) are not supported")
    if depth not in (8, 16):
        raise ValueError(f"{path}: bit depth {depth} is not supported "
                         f"(8 or 16)")
    if interlace:
        raise ValueError(f"{path}: interlaced (Adam7) PNGs are not "
                         f"supported")
    ch = _CHANNELS[color]
    bpp = ch * depth // 8
    stride = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (stride + 1):
        raise ValueError(f"{path}: {raw.size} bytes of image data, expected "
                         f"{height * (stride + 1)}")
    img = _unfilter(raw, height, stride, bpp)
    if depth == 16:
        img = img.view(">u2").astype(np.uint16)
    img = img.reshape(height, width, ch)
    return img[..., 0] if ch == 1 else img


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def write_png(path: str, img: np.ndarray) -> None:
    """Write (H, W) gray, (H, W, 2) gray + alpha, (H, W, 3) RGB or (H, W, 4)
    RGBA, uint8 or uint16, with the Up filter on every row."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"PNG samples must be uint8 or uint16, not "
                         f"{img.dtype}")
    ch = 1 if img.ndim == 2 else img.shape[2]
    color = {1: 0, 2: 4, 3: 2, 4: 6}.get(ch)
    if color is None or img.ndim not in (2, 3):
        raise ValueError(f"cannot write a PNG of shape {img.shape}")
    height, width = img.shape[:2]
    depth = 8 * img.dtype.itemsize
    rows = np.ascontiguousarray(img.astype(img.dtype.newbyteorder(">"))
                                ).view(np.uint8).reshape(height, -1)
    up = rows.copy()
    up[1:] = rows[1:] - rows[:-1]             # mod 256: filter 2 (Up)
    raw = np.concatenate([np.full((height, 1), 2, np.uint8), up], 1)
    ihdr = struct.pack(">IIBBBBB", width, height, depth, color, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + _chunk(b"IEND", b""))


def _to_gray(rgb: np.ndarray) -> np.ndarray:
    """libpng's RGB -> gray, which ``cv2.imread(..., IMREAD_GRAYSCALE)``
    applies while decoding: 0.299 R + 0.587 G + 0.114 B in 15-bit fixed
    point, truncated for 8-bit samples and rounded for 16-bit ones."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    acc = r * 9797 + g * 19234 + b * 3737
    if rgb.dtype == np.uint16:
        return ((acc + (1 << 14)) >> 15).astype(np.uint16)
    return (acc >> 15).astype(np.uint8)


def imread(path: str, mode: int = IMREAD_COLOR) -> np.ndarray:
    """A PNG as ``cv2.imread(path, mode)`` reads it, but in RGB order:
    ``IMREAD_UNCHANGED`` as stored (RGB/RGBA, 8 or 16 bits),
    ``IMREAD_COLOR`` 8-bit RGB (gray replicated, alpha dropped),
    ``IMREAD_GRAYSCALE`` 8-bit gray; 16-bit samples keep their high
    byte."""
    img = read_png(path)
    if mode == IMREAD_UNCHANGED:
        return img
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[2] in (1, 2):               # gray (+ alpha)
        out = img[..., 0]
        if mode != IMREAD_GRAYSCALE:
            out = np.repeat(out[..., None], 3, -1)
    else:
        out = np.ascontiguousarray(img[..., :3])
        if mode == IMREAD_GRAYSCALE:
            out = _to_gray(out)
    if out.dtype == np.uint16:
        out = (out >> 8).astype(np.uint8)
    return out


def read_jpeg_rgb(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB of a JPEG file, decoded by OpenCV or else by
    Pillow; ``ImportError`` naming both when neither is installed."""
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(path)
        return np.ascontiguousarray(img[..., ::-1])
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("decoding JPEG frames needs OpenCV (cv2) or "
                          "Pillow (PIL); neither is installed") from e
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), np.uint8).copy()


def jpeg_decoder_available() -> bool:
    """Whether ``read_jpeg_rgb`` can decode (OpenCV or Pillow imports)."""
    for name in ("cv2", "PIL"):
        try:
            __import__(name)
            return True
        except ImportError:
            pass
    return False


# ----------------------------------------------------------------------
# resizing, as OpenCV computes INTER_AREA and INTER_NEAREST
# ----------------------------------------------------------------------

def _area_weights(src: int, dst: int, scale: float) -> np.ndarray:
    """(dst, src) float32 coverage weights of OpenCV's
    ``computeResizeAreaTab``: each output cell spans ``scale`` source
    pixels; partial pixels at its ends weigh their covered fraction, all
    divided by the cell's width."""
    w = np.zeros((dst, src), np.float64)
    for dx in range(dst):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, src - fsx1)
        sx1, sx2 = int(np.ceil(fsx1)), int(np.floor(fsx2))
        sx2 = min(sx2, src - 1)
        sx1 = min(sx1, sx2)
        if sx1 - fsx1 > 1e-3:
            w[dx, sx1 - 1] = np.float32((sx1 - fsx1) / cell)
        for sx in range(sx1, sx2):
            w[dx, sx] = np.float32(1.0 / cell)
        if fsx2 - sx2 > 1e-3:
            w[dx, sx2] = np.float32(min(min(fsx2 - sx2, 1.0), cell) / cell)
    return w


def _linear_area_weights(src: int, dst: int, scale: float) -> np.ndarray:
    """(dst, src) weights of OpenCV's ``INTER_AREA`` when it enlarges:
    two taps, the right one weighted by the part of the output cell past
    the source pixel's edge (``fx = (dx + 1) - (sx + 1) / scale``)."""
    w = np.zeros((dst, src), np.float64)
    inv = 1.0 / scale
    for dx in range(dst):
        sx = int(np.floor(dx * scale))
        fx = (dx + 1) - (sx + 1) * inv
        fx = 0.0 if fx <= 0 else fx - np.floor(fx)
        if sx >= src - 1:
            sx, fx = src - 1, 0.0
        fx = float(np.float32(fx))
        w[dx, sx] += 1.0 - fx
        if fx:
            w[dx, sx + 1] += fx
    return w


def _round_like(out: np.ndarray, dtype) -> np.ndarray:
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        return np.clip(np.rint(out), info.min, info.max).astype(dtype)
    return out.astype(dtype)


def resize_area(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """``cv2.resize(img, (width, height), interpolation=cv2.INTER_AREA)``
    for (H, W) or (H, W, C) images.  Shrinking by an integer factor on
    both axes averages the blocks; other shrinks weigh each source pixel
    by the share of the output cell it covers; enlarging interpolates
    linearly with OpenCV's area offsets.  Integer samples are rounded
    to nearest (OpenCV's 2x2 average rounds halves up)."""
    img = np.asarray(img)
    H, W = img.shape[:2]
    if (H, W) == (height, width):
        return img.copy()
    sx, sy = W / width, H / height
    ix, iy = int(round(sx)), int(round(sy))
    if (sx >= 1 and sy >= 1 and ix == sx and iy == sy
            and np.issubdtype(img.dtype, np.integer)):
        blocks = img[:height * iy, :width * ix].astype(np.int64).reshape(
            (height, iy, width, ix) + img.shape[2:])
        total = blocks.sum(axis=(1, 3))
        area = ix * iy
        if area == 4:
            return ((total + 2) >> 2).astype(img.dtype)
        return _round_like(total * np.float32(1.0 / area), img.dtype)
    # coverage weights only when neither axis grows; else both axes take
    # the linear scheme, as in OpenCV
    fx, fy = 1.0 / (width / W), 1.0 / (height / H)
    weights = (_area_weights if fx >= 1 and fy >= 1
               else _linear_area_weights)
    wy, wx = weights(H, height, fy), weights(W, width, fx)
    out = np.tensordot(wy, img.astype(np.float64), axes=(1, 0))
    out = np.moveaxis(np.tensordot(wx, out, axes=(1, 1)), 0, 1)
    return _round_like(out, img.dtype)


def resize_nearest(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """``cv2.resize(img, (width, height), interpolation=cv2.INTER_NEAREST)``:
    output pixel x reads source ``floor(x * (1 / (width / W)))``, clamped,
    in double precision as OpenCV computes it."""
    img = np.asarray(img)
    H, W = img.shape[:2]
    ifx = 1.0 / (width / W)
    ify = 1.0 / (height / H)
    xs = np.minimum(np.floor(np.arange(width) * ifx).astype(np.int64), W - 1)
    ys = np.minimum(np.floor(np.arange(height) * ify).astype(np.int64),
                    H - 1)
    return img[ys][:, xs]
