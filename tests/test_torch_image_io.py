"""The port's image reader and resizers (``datasets/image_io.py``) against
OpenCV, which the JAX package's loaders call: PNGs of every supported type
round-trip through the port's codec and read back as OpenCV reads them,
every row filter decodes, and ``resize_area`` / ``resize_nearest`` give
OpenCV's ``INTER_AREA`` / ``INTER_NEAREST`` results.

Tolerances: the codec and nearest resizes are exact; ``resize_area`` on
uint8 images within 1 gray level (OpenCV sums in float or fixed point in
an order of its own; the share of pixels that differ is printed)."""
import struct
import zlib

import numpy as np
import pytest

from nerf_slam_tpu_torch.datasets import image_io as io

cv2 = pytest.importorskip("cv2")

# (shape, dtype) of every PNG type the codec writes and reads
PNG_TYPES = [((12, 17), np.uint8), ((12, 17, 2), np.uint8),
             ((12, 17, 3), np.uint8), ((12, 17, 4), np.uint8),
             ((12, 17), np.uint16), ((12, 17, 3), np.uint16),
             ((9, 5, 4), np.uint16)]


def _image(shape, dtype, seed=0):
    rng = np.random.RandomState(seed)
    top = 256 if dtype == np.uint8 else 65536
    noise = rng.randint(0, top, shape)
    ramp = (np.arange(shape[0])[:, None] * 7 + np.arange(shape[1]) * 3)
    ramp = ramp.reshape(ramp.shape + (1,) * (len(shape) - 2))
    # noise on the top half, a smooth ramp below: the encoders pick
    # different filters for the two
    rows = (np.arange(shape[0]) < shape[0] // 2).reshape(
        (-1,) + (1,) * (len(shape) - 1))
    return np.where(rows, noise, ramp % top).astype(dtype)


def _bgr(img):
    """RGB(A) -> OpenCV's BGR(A) channel order."""
    if img.ndim == 3 and img.shape[2] >= 3:
        return img[..., [2, 1, 0] + list(range(3, img.shape[2]))]
    return img


@pytest.mark.parametrize("shape,dtype", PNG_TYPES)
def test_png_round_trip(tmp_path, shape, dtype):
    img = _image(shape, dtype)
    path = str(tmp_path / "x.png")
    io.write_png(path, img)
    back = io.read_png(path)
    assert back.dtype == dtype and back.shape == img.shape
    np.testing.assert_array_equal(back, img)
    # OpenCV reads the port's file as it wrote it (2-channel PNGs it
    # expands, so only the others are compared)
    if img.ndim == 2 or img.shape[2] != 2:
        np.testing.assert_array_equal(
            _bgr(cv2.imread(path, cv2.IMREAD_UNCHANGED)), img)


@pytest.mark.parametrize("shape,dtype", [t for t in PNG_TYPES
                                         if len(t[0]) == 2
                                         or t[0][2] != 2])
@pytest.mark.parametrize("strategy", [0, 1, 3])
def test_png_written_by_opencv_reads_to_the_bit(tmp_path, shape, dtype,
                                                strategy):
    img = _image(shape, dtype, seed=1)
    path = str(tmp_path / "cv.png")
    assert cv2.imwrite(path, _bgr(img), [cv2.IMWRITE_PNG_STRATEGY, strategy])
    back = io.read_png(path)
    assert back.dtype == dtype
    np.testing.assert_array_equal(back, img)


def _encode_rows(img: np.ndarray, ftypes) -> bytes:
    """Filter each row of an 8-bit image with the given PNG filter type,
    straight from the specification (one byte at a time)."""
    h, w = img.shape[:2]
    bpp = 1 if img.ndim == 2 else img.shape[2]
    rows = img.reshape(h, -1).astype(np.int64)
    out = []
    for y in range(h):
        ft = ftypes[y % len(ftypes)]
        line = [ft]
        for x in range(w * bpp):
            a = rows[y, x - bpp] if x >= bpp else 0
            b = rows[y - 1, x] if y > 0 else 0
            c = rows[y - 1, x - bpp] if (y > 0 and x >= bpp) else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            paeth = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
            pred = [0, a, b, (a + b) // 2, paeth][ft]
            line.append((rows[y, x] - pred) % 256)
        out.extend(line)
    return bytes(out)


def _png_bytes(ihdr: tuple, raw: bytes) -> bytes:
    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", *ihdr))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("ftypes", [[0], [1], [2], [3], [4], [0, 1, 2, 3, 4],
                                    [4, 3, 2, 1, 0]])
def test_png_every_row_filter(tmp_path, ftypes):
    img = np.random.RandomState(2).randint(0, 256, (11, 9, 3)).astype(
        np.uint8)
    path = tmp_path / "f.png"
    path.write_bytes(_png_bytes((9, 11, 8, 2, 0, 0, 0),
                                _encode_rows(img, ftypes)))
    np.testing.assert_array_equal(io.read_png(str(path)), img)
    np.testing.assert_array_equal(
        cv2.imread(str(path), cv2.IMREAD_UNCHANGED)[..., ::-1], img)


@pytest.mark.parametrize("ihdr,word", [((4, 4, 8, 3, 0, 0, 0), "palette"),
                                       ((4, 4, 8, 2, 0, 0, 1), "interlaced"),
                                       ((4, 4, 4, 0, 0, 0, 0), "bit depth")])
def test_png_refuses_what_it_does_not_decode(tmp_path, ihdr, word):
    path = tmp_path / "r.png"
    path.write_bytes(_png_bytes(ihdr, b"\0" * 64))
    with pytest.raises(ValueError, match=word):
        io.read_png(str(path))


@pytest.mark.parametrize("shape,dtype", [((12, 17), np.uint8),
                                         ((12, 17, 3), np.uint8),
                                         ((12, 17, 4), np.uint8),
                                         ((12, 17), np.uint16),
                                         ((12, 17, 3), np.uint16)])
def test_imread_modes_match_opencv(tmp_path, shape, dtype):
    """IMREAD_UNCHANGED / COLOR / GRAYSCALE, in RGB order where OpenCV
    gives BGR; libpng's gray conversion for GRAYSCALE."""
    img = _image(shape, dtype, seed=3)
    path = str(tmp_path / "m.png")
    cv2.imwrite(path, _bgr(img))
    for mode in (io.IMREAD_UNCHANGED, io.IMREAD_COLOR):
        np.testing.assert_array_equal(io.imread(path, mode),
                                      _bgr(cv2.imread(path, mode)))
    np.testing.assert_array_equal(io.imread(path, io.IMREAD_GRAYSCALE),
                                  cv2.imread(path, cv2.IMREAD_GRAYSCALE))


RESIZES = [((480, 640), (384, 512)), ((480, 752), (336, 640)),
           ((48, 64), (24, 32)), ((48, 64), (16, 16)), ((48, 64), (40, 56)),
           ((48, 64), (50, 70)), ((48, 64), (96, 128)), ((48, 64), (40, 80))]


@pytest.mark.parametrize("src,dst", RESIZES)
@pytest.mark.parametrize("channels", [None, 3])
def test_resize_area_matches_opencv(src, dst, channels):
    rng = np.random.RandomState(4)
    img = rng.randint(0, 256, src + ((channels,) if channels else ())
                      ).astype(np.uint8)
    want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_AREA)
    got = io.resize_area(img, *dst)
    assert got.shape == want.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    print(f"INTER_AREA {src}->{dst} c={channels}: max |diff| {diff.max()}, "
          f"{100 * (diff > 0).mean():.3f}% of pixels differ")
    assert diff.max() <= 1


@pytest.mark.parametrize("src,dst", RESIZES)
def test_resize_nearest_matches_opencv(src, dst):
    rng = np.random.RandomState(5)
    img = rng.randint(0, 256, src + (3,)).astype(np.uint8)
    np.testing.assert_array_equal(
        io.resize_nearest(img, *dst),
        cv2.resize(img, dst[::-1], interpolation=cv2.INTER_NEAREST))
    depth = rng.rand(*src).astype(np.float32) * 5
    np.testing.assert_array_equal(
        io.resize_nearest(depth, *dst),
        cv2.resize(depth, dst[::-1], interpolation=cv2.INTER_NEAREST))
