"""The port's EuRoC reading (``datasets/rectify.py``,
``datasets/euroc_dataset.py``) against what the JAX package's loader uses:
PyYAML for the sensor files, OpenCV for rectification and remapping, and
the JAX ``EurocDataset`` itself on the same directories.

Tolerances: ``load_sensor_yaml`` equals ``yaml.safe_load``; R1, R2, P1, P2
within 1e-6 relative of ``cv2.stereoRectify``; the maps within 1e-3 px of
``cv2.initUndistortRectifyMap``; remapped uint8 images within 2 gray
levels of ``cv2.remap`` (the share that differs is printed); packets:
images within 2 gray levels, ``stereo_rel`` and ground-truth poses within
1e-5, intrinsics within 1e-4 px, IMU rows equal."""
import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
yaml = pytest.importorskip("yaml")

from nerf_slam_tpu.datasets import SyntheticConfig, SyntheticDataset
from nerf_slam_tpu.datasets.euroc_dataset import EurocDataset as JEuroc
from nerf_slam_tpu_torch.datasets import rectify
from nerf_slam_tpu_torch.datasets.euroc_dataset import EurocDataset as TEuroc

H, W = 48, 64
N = 6
BASELINE = 0.1

# EuRoC's own cam0 / cam1 / imu0 sensor files (MH_01_easy), verbatim
EUROC_CAM0 = """%YAML:1.0
# General sensor definitions.
sensor_type: camera
comment: VI-Sensor cam0 (MT9M034)

# Sensor extrinsics wrt. the body-frame.
T_BS:
  cols: 4
  rows: 4
  data: [0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975,
         0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768,
        -0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949,
         0.0, 0.0, 0.0, 1.0]

# Camera specific definitions.
rate_hz: 20
resolution: [752, 480]
camera_model: pinhole
intrinsics: [458.654, 457.296, 367.215, 248.375] #fu, fv, cu, cv
distortion_model: radial-tangential
distortion_coefficients: [-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05]
"""
EUROC_CAM1 = """%YAML:1.0
# General sensor definitions.
sensor_type: camera
comment: VI-Sensor cam1 (MT9M034)

# Sensor extrinsics wrt. the body-frame.
T_BS:
  cols: 4
  rows: 4
  data: [0.0125552670891, -0.999755099723, 0.0182237714554, -0.0198435579556,
         0.999598781151, 0.0130119051815, 0.0251588363115, 0.0453689425024,
        -0.0253898008918, 0.0179005838253, 0.999517347078, 0.00786212447038,
         0.0, 0.0, 0.0, 1.0]

# Camera specific definitions.
rate_hz: 20
resolution: [752, 480]
camera_model: pinhole
intrinsics: [457.587, 456.134, 379.999, 255.238] #fu, fv, cu, cv
distortion_model: radial-tangential
distortion_coefficients: [-0.28368365,  0.07451284, -0.00010473, -3.55590700e-05]
"""
EUROC_IMU0 = """%YAML:1.0
#Default imu sensor yaml file
sensor_type: imu
comment: VI-Sensor IMU (ADIS16448)

# Sensor extrinsics wrt. the body-frame.
T_BS:
  cols: 4
  rows: 4
  data: [1.0, 0.0, 0.0, 0.0,
         0.0, 1.0, 0.0, 0.0,
         0.0, 0.0, 1.0, 0.0,
         0.0, 0.0, 0.0, 1.0]
rate_hz: 200

# inertial sensor noise model parameters (static)
gyroscope_noise_density: 1.6968e-04     # [ rad / s / sqrt(Hz) ]   ( gyro "white noise" )
gyroscope_random_walk: 1.9393e-05       # [ rad / s^2 / sqrt(Hz) ] ( gyro bias diffusion )
accelerometer_noise_density: 2.0000e-3  # [ m / s^2 / sqrt(Hz) ]   ( accel "white noise" )
accelerometer_random_walk: 3.0000e-3    # [ m / s^3 / sqrt(Hz) ].  ( accel bias diffusion )
"""


def _safe_load(text: str):
    """PyYAML on a sensor file, its %YAML directive removed as the JAX
    loader removes it."""
    return yaml.safe_load("\n".join(ln for ln in text.splitlines()
                                    if not ln.startswith("%YAML")))


@pytest.mark.parametrize("text", [EUROC_CAM0, EUROC_CAM1, EUROC_IMU0])
def test_sensor_yaml_matches_pyyaml(tmp_path, text):
    path = tmp_path / "sensor.yaml"
    path.write_text(text)
    assert rectify.load_sensor_yaml(str(path)) == _safe_load(text)


@pytest.mark.parametrize("text", [
    "a:\n  b:\n    c: 1\n",              # two nested levels
    "a:\n  - 1\n  - 2\n",                # a block sequence
    "a: [1, [2, 3]]\n",                  # a nested flow list
    "a: [1, 2\n",                        # an unterminated list
    "a: {b: 1}\n",                       # a flow mapping
    "just text\n"])
def test_sensor_yaml_refuses_the_rest(text):
    with pytest.raises(ValueError):
        rectify.parse_sensor_yaml(text)


def _rig(seed: int, distorted: bool, vertical: bool):
    rng = np.random.RandomState(seed)
    K0 = np.array([[450 + 20 * rng.rand(), 0, 360 + 20 * rng.rand()],
                   [0, 450 + 20 * rng.rand(), 240 + 20 * rng.rand()],
                   [0, 0, 1.0]])
    K1 = np.array([[455 + 20 * rng.rand(), 0, 365 + 20 * rng.rand()],
                   [0, 452 + 20 * rng.rand(), 245 + 20 * rng.rand()],
                   [0, 0, 1.0]])
    d0 = d1 = np.zeros(4)
    if distorted:
        base = np.array([-0.28, 0.07, 2e-4, 1.7e-5])
        d0 = base + rng.randn(4) * [0.02, 0.01, 1e-4, 1e-4]
        d1 = base + rng.randn(4) * [0.02, 0.01, 1e-4, 1e-4]
    R = cv2.Rodrigues(rng.randn(3) * 0.02)[0]
    T = (np.array([0.002, -0.1, 0.001]) if vertical
         else np.array([-0.11, 0.001, 0.0005]) + rng.randn(3) * 0.002)
    return K0, d0, K1, d1, R, T


RIGS = [(s, dist, vert, size, new)
        for s, (dist, vert) in enumerate([(False, False), (True, False),
                                          (True, True), (False, True)])
        for size, new in [((752, 480), (640, 336)), ((640, 480), (512, 384))]]


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(a).max())


@pytest.mark.parametrize("seed,distorted,vertical,size,new", RIGS)
def test_stereo_rectify_and_maps_match_opencv(seed, distorted, vertical,
                                              size, new):
    K0, d0, K1, d1, R, T = _rig(seed, distorted, vertical)
    want = cv2.stereoRectify(K0, d0, K1, d1, size, R, T.reshape(3, 1),
                             flags=cv2.CALIB_ZERO_DISPARITY, alpha=0,
                             newImageSize=new)[:4]
    got = rectify.stereo_rectify(K0, d0, K1, d1, size, R, T, new)
    for name, a, b in zip(("R1", "R2", "P1", "P2"), want, got):
        assert _rel(a, b) < 1e-6, (name, a, b)
    R1, R2, P1, P2 = want
    for K, d, Rk, Pk in ((K0, d0, R1, P1), (K1, d1, R2, P2)):
        m1, m2 = cv2.initUndistortRectifyMap(K, d, Rk, Pk[:3, :3], new,
                                             cv2.CV_32FC1)
        q1, q2 = rectify.undistort_rectify_map(K, d, Rk, Pk, new)
        assert q1.dtype == np.float32 and q1.shape == m1.shape
        assert np.abs(q1 - m1).max() < 1e-3 and np.abs(q2 - m2).max() < 1e-3
    # the mono path: no rotation, a scaled camera matrix
    m1, m2 = cv2.initUndistortRectifyMap(K0, d0, None, K0 * 0.8, new,
                                         cv2.CV_32FC1)
    q1, q2 = rectify.undistort_rectify_map(K0, d0, None, K0 * 0.8, new)
    assert np.abs(q1 - m1).max() < 1e-3 and np.abs(q2 - m2).max() < 1e-3


def test_rodrigues_and_undistort_points_match_opencv():
    rng = np.random.RandomState(7)
    for _ in range(5):
        v = rng.randn(3) * 0.7
        np.testing.assert_allclose(rectify.rodrigues(v), cv2.Rodrigues(v)[0],
                                   atol=1e-14)
        R = cv2.Rodrigues(v)[0]
        np.testing.assert_allclose(rectify.rodrigues(R),
                                   cv2.Rodrigues(R)[0].ravel(), atol=1e-12)
    K0, d0, _, _, R, _ = _rig(3, True, False)
    P = K0 * 0.9
    pts = (rng.rand(40, 2) * [752, 480]).astype(np.float32)
    np.testing.assert_allclose(
        rectify.undistort_points(pts, K0, d0, R, P),
        cv2.undistortPoints(pts[:, None], K0, d0, R=R, P=P)[:, 0], atol=1e-4)


@pytest.mark.parametrize("channels", [None, 3])
def test_remap_bilinear_matches_opencv(channels):
    rng = np.random.RandomState(8)
    shape = (40, 50) + ((channels,) if channels else ())
    img = rng.randint(0, 256, shape).astype(np.uint8)
    # sampling positions inside, on and beyond the borders
    mx = (rng.rand(60, 70) * 56 - 3).astype(np.float32)
    my = (rng.rand(60, 70) * 46 - 3).astype(np.float32)
    mx[0, :6] = [-1.0, -0.5, -0.01, 49.0, 49.5, 50.0]
    my[0, :6] = [0.0, 0.0, 0.0, 39.0, 39.5, 40.0]
    K0, d0, K1, d1, R, T = _rig(1, True, False)
    R1, _, P1, _ = rectify.stereo_rectify(K0, d0, K1, d1, (752, 480), R, T,
                                          (640, 336))
    big = rng.randint(0, 256, (480, 752)).astype(np.uint8)
    rx, ry = rectify.undistort_rectify_map(K0, d0, R1, P1, (640, 336))
    for im, x, y in ((img, mx, my), (big, rx, ry)):
        want = cv2.remap(im, x, y, cv2.INTER_LINEAR).astype(int)
        got = rectify.remap_bilinear(im, x, y)
        assert got.shape == want.shape
        diff = np.abs(got - want)
        print(f"remap {im.shape}: max |diff| {diff.max()}, "
              f"{100 * (diff > 0).mean():.3f}% of pixels differ")
        assert diff.max() <= 2


def _yaml_cam(T_BS, K, wh, dist=(0.0, 0.0, 0.0, 0.0)):
    """A sensor.yaml in EuRoC's layout, T_BS's data wrapped over four
    lines as in the real files."""
    rows = ",\n         ".join(", ".join(f"{v:.12f}" for v in r)
                               for r in T_BS)
    return ("%YAML:1.0\n# General sensor definitions.\n"
            "sensor_type: camera\ncomment: synthetic rig\n"
            "T_BS:\n  cols: 4\n  rows: 4\n"
            f"  data: [{rows}]\n"
            "rate_hz: 30\n"
            f"resolution: [{wh[0]}, {wh[1]}]\n"
            "camera_model: pinhole\n"
            f"intrinsics: [{K[0]}, {K[1]}, {K[2]}, {K[3]}] #fu, fv, cu, cv\n"
            "distortion_model: radial-tangential\n"
            f"distortion_coefficients: [{', '.join(str(v) for v in dist)}]\n")


def _rot_to_quat_wxyz(R):
    w = np.sqrt(max(0.0, 1 + R[0, 0] + R[1, 1] + R[2, 2])) / 2
    return (w, (R[2, 1] - R[1, 2]) / (4 * w), (R[0, 2] - R[2, 0]) / (4 * w),
            (R[1, 0] - R[0, 1]) / (4 * w))


def write_euroc(root, dist=(0.0, 0.0, 0.0, 0.0), n=N):
    """The synthetic stereo orbit (``n`` frames) in the EuRoC ``mav0/``
    layout, as tests/test_euroc_stereo.py writes it, with a 200 Hz
    ``imu0``."""
    mav = root / "mav0"
    ds = SyntheticDataset(SyntheticConfig(
        n_frames=n, height=H, width=W, stereo=True, baseline=BASELINE,
        deg_per_frame=3.0))
    T_B_c0, T_B_c1 = np.eye(4), np.eye(4)
    T_B_c1[0, 3] = BASELINE
    gt_rows = ["#t,px,py,pz,qw,qx,qy,qz,v,v,v,bw,bw,bw,ba,ba,ba"]
    stamps = []
    for cam, key, tbs in (("cam0", "images", T_B_c0),
                          ("cam1", "images_right", T_B_c1)):
        (mav / cam / "data").mkdir(parents=True)
        csv = ["#timestamp [ns],filename"]
        for k in range(n):
            pkt = ds[k]
            t_ns = int(round(pkt["t_cams"] * 1e9))
            cv2.imwrite(str(mav / cam / "data" / f"{t_ns}.png"),
                        cv2.cvtColor(pkt[key], cv2.COLOR_RGB2BGR))
            csv.append(f"{t_ns},{t_ns}.png")
            if cam == "cam0":
                stamps.append(t_ns)
                c2w = pkt["poses"]
                qw, qx, qy, qz = _rot_to_quat_wxyz(c2w[:3, :3])
                gt_rows.append(f"{t_ns},{c2w[0, 3]},{c2w[1, 3]},{c2w[2, 3]},"
                               f"{qw},{qx},{qy},{qz},0,0,0,0,0,0,0,0,0")
        (mav / cam / "data.csv").write_text("\n".join(csv))
        (mav / cam / "sensor.yaml").write_text(_yaml_cam(tbs, ds.K, (W, H),
                                                         dist))
    gdir = mav / "state_groundtruth_estimate0"
    gdir.mkdir()
    (gdir / "data.csv").write_text("\n".join(gt_rows))
    (mav / "imu0").mkdir()
    (mav / "imu0" / "sensor.yaml").write_text(EUROC_IMU0)
    t_imu = np.arange(stamps[0] - 10_000_000, stamps[-1] + 10_000_000,
                      5_000_000)
    imu = ["#timestamp [ns],w_x,w_y,w_z,a_x,a_y,a_z"] + [
        f"{t},0.01,-0.02,0.03,0.1,-9.81,0.2" for t in t_imu]
    (mav / "imu0" / "data.csv").write_text("\n".join(imu))
    return str(root)


@pytest.fixture(scope="module")
def euroc_dirs(tmp_path_factory):
    base = tmp_path_factory.mktemp("euroc")
    return {"plain": write_euroc(base / "V9_plain"),
            "distorted": write_euroc(base / "V9_dist",
                                     (-0.05, 0.01, 1e-4, -2e-4))}


def _compare(a, b):
    """Port packet ``a`` against JAX packet ``b``."""
    assert a.keys() == b.keys()
    for key in ("images", "images_right"):
        if key in b:
            assert a[key].shape == b[key].shape and a[key].dtype == np.uint8
            diff = np.abs(a[key].astype(int) - b[key].astype(int))
            assert diff.max() <= 2, (key, diff.max())
    for key in ("poses", "stereo_rel"):
        if b.get(key) is not None:
            np.testing.assert_allclose(a[key], b[key], atol=1e-5)
    np.testing.assert_allclose(a["intrinsics"], b["intrinsics"], atol=1e-4)
    assert a["t_cams"] == b["t_cams"] and a["k"] == b["k"]
    assert a["is_last_frame"] == b["is_last_frame"]
    if "imu_t0_t1" in b:
        np.testing.assert_array_equal(a["imu_t0_t1"], b["imu_t0_t1"])


@pytest.mark.parametrize("which", ["plain", "distorted"])
@pytest.mark.parametrize("stereo", [False, True])
def test_euroc_packets_match_the_jax_loader(euroc_dirs, which, stereo):
    root = euroc_dirs[which]
    kw = dict(stereo=stereo, target_hw=(H, W))
    t, j = TEuroc(root, **kw), JEuroc(root, **kw)
    assert len(t) == len(j) == N
    for k in range(N):
        _compare(t[k], j[k])
    assert t[1]["imu_t0_t1"].shape[0] > 0
    if stereo:
        # the rig's 0.1 m baseline recovered by the rectification
        assert abs(t.baseline - BASELINE) < 1e-4
        np.testing.assert_allclose(t.calib.body_T_cam, j.calib.body_T_cam,
                                   atol=1e-9)
    assert t.imu.a_n == j.imu.a_n and t.imu.g_b == j.imu.g_b
