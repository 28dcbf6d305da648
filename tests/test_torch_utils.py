"""The port's ``utils/`` (conversions, viz, rgbd, evaluation's meshes and
``MeshRenderer``, checkpoint resume, runtime) and ``native/`` against the
JAX package's functions and their own plain versions, on the CPU.

Tolerances: conversions, viz, association, interpolation, graphs and mesh
loading equal to the bit; distance matrices within 1e-4 relative and
1e-6 absolute (float32, operations ordered differently); mesh depth
within 1e-5; a resumed tracker or field equal to the uninterrupted run to
the bit; the native library equal to its numpy versions (the sRGB table
within one float32 ulp: libm's powf and numpy's power may round
differently)."""
import json
import os

import numpy as np
import pytest
import torch

from nerf_slam_tpu.utils import conversions as jconv
from nerf_slam_tpu.utils import rgbd as jrgbd
from nerf_slam_tpu.utils import viz as jviz
from nerf_slam_tpu.utils.evaluation import MeshRenderer as JMeshRenderer
from nerf_slam_tpu.utils.evaluation import load_mesh as jload_mesh
from nerf_slam_tpu_torch import native
from nerf_slam_tpu_torch.utils import checkpoint as ckpt
from nerf_slam_tpu_torch.utils import conversions as tconv
from nerf_slam_tpu_torch.utils import rgbd as trgbd
from nerf_slam_tpu_torch.utils import runtime
from nerf_slam_tpu_torch.utils import viz as tviz
from nerf_slam_tpu_torch.utils.evaluation import MeshRenderer, load_mesh

WEIGHTS = os.path.join(os.path.dirname(__file__), "..",
                       "weights_synthetic.npz")


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several test processes on a
    few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pose(rng):
    m = np.eye(4)
    m[:3, :3] = np.linalg.qr(rng.randn(3, 3))[0]
    m[:3, 3] = rng.randn(3)
    return m


def test_conversions_match_jax_to_the_bit():
    rng = np.random.RandomState(0)
    for _ in range(3):
        m = _pose(rng)
        for fn in ("nerf_matrix_to_ngp", "ngp_matrix_to_nerf"):
            np.testing.assert_array_equal(getattr(tconv, fn)(m, 2.0, 0.3),
                                          getattr(jconv, fn)(m, 2.0, 0.3))
        np.testing.assert_array_equal(tconv.opengl_to_opencv_c2w(m),
                                      jconv.opengl_to_opencv_c2w(m))
    aabb = [[-3.0, -1.0, 0.0], [1.0, 1.0, 2.0]]
    s, off = tconv.get_scale_and_offset(aabb)
    assert (s, off.tolist()) == (lambda a: (a[0], a[1].tolist()))(
        jconv.get_scale_and_offset(aabb))
    poses = np.stack([_pose(rng) for _ in range(4)])
    np.testing.assert_array_equal(tconv.scale_offset_poses(poses, s, off),
                                  jconv.scale_offset_poses(poses, s, off))
    img = rng.rand(8, 9, 3)
    for fn in ("srgb_to_linear", "linear_to_srgb"):
        np.testing.assert_array_equal(getattr(tconv, fn)(img),
                                      getattr(jconv, fn)(img))
    ref = rng.rand(8, 9, 3)
    bad = img.copy()
    bad[0, 0, 0], bad[1, 1, 1] = np.nan, -np.inf
    assert tconv.compute_error(bad, ref) == jconv.compute_error(bad, ref)
    assert tconv.mse2psnr(0.01) == jconv.mse2psnr(0.01)


def test_viz_matches_jax_to_the_bit():
    rng = np.random.RandomState(1)
    np.testing.assert_array_equal(tviz.make_colorwheel(),
                                  jviz.make_colorwheel())
    flow = rng.randn(10, 12, 2) * 4
    for norm in (None, 3.0):
        np.testing.assert_array_equal(tviz.flow_to_rgb(flow, norm),
                                      jviz.flow_to_rgb(flow, norm))
    d = rng.rand(10, 12) * 5
    for cmap in ("turbo", "gray"):
        np.testing.assert_array_equal(tviz.colormap(d, cmap=cmap),
                                      jviz.colormap(d, cmap=cmap))
    np.testing.assert_array_equal(tviz.depth_to_rgb(d), jviz.depth_to_rgb(d))
    np.testing.assert_array_equal(tviz.sigma_to_rgb(d ** 2),
                                  jviz.sigma_to_rgb(d ** 2))
    a = rng.randn(6, 6)
    cov = a @ a.T
    for x, y in zip(tviz.pose_cov_ellipsoid(cov, 2.0),
                    jviz.pose_cov_ellipsoid(cov, 2.0)):
        np.testing.assert_array_equal(x, y)


def test_association_and_interpolation_match_jax():
    rng = np.random.RandomState(2)
    t_img = np.sort(rng.rand(20)) * 10
    t_dep = np.sort(rng.rand(25)) * 10
    t_pose = np.sort(rng.rand(30)) * 10
    for tp in (None, t_pose):
        assert trgbd.associate_frames(t_img, t_dep, tp, max_dt=0.2) == \
            jrgbd.associate_frames(t_img, t_dep, tp, max_dt=0.2)
    q = rng.randn(30, 4)
    traj = np.concatenate([rng.randn(30, 3),
                           q / np.linalg.norm(q, axis=1, keepdims=True)], 1)
    tq = np.concatenate([rng.rand(15) * 12 - 1, t_pose[:3]])
    np.testing.assert_array_equal(
        trgbd.interpolate_poses(tq, t_pose, traj),
        jrgbd.interpolate_poses(tq, t_pose, traj))


def _orbit(n, h=12, w=16):
    """n inward-looking poses on a small orbit ([t, q] world_T_cam
    inverses) and constant-depth disparities with a tilt."""
    from nerf_slam_tpu.geometry import se3 as jse3
    import jax.numpy as jnp
    poses = []
    for k in range(n):
        a = 0.25 * k
        c2w = np.eye(4)
        c2w[0, 3] = np.sin(a)
        c2w[2, 3] = -2.0 + (1 - np.cos(a))
        poses.append(np.linalg.inv(c2w))
    poses7 = np.asarray(jse3.from_matrix(jnp.asarray(np.stack(poses))))
    disps = np.full((n, h, w), 0.5, np.float32)
    disps += np.linspace(0, 0.2, w, dtype=np.float32)
    intr = np.array([20.0, 20.0, w / 2, h / 2], np.float32)
    return poses7, disps, intr


def test_distance_matrices_match_jax():
    poses, disps, intr = _orbit(6)
    np.testing.assert_allclose(
        trgbd.all_pairs_distance_matrix(poses, 2.0, device="cpu"),
        jrgbd.all_pairs_distance_matrix(poses, 2.0), rtol=1e-4, atol=1e-5)
    for beta in (None, 0.4):
        want = jrgbd.compute_distance_matrix_flow(poses, disps, intr,
                                                  beta=beta, chunk=8)
        got = trgbd.compute_distance_matrix_flow(poses, disps, intr,
                                                 beta=beta, chunk=8,
                                                 device="cpu")
        assert (np.isinf(got) == np.isinf(want)).all()
        fin = np.isfinite(want)
        assert fin.sum() > 10
        # the self pairs' zero flow comes out as 0 or a few 1e-8
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-4,
                                   atol=1e-6)


@pytest.mark.parametrize("nms", [False, True])
def test_frame_graph_matches_jax(nms):
    poses, disps, intr = _orbit(6)
    d = jrgbd.compute_distance_matrix_flow(poses, disps, intr,
                                           beta=0.4 if nms else None,
                                           chunk=64)
    kw = dict(num=14, thresh=1e9 if not nms else 30.0, r=1, nms=nms)
    gt = trgbd.build_frame_graph(poses, disps, intr, d=d.copy(), **kw)
    gj = jrgbd.build_frame_graph(poses, disps, intr, d=d.copy(), **kw)
    assert gt == gj
    for a, b in zip(trgbd.graph_to_edge_list(gt),
                    jrgbd.graph_to_edge_list(gj)):
        np.testing.assert_array_equal(a, b)
    # the same graph from the port's own matrix, computed on the CPU
    assert trgbd.build_frame_graph(poses, disps, intr, device="cpu",
                                   **kw) == gj


def _quad(z=2.0, half=1.0):
    verts = np.array([[-half, -half, z], [half, -half, z], [half, half, z],
                      [-half, half, z]], np.float32)
    return verts, np.array([[0, 1, 2], [0, 2, 3]], np.int32)


def test_load_mesh_matches_jax(tmp_path):
    """OBJ (with v/vt/vn face indices and a quad), ASCII PLY, binary
    little-endian PLY with quads and extra vertex properties."""
    rng = np.random.RandomState(3)
    verts = rng.rand(7, 3).astype(np.float32)
    obj = tmp_path / "m.obj"
    obj.write_text("# mesh\n" + "".join(f"v {v[0]} {v[1]} {v[2]}\n"
                                        for v in verts)
                   + "f 1/1/1 2/2/2 3/3/3\nf 4 5 6 7\n")
    ply = tmp_path / "a.ply"
    ply.write_text("ply\nformat ascii 1.0\ncomment x\nelement vertex 7\n"
                   "property float x\nproperty float y\nproperty float z\n"
                   "element face 2\nproperty list uchar int vertex_indices\n"
                   "end_header\n"
                   + "".join(f"{v[0]} {v[1]} {v[2]}\n" for v in verts)
                   + "3 0 1 2\n4 3 4 5 6\n")
    plyb = tmp_path / "b.ply"
    vdt = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                    ("r", "u1"), ("g", "u1"), ("b", "u1")])
    vb = np.zeros(7, vdt)
    vb["x"], vb["y"], vb["z"] = verts.T
    with open(plyb, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\nelement vertex 7\n"
                b"property float x\nproperty float y\nproperty float z\n"
                b"property uchar red\nproperty uchar green\n"
                b"property uchar blue\nelement face 2\n"
                b"property list uchar int vertex_indices\nend_header\n")
        f.write(vb.tobytes())
        f.write(np.uint8(3).tobytes() + np.array([0, 1, 2], "<i4").tobytes())
        f.write(np.uint8(4).tobytes()
                + np.array([3, 4, 5, 6], "<i4").tobytes())
    for path in (obj, ply, plyb):
        (tv, tf), (jv, jf) = load_mesh(str(path)), jload_mesh(str(path))
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(tf, jf)
        assert tf.dtype == np.int32 and tf.shape == (3, 3)


def test_mesh_renderer_cases():
    """tests/test_mesh_renderer.py's cases on the port's renderer."""
    W, H = 32, 24
    r = MeshRenderer(_quad(z=2.0), (20.0, 20.0, W / 2, H / 2), (W, H),
                     tri_chunk=8, px_chunk=256, device="cpu")
    depth = r.render_mesh(np.eye(4))
    assert depth.shape == (H, W)
    np.testing.assert_allclose(depth[H // 2, W // 2], 2.0, atol=1e-3)
    assert depth[0, 0] == 0.0
    c2w = np.eye(4)
    c2w[2, 3] = 1.0
    np.testing.assert_allclose(r.render_mesh(c2w)[H // 2, W // 2], 1.0,
                               atol=1e-3)
    v1, f1 = _quad(z=2.0)
    v2, f2 = _quad(z=1.0, half=0.1)
    r = MeshRenderer((np.concatenate([v1, v2]), np.concatenate([f1, f2 + 4])),
                     (20.0, 20.0, 16.0, 12.0), (32, 24), tri_chunk=4,
                     px_chunk=256, device="cpu")
    np.testing.assert_allclose(r.render_mesh(np.eye(4))[12, 16], 1.0,
                               atol=1e-3)


def test_mesh_renderer_matches_jax_on_a_random_mesh():
    rng = np.random.RandomState(4)
    n = 60
    centers = rng.randn(n, 3) * [0.8, 0.6, 0.3] + [0, 0, 3.0]
    verts = (centers[:, None, :] + rng.randn(n, 3, 3) * 0.4).reshape(-1, 3)
    faces = np.arange(3 * n, dtype=np.int32).reshape(n, 3)
    mesh = (verts.astype(np.float32), faces)
    intr, res = (30.0, 28.0, 19.5, 15.0), (40, 30)
    c2w = np.eye(4)
    c2w[:3, :3] = np.linalg.qr(np.eye(3) + 0.05 * rng.randn(3, 3))[0]
    c2w[:3, 3] = [0.1, -0.05, 0.2]
    c2w[:3, :3] *= np.sign(np.linalg.det(c2w[:3, :3]))
    want = JMeshRenderer(mesh, intr, res, tri_chunk=16,
                         px_chunk=256).render_mesh(c2w)
    got = MeshRenderer(mesh, intr, res, tri_chunk=16, px_chunk=256,
                       device="cpu").render_mesh(c2w)
    assert (want > 0).mean() > 0.2
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, atol=1e-5)


def _tracker_result(fe):
    n, st = fe.kf_idx + 1, fe.state
    return (st.timestamps[:n].clone(), st.cam_T_world[:n].clone(),
            st.idepths[:n].clone())


def test_frontend_resume_is_bit_exact(tmp_path):
    """A 48x64 tracker saved after keyframe 3 (before initialization) and
    after keyframe 9 (just after it), loaded into a fresh tracker and run
    to the end, equals the uninterrupted run to the bit."""
    from nerf_slam_tpu_torch.cli import slam_demo
    from nerf_slam_tpu_torch.datasets import SyntheticConfig as TCfg
    from nerf_slam_tpu_torch.datasets import SyntheticDataset as TDs
    args = slam_demo.parse_args(["--device", "cpu", "--height", "48",
                                 "--width", "64", "--buffer", "12",
                                 "--weights", WEIGHTS])
    ds = TDs(TCfg(n_frames=14, height=48, width=64))
    frames = [ds[k] for k in range(14)]
    fe = slam_demo.build_frontend(args, (48, 64))
    for k, pkt in enumerate(frames):
        fe(k, pkt)
    assert fe.stop and fe.kf_idx > 9
    want = _tracker_result(fe)
    for save_after in (3, 9):
        fe = slam_demo.build_frontend(args, (48, 64))
        k = 0
        while fe.kf_idx <= save_after:
            fe(k, frames[k])
            k += 1
        path = str(tmp_path / f"fe{save_after}.npz")
        ckpt.save_frontend(path, fe)
        meta = json.load(open(path + ".json"))
        assert {"kf_idx", "last_kf_idx", "last_k", "is_initialized",
                "kf_idx_to_f_idx", "graph"} <= set(meta)
        fe2 = slam_demo.build_frontend(args, (48, 64))
        ckpt.load_frontend(path, fe2)
        assert fe2.kf_idx == fe.kf_idx and fe2.last_k == fe.last_k
        while k < len(frames):
            fe2(k, frames[k])
            k += 1
        got = _tracker_result(fe2)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), save_after


@pytest.mark.parametrize("encoding", ["pe", "hash"])
def test_nerf_resume_is_bit_exact(tmp_path, encoding):
    """A 20-step fit saved after 10 steps (with pose refinement running,
    so both Adam states and the deltas matter) and resumed in a field
    built from another seed equals the uninterrupted fit to the bit."""
    from nerf_slam_tpu_torch.fusion import (NerfFusion, NerfFusionConfig,
                                            NGPConfig)
    from nerf_slam_tpu_torch.fusion.hashgrid import HashGridConfig
    from nerf_slam_tpu_torch.geometry import se3
    grid = HashGridConfig(n_levels=2, log2_table_size=8, base_resolution=4,
                          finest_resolution=8)

    def cfg():
        return NerfFusionConfig(
            buffer=3, height=16, width=16, batch_rays=64,
            optimize_extrinsics=True, extrinsics_start=4,
            extrinsics_period=6, extrinsics_pose_iters=2, eval_every=5,
            eval_views=2, ngp=NGPConfig(encoding=encoding, pe_hidden=32,
                                        hidden=16, n_uniform=8, n_depth=4,
                                        grid=grid))

    def fed(seed):
        rng = np.random.RandomState(0)
        f = NerfFusion(cfg(), seed=seed, device="cpu")
        poses = se3.from_matrix(torch.eye(4).repeat(3, 1, 1))
        poses[:, 0] = torch.tensor([0.0, 0.1, 0.2])
        f.update_training_images(
            torch.arange(3), poses,
            torch.as_tensor(rng.randint(0, 255, (3, 16, 16, 3)).astype(
                np.uint8)), torch.full((3, 16, 16), 0.5),
            torch.full((3, 16, 16), 0.01), torch.tensor([[8.0] * 4] * 3))
        return f

    whole = fed(3)
    whole.fit_volume(20)
    half = fed(3)
    half.fit_volume(10)
    path = str(tmp_path / "nerf.npz")
    ckpt.save_nerf(path, half)
    assert json.load(open(path + ".json"))["iteration"] == 10
    resumed = NerfFusion(cfg(), seed=99, device="cpu")
    ckpt.load_nerf(path, resumed)
    resumed.fit_volume(10)
    assert resumed.iteration == whole.iteration == 20
    for (ka, a), (kb, b) in zip(whole.field.state_dict().items(),
                                resumed.field.state_dict().items()):
        assert ka == kb and torch.equal(a, b), ka
    assert torch.equal(whole.pose_deltas, resumed.pose_deltas)
    assert float(whole.pose_deltas.detach().abs().max()) > 0
    assert [r["psnr"] for r in whole.results] == \
        [r["psnr"] for r in resumed.results]


def test_native_library_matches_its_plain_versions():
    """tests/test_native.py's cases: the g++-built library against its
    numpy versions, which hold the JAX test's references."""
    native.get_lib()
    rng = np.random.RandomState(0)
    img = rng.randint(0, 256, (32, 40, 3)).astype(np.uint8)
    got = native.srgb_u8_to_linear(img)
    np.testing.assert_allclose(got, native.srgb_u8_to_linear_plain(img),
                               rtol=0, atol=6e-8)
    x = img.astype(np.float32) / 255.0
    np.testing.assert_allclose(got, np.where(
        x <= 0.04045, x / 12.92, ((x + 0.055) / 1.055) ** 2.4), atol=1e-5)
    np.testing.assert_array_equal(native.normalize_image_u8(img),
                                  native.normalize_image_u8_plain(img))
    d = rng.randint(0, 65535, (24, 32)).astype(np.uint16)
    np.testing.assert_array_equal(native.depth_u16_to_f32(d, 1e-3),
                                  native.depth_u16_to_f32_plain(d, 1e-3))
    for h, w in ((24, 32), (50, 70), (17, 23)):
        np.testing.assert_array_equal(
            native.resize_bilinear_u8(img, h, w),
            native.resize_bilinear_u8_plain(img, h, w))
        f = rng.rand(32, 40).astype(np.float32)
        np.testing.assert_array_equal(native.resize_nearest_f32(f, h, w),
                                      native.resize_nearest_f32_plain(f, h,
                                                                      w))
    small = np.arange(24, dtype=np.float32).reshape(4, 6)
    np.testing.assert_array_equal(native.resize_nearest_f32(small, 2, 3),
                                  small[::2, ::2])
    cv2 = pytest.importorskip("cv2")
    want = cv2.resize(img, (20, 16), interpolation=cv2.INTER_LINEAR)
    assert np.abs(native.resize_bilinear_u8(img, 16, 20).astype(int)
                  - want).mean() < 2.0


def test_runtime_counters_and_trace(tmp_path):
    """The span recorder under ``profile_trace``: a span opened while the
    profiler records is kept with its ids and sync count, and is written
    into the Chrome trace on the CPU ops' clock, around its op."""
    assert runtime.span("x") is runtime.span("y")     # the shared no-op
    with runtime.profile_trace(str(tmp_path / "trace")):
        with runtime.span("outer", k=3) as span:
            torch.ones(8).add_(1)
    assert runtime.spans() == [span] and span.ids == {"k": 3}
    assert span.syncs == 0 and span.t0 < span.t1
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and files[0].endswith(".json")
    events = json.loads((tmp_path / "trace" / files[0]).read_text())[
        "traceEvents"]
    add, = [e for e in events if e.get("name") == "aten::add_"]
    ours, = [e for e in events if e.get("cat") == "span"]
    assert ours["name"] == "outer" and ours["args"]["k"] == 3
    assert ours["ts"] <= add["ts"] \
        and add["ts"] + add["dur"] <= ours["ts"] + ours["dur"]
