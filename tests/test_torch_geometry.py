"""Geometry, convex upsampling and correlation volumes of the port against
the JAX package, pointwise on the same numpy inputs (f32 on the CPU).

Tolerances: both sides evaluate the same closed forms in f32 with
different operation orders, so values of order 1-100 agree to a few f32
ulps (rtol 1e-5, atol 1e-5 unless stated).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nerf_slam_tpu.geometry import camera as jcam
from nerf_slam_tpu.geometry import se3 as jse3
from nerf_slam_tpu.geometry import upsample as jup
from nerf_slam_tpu.ops import corr as jcorr
from nerf_slam_tpu_torch.geometry import camera as tcam
from nerf_slam_tpu_torch.geometry import se3 as tse3
from nerf_slam_tpu_torch.geometry import upsample as tup
from nerf_slam_tpu_torch.ops import corr as tcorr

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(a, b, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(_np(a), _np(b), rtol=rtol, atol=atol)


def _poses(rng, n, rot=0.3, trans=0.5):
    xi = np.concatenate([rng.randn(n, 3) * trans, rng.randn(n, 3) * rot],
                        -1).astype(np.float32)
    return np.asarray(jse3.exp(jnp.asarray(xi)))


def test_se3_ops_match():
    rng = np.random.RandomState(0)
    xi = np.concatenate([rng.randn(16, 3), rng.randn(16, 3) * 0.8],
                        -1).astype(np.float32)
    xi[0, 3:] = 1e-6                     # small-angle branch
    g = _poses(rng, 16)
    h = _poses(rng, 16)
    x = rng.randn(16, 3).astype(np.float32)
    X4 = rng.randn(16, 4).astype(np.float32)
    J, T = jnp.asarray, torch.from_numpy
    _close(jse3.exp(J(xi)), tse3.exp(T(xi)))
    _close(jse3.log(J(g)), tse3.log(T(g)), atol=2e-5)
    _close(jse3.inv(J(g)), tse3.inv(T(g)))
    _close(jse3.mul(J(g), J(h)), tse3.mul(T(g), T(h)))
    _close(jse3.act(J(g), J(x)), tse3.act(T(g), T(x)))
    _close(jse3.act4(J(g), J(X4)), tse3.act4(T(g), T(X4)))
    _close(jse3.retr(J(g), J(xi)), tse3.retr(T(g), T(xi)))
    _close(jse3.adj_matrix(J(g)), tse3.adj_matrix(T(g)))
    _close(jse3.adjT_apply(J(g), J(xi)), tse3.adjT_apply(T(g), T(xi)))
    _close(jse3.matrix(J(g)), tse3.matrix(T(g)))
    _close(jse3.from_matrix(jse3.matrix(J(g))),
           tse3.from_matrix(tse3.matrix(T(g))))


def _scene(seed, N=4, h=6, w=8):
    rng = np.random.RandomState(seed)
    poses = _poses(rng, N, rot=0.05, trans=0.1)
    disps = rng.uniform(0.4, 1.6, (N, h, w)).astype(np.float32)
    intr = np.tile(np.array([[w * 0.9, h * 1.1, w / 2 - 0.3, h / 2 + 0.2]],
                            np.float32), (N, 1))
    return poses, disps, intr


def test_projective_transform_and_jacobians_match():
    poses, disps, intr = _scene(1)
    ii = np.array([0, 1, 2, 3, 0, 2])
    jj = np.array([1, 0, 3, 2, 3, 1])
    J, T = jnp.asarray, torch.from_numpy
    cj, vj, (Jij, Jjj, Jzj) = jcam.projective_transform(
        J(poses), J(disps), J(intr), J(ii), J(jj), jacobian=True)
    ct, vt, (Jit, Jjt, Jzt) = tcam.projective_transform(
        T(poses), T(disps), T(intr), T(ii), T(jj), jacobian=True)
    for a, b in ((cj, ct), (vj, vt), (Jij, Jit), (Jjj, Jjt), (Jzj, Jzt)):
        assert tuple(a.shape) == tuple(b.shape)
        _close(a, b, atol=1e-4)          # Jacobian entries reach ~50
    # the channel-major form the DBA linearizes with
    outs_j = jcam.projective_transform_cm(J(poses), J(disps), J(intr),
                                          J(ii), J(jj))
    outs_t = tcam.projective_transform_cm(T(poses), T(disps), T(intr),
                                          T(ii), T(jj))
    for a, b in zip(outs_j, outs_t):
        assert tuple(a.shape) == tuple(b.shape)
        _close(a, b, atol=1e-4)


def test_iproj_proj_coords_grid_match():
    poses, disps, intr = _scene(2)
    J, T = jnp.asarray, torch.from_numpy
    _close(jcam.coords_grid(6, 8), tcam.coords_grid(6, 8))
    Xj = jcam.iproj(J(disps), J(intr))
    Xt = tcam.iproj(T(disps), T(intr))
    _close(Xj, Xt)
    pj, Jpj = jcam.proj(Xj, J(intr), jacobian=True)
    pt, Jpt = tcam.proj(Xt, T(intr), jacobian=True)
    _close(pj, pt)
    _close(Jpj, Jpt)


@pytest.mark.parametrize("beta", [0.3, 0.5])
def test_frame_distance_bidirectional_matches(beta):
    poses, disps, intr = _scene(3, N=5)
    ii = np.array([0, 1, 2, 3, 4, 0])
    jj = np.array([1, 2, 3, 4, 0, 4])
    J, T = jnp.asarray, torch.from_numpy
    _close(jcam.frame_distance_bidirectional(J(poses), J(disps), J(intr),
                                             J(ii), J(jj), beta),
           tcam.frame_distance_bidirectional(T(poses), T(disps), T(intr),
                                             T(ii), T(jj), beta), atol=1e-4)


def test_convex_upsampling_matches():
    rng = np.random.RandomState(4)
    B, h, w = 2, 5, 7
    disp = rng.uniform(0.2, 2.0, (B, h, w)).astype(np.float32)
    mask = rng.randn(B, 576, h, w).astype(np.float32) * 3
    J, T = jnp.asarray, torch.from_numpy
    _close(jup.upsample_disp(J(disp), J(mask)),
           tup.upsample_disp(T(disp), T(mask)))
    _close(jup.upsample_disp(J(disp), J(mask), pow=0.5),
           tup.upsample_disp(T(disp), T(mask), pow=0.5))
    data = rng.randn(B, h, w, 3).astype(np.float32)
    _close(jup.cvx_upsample(J(data), J(mask)),
           tup.cvx_upsample(T(data), T(mask)))


def test_correlation_volume_and_pyramid_match():
    rng = np.random.RandomState(5)
    E, C, H, W = 2, 32, 6, 10
    f1 = rng.randn(E, C, H, W).astype(np.float32)
    f2 = rng.randn(E, C, H, W).astype(np.float32)
    J, T = jnp.asarray, torch.from_numpy
    vj = jcorr.build_volume(J(f1), J(f2))
    vt = tcorr.build_volume(T(f1), T(f2))
    _close(vj, vt, atol=1e-5)
    for a, b in zip(jcorr.build_pyramid(vj), tcorr.build_pyramid(vt)):
        assert tuple(a.shape) == tuple(b.shape)
        _close(a, b, atol=1e-5)
    coords = (rng.rand(E, H, W, 2) * np.array([W + 4, H + 4]) - 2
              ).astype(np.float32)
    _close(jcorr.CorrPyramid.build(J(f1), J(f2))(J(coords)),
           tcorr.CorrPyramid.build(T(f1), T(f2))(T(coords)), atol=1e-5)


def test_build_pyramid_bf16_padded_rows_match():
    """The update loop's slabs: bf16, rows zero-padded to 8.  Both sides
    sum exact bf16 products in f32 and round once to bf16; the CPU sum
    orders differ, so a value may land one bf16 ulp apart (2^-8
    relative)."""
    rng = np.random.RandomState(6)
    E, C, H, W = 2, 32, 6, 10
    f1 = rng.randn(E, C, H, W).astype(np.float32)
    f2 = rng.randn(E, C, H, W).astype(np.float32)
    lj = jcorr.build_pyramid_bf16(jnp.asarray(f1), jnp.asarray(f2), 4,
                                  pad_rows_to=8)
    lt = tcorr.build_pyramid_bf16(torch.from_numpy(f1), torch.from_numpy(f2),
                                  4, pad_rows_to=8)
    for a, b in zip(lj, lt):
        assert tuple(a.shape) == tuple(b.shape)
        assert a.shape[-2] % 8 == 0
        assert b.dtype == torch.bfloat16
        _close(a, b, rtol=2 ** -8, atol=1e-6)
