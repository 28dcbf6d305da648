"""The port's CUDA kernels on the card, against their plain versions.

These tests need an NVIDIA GPU and skip without one.  They import no JAX,
so they also run where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py configures JAX for the CPU tests.)
``chip_smoke.py`` repeats the comparisons at the main path's shapes.
"""
import numpy as np
import pytest
import torch

from nerf_slam_tpu_torch.ops import corr, corr_lookup

pytestmark = pytest.mark.cuda

# kernel vs plain: the same f32 operations in the same order, rounded to
# nearest without fused multiply-adds, so equal up to one ulp of the
# output type at |v| < 4 (bf16 1.6e-2, f32 1e-5)
TOL_BF16, TOL_F32 = 1.6e-2, 1e-5


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels are CUDA only)")
    return torch.device("cuda")


def _inputs(dev, seed, E, H, W, C=16):
    rng = np.random.RandomState(seed)
    f1 = torch.from_numpy((rng.randn(E, C, H, W) * 0.3).astype(np.float32))
    f2 = torch.from_numpy((rng.randn(E, C, H, W) * 0.3).astype(np.float32))
    coords = (rng.rand(E, H, W, 2) * np.array([W + 2, H + 2]) - 1.5
              ).astype(np.float32)
    return f1.to(dev), f2.to(dev), torch.from_numpy(coords).to(dev)


@pytest.mark.parametrize("E,H,W,n", [(4, 16, 16, 2), (3, 10, 14, 3),
                                     (5, 7, 9, 0)])
def test_grouped4_kernel_matches_plain(dev, E, H, W, n):
    """Kernel #1, gated and ungated, at aligned and unaligned shapes
    (the JAX package sends the latter to a fallback; the kernel takes
    them).  Gated slots >= n_act are written as zeros."""
    f1, f2, c = _inputs(dev, E + H, E, H, W)
    slabs = corr.build_pyramid_bf16(f1, f2, 4, pad_rows_to=8)
    dims = corr_lookup.pyramid_dims(H, W)
    n_act = torch.tensor([n], dtype=torch.int32, device=dev)
    for na, tol in ((None, TOL_F32), (n_act, TOL_BF16)):
        got = corr_lookup.lookup_pyramid_grouped4(slabs, c, dims, na)
        want = corr_lookup.lookup_pyramid_grouped4_plain(slabs, c, dims, na)
        torch.cuda.synchronize()
        assert got.dtype == want.dtype
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=0)
    assert (got[n:] == 0).all()


def test_grouped4_kernel_nan_coords_select_nothing(dev):
    f1, f2, c = _inputs(dev, 1, 2, 16, 16)
    c[0, 2, 3] = float("nan")
    c[1, 5, :, 1] = float("nan")
    slabs = corr.build_pyramid_bf16(f1, f2, 4, pad_rows_to=8)
    got = corr_lookup.lookup_pyramid_grouped4(
        slabs, c, corr_lookup.pyramid_dims(16, 16))
    assert torch.isfinite(got).all()
    assert (got[0, 2, 3] == 0).all() and (got[1, 5] == 0).all()


def test_pyramid_kernel_matches_plain(dev):
    """Kernel #2 on unpadded levels (the motion filter's pyramid)."""
    f1, f2, c = _inputs(dev, 5, 2, 12, 20)
    levels = [lv.to(torch.bfloat16).contiguous() for lv in
              corr.build_pyramid(corr.build_volume(f1, f2))]
    got = corr_lookup.lookup_pyramid(levels, c)
    torch.testing.assert_close(got, corr_lookup.lookup_pyramid_plain(
        levels, c), atol=TOL_F32, rtol=0)


def test_kernel_wrappers_count_and_reject(dev):
    """A launch adds one to its wrapper's count; inputs the kernel does
    not take raise before any launch."""
    f1, f2, c = _inputs(dev, 2, 1, 8, 8)
    levels = [lv.to(torch.bfloat16).contiguous() for lv in
              corr.build_pyramid(corr.build_volume(f1, f2))]
    before = dict(corr_lookup.launches)
    corr_lookup.lookup_pyramid(levels, c)
    assert corr_lookup.launches["corr_lookup_pyramid"] == \
        before["corr_lookup_pyramid"] + 1
    with pytest.raises(ValueError):
        corr_lookup.lookup_pyramid([lv.float() for lv in levels], c)
    with pytest.raises(ValueError):
        corr_lookup.lookup_pyramid(levels, c.permute(0, 2, 1, 3))
    with pytest.raises(ValueError):
        corr_lookup.lookup_pyramid_grouped4(
            levels, c, corr_lookup.pyramid_dims(8, 8),
            torch.tensor([1], device=dev))           # int64 n_act
    assert corr_lookup.launches == before | {
        "corr_lookup_pyramid": before["corr_lookup_pyramid"] + 1}
