"""The port's correlation-lookup kernels against the Pallas kernels they
replace (``nerf_slam_tpu/ops/corr_pallas.py``), run in interpret mode.

On the CPU each wrapper in ``nerf_slam_tpu_torch.ops.corr_lookup`` runs its
plain PyTorch version, which repeats the CUDA kernel's arithmetic op by op;
the CUDA kernels themselves are compared with the plain versions on the
card by ``chip_smoke.py`` and by tests/test_torch_cuda.py.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nerf_slam_tpu.ops import corr as jcorr
from nerf_slam_tpu.ops import corr_pallas
from nerf_slam_tpu_torch.ops import corr as tcorr
from nerf_slam_tpu_torch.ops import corr_lookup


def _inputs(seed, E, C=16, H=16, W=16):
    rng = np.random.RandomState(seed)
    f1 = (rng.randn(E, C, H, W) * 0.3).astype(np.float32)
    f2 = (rng.randn(E, C, H, W) * 0.3).astype(np.float32)
    coords = (rng.rand(E, H, W, 2) * np.array([W + 2, H + 2]) - 1.5
              ).astype(np.float32)
    return f1, f2, coords


def _jax_levels(f1, f2, pad_rows_to):
    return tuple(jcorr.build_pyramid_bf16(jnp.asarray(f1), jnp.asarray(f2),
                                          4, pad_rows_to=pad_rows_to))


def _torch_levels(jlevels):
    # identical bf16 slabs on both sides: the kernels are compared, not
    # the volume build (tests/test_torch_geometry.py covers that)
    return [torch.from_numpy(np.asarray(lv.astype(jnp.float32)))
            .to(torch.bfloat16) for lv in jlevels]


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) \
        if not isinstance(x, torch.Tensor) else x.float().numpy()


@pytest.mark.parametrize("gated", [False, True])
def test_grouped4_plain_matches_pallas(gated):
    """Kernel #1 (lookup_pyramid_grouped4_nhwc), W1 = 16 takes the
    grouped Pallas path.  The plain version rounds the hat weights and the
    y-interpolated rows to bf16 exactly where the TPU kernel does, so the
    two agree to f32 rounding of the final two-term sum (atol 1e-5 on
    values of order 1; gated output is bf16 on both sides, so one bf16
    ulp at |v| < 4: 1.6e-2)."""
    E, n_act = 4, 2
    f1, f2, coords = _inputs(16, E)
    jl = _jax_levels(f1, f2, 8)
    dims = corr_pallas.pyramid_dims(16, 16)
    kw = {"n_act": jnp.int32(n_act)} if gated else {}
    want = corr_pallas.lookup_pyramid_grouped4_nhwc(
        jl, jnp.asarray(coords), dims, interpret=True, **kw)
    got = corr_lookup.lookup_pyramid_grouped4(
        _torch_levels(jl), torch.from_numpy(coords), dims,
        torch.tensor([n_act], dtype=torch.int32) if gated else None)
    assert got.shape == want.shape == (E, 16, 16, 196)
    if not gated:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), _f32(want), atol=1e-5,
                                   rtol=0)
        return
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got)[:n_act], _f32(want)[:n_act],
                               atol=1.6e-2, rtol=0)
    # padded slots are written as zeros (the Pallas kernel leaves them
    # undefined; downstream segment sums must never see garbage)
    assert (got[n_act:] == 0).all()


def test_grouped4_plain_nan_coords_select_nothing():
    """Kernel #1 with NaN coords: the TPU kernel's hats select nothing,
    so those pixels read 0 at every level; the rest are unaffected."""
    E = 2
    f1, f2, coords = _inputs(3, E)
    coords[0, 2, 3] = np.nan
    coords[1, 5, :, 1] = np.nan          # y only
    coords[1, 7, 4, 0] = np.nan          # x only
    jl = _jax_levels(f1, f2, 8)
    dims = corr_pallas.pyramid_dims(16, 16)
    want = _f32(corr_pallas.lookup_pyramid_grouped4_nhwc(
        jl, jnp.asarray(coords), dims, interpret=True))
    got = corr_lookup.lookup_pyramid_grouped4(
        _torch_levels(jl), torch.from_numpy(coords), dims).numpy()
    assert np.isfinite(got).all()
    for e, y, x in ((0, 2, 3), (1, 5, 0), (1, 5, 9), (1, 7, 4)):
        assert (got[e, y, x] == 0).all()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_pyramid_plain_matches_pallas():
    """Kernel #2 (lookup_pyramid_pallas_nhwc) on a 4-level pyramid of
    unpadded levels, as the motion filter builds it (E = 1 at the main
    path; E = 2 here).  Exact bf16 taps with f32 weights summed in the
    same order: equal to f32 rounding (atol 1e-5 on values of order 1)."""
    E, H, W = 2, 12, 20
    f1, f2, coords = _inputs(7, E, H=H, W=W)
    vol = jcorr.build_volume(jnp.asarray(f1), jnp.asarray(f2))
    jl = tuple(v.astype(jnp.bfloat16) for v in jcorr.build_pyramid(vol))
    want = _f32(corr_pallas.lookup_pyramid_pallas_nhwc(
        jl, jnp.asarray(coords), interpret=True))
    got = corr_lookup.lookup_pyramid(_torch_levels(jl),
                                     torch.from_numpy(coords))
    assert got.dtype == torch.float32 and got.shape == (E, H, W, 196)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_pyramid_plain_matches_reference_lookup():
    """Kernel #2's plain version equals the gather reference
    (ops/corr.py CorrPyramid) on the same bf16 levels up to f32 rounding:
    the two sum the same four products in a different association."""
    E, H, W = 2, 10, 14
    f1, f2, coords = _inputs(9, E, H=H, W=W)
    t1, t2 = torch.from_numpy(f1), torch.from_numpy(f2)
    levels = [lv.to(torch.bfloat16) for lv in
              tcorr.build_pyramid(tcorr.build_volume(t1, t2))]
    c = torch.from_numpy(coords)
    got = corr_lookup.lookup_pyramid(levels, c)
    want = tcorr.CorrPyramid(levels)(c).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)


def test_wrappers_reject_bad_inputs():
    """The CUDA path checks its inputs before any launch; the checks run
    on CPU tensors too."""
    levels = [torch.zeros(1, 2, 2, 8, 4, dtype=torch.bfloat16)] * 4
    coords = torch.zeros(1, 2, 2, 2)
    corr_lookup._check_inputs(levels, coords)
    with pytest.raises(ValueError):
        corr_lookup._check_inputs(levels[:3], coords)
    with pytest.raises(ValueError):
        corr_lookup._check_inputs([lv.float() for lv in levels], coords)
    with pytest.raises(ValueError):
        corr_lookup._check_inputs(levels, coords.double())
    with pytest.raises(ValueError):
        corr_lookup._check_inputs(levels, torch.zeros(1, 3, 2, 2))


def _wide(level, seed):
    """A bf16 level scaled element by element by random powers of two over
    2^-12 .. 2^12 (exact in bf16): a changed order of summation or a
    rounding at another place would show."""
    rng = np.random.RandomState(seed)
    k = rng.randint(-12, 13, size=level.shape).astype(np.float32)
    return (level.astype(jnp.float32) * jnp.exp2(jnp.asarray(k))
            ).astype(jnp.bfloat16)


@pytest.mark.parametrize("gated", [False, True])
def test_grouped4_plain_wide_range_matches_pallas(gated):
    """Kernel #1's plain version against the Pallas kernel on slabs of a
    wide dynamic range (|v| up to about 2^9).  Both round the hats and the
    y-interpolated rows to bf16 at the same places, so they differ by at
    most the f32 rounding of the final two-term sum: one f32 ulp below
    2^9 is 6.1e-5, hence atol 1e-4; the gated output is bf16 on both
    sides, one bf16 ulp relative: rtol 2^-7."""
    E, n_act = 4, 2
    f1, f2, coords = _inputs(16, E)
    jl = tuple(_wide(lv, 7 + i) for i, lv in enumerate(_jax_levels(f1, f2,
                                                                   8)))
    assert float(jnp.abs(jl[0].astype(jnp.float32)).max()) > 64.0
    dims = corr_pallas.pyramid_dims(16, 16)
    kw = {"n_act": jnp.int32(n_act)} if gated else {}
    want = _f32(corr_pallas.lookup_pyramid_grouped4_nhwc(
        jl, jnp.asarray(coords), dims, interpret=True, **kw))
    got = _f32(corr_lookup.lookup_pyramid_grouped4(
        _torch_levels(jl), torch.from_numpy(coords), dims,
        torch.tensor([n_act], dtype=torch.int32) if gated else None))
    n = n_act if gated else E
    np.testing.assert_allclose(got[:n], want[:n], atol=1e-4,
                               rtol=2.0 ** -7 if gated else 0)


@pytest.mark.parametrize("addr,numel,width", [
    (0, 48 * 80, 4), (256, 2, 4), (4, 24 * 37 * 2, 4),   # aligned, even
    (2, 48 * 80, 2), (6, 10, 2), (1, 10, 2),             # base off a word
    (0, 5 * 9 * 5 * 9, 2), (4, 1, 2),                    # odd element count
    (0, 0, 4)])                                          # empty level
def test_grouped4_load_width_rule(addr, numel, width):
    """4-byte loads only where every aligned word around an in-bounds tap
    lies inside the tensor: a 4-byte aligned base and an even count.  Row
    pitches do not matter (150 or 74 bytes at feature width 75): the kernel
    realigns by the row's parity."""
    assert corr_lookup.load_width(addr, numel) == width
