"""The port's single-level and level-0 lookups, its ``CorrPyramidPallas``
and ``alt_corr_level`` against the JAX package (Pallas kernels in interpret
mode).

On the CPU each wrapper in ``nerf_slam_tpu_torch.ops.corr_lookup`` runs its
plain PyTorch version, which repeats the CUDA kernel's arithmetic op by op;
the CUDA kernels are held against the plain versions on the card by
``chip_smoke.py`` and tests/test_torch_cuda.py.  Shapes stay small: the
interpreted kernels are slow.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nerf_slam_tpu.ops import corr as jcorr
from nerf_slam_tpu.ops import corr_pallas
from nerf_slam_tpu_torch.ops import corr as tcorr
from nerf_slam_tpu_torch.ops import corr_lookup

# kernels #3 and #5 sample exact bf16 taps with f32 weights in one fixed
# term order on both sides: only the f32 rounding of four products of
# magnitude < 4 differs (XLA may contract a multiply-add)
TOL_EXACT = 1e-5


def _bf16(x):
    return torch.from_numpy(np.asarray(jnp.asarray(x).astype(jnp.float32))
                            ).to(torch.bfloat16)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _volume(seed, E, H1, W1, H2, W2):
    rng = np.random.RandomState(seed)
    vol = jnp.asarray(rng.randn(E, H1, W1, H2, W2).astype(np.float32)
                      ).astype(jnp.bfloat16)
    coords = (rng.rand(E, H1, W1, 2) * np.array([W2 + 2, H2 + 2]) - 1.5
              ).astype(np.float32)
    return vol, coords


def _features(seed, E, C, H, W):
    rng = np.random.RandomState(seed)
    f1 = (rng.randn(E, C, H, W) * 0.3).astype(np.float32)
    f2 = (rng.randn(E, C, H, W) * 0.3).astype(np.float32)
    coords = (rng.rand(E, H, W, 2) * np.array([W + 2., H + 2.]) - 1.5
              ).astype(np.float32)
    return f1, f2, coords


@pytest.mark.parametrize("shape", [(3, 6, 7, 9, 11), (2, 3, 16, 16, 11)])
def test_level_plain_matches_pallas(shape):
    """Kernel #3 (lookup_level_pallas_nhwc) and its channel-major wrapper,
    at the odd shape of tests/test_corr.py:153 and at an aligned one."""
    vol, coords = _volume(10, *shape)
    want = corr_pallas.lookup_level_pallas_nhwc(vol, jnp.asarray(coords),
                                                interpret=True)
    got = corr_lookup.lookup_level(_bf16(vol), torch.from_numpy(coords))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), _f32(want), atol=TOL_EXACT,
                               rtol=0)
    got_cm = corr_lookup.lookup_level_cm(_bf16(vol), torch.from_numpy(coords))
    want_cm = corr_pallas.lookup_level_pallas(vol, jnp.asarray(coords),
                                              interpret=True)
    np.testing.assert_allclose(got_cm.numpy(), _f32(want_cm),
                               atol=TOL_EXACT, rtol=0)


@pytest.mark.parametrize("fn", ["level", "grouped"])
def test_level_plain_empty_level_is_zero(fn):
    """An empty level (tiny images) has no taps: zeros on both sides."""
    E, H1, W1 = 2, 3, 16
    vol = torch.zeros(E, H1, W1, 0, 0, dtype=torch.bfloat16)
    coords = torch.rand(E, H1, W1, 2)
    tfn, jfn = {
        "level": (corr_lookup.lookup_level,
                  corr_pallas.lookup_level_pallas_nhwc),
        "grouped": (corr_lookup.lookup_level_grouped,
                    corr_pallas.lookup_level_pallas_grouped_nhwc)}[fn]
    got = tfn(vol, coords)
    want = jfn(jnp.zeros((E, H1, W1, 0, 0), jnp.bfloat16),
               jnp.asarray(coords.numpy()), interpret=True)
    assert got.shape == want.shape == (E, H1, W1, 49)
    assert (got == 0).all() and (np.asarray(want) == 0).all()


@pytest.mark.parametrize("shape,path", [((2, 3, 16, 16, 11), "grouped"),
                                        ((2, 3, 7, 9, 11), "fallback")])
def test_level_grouped_plain_matches_pallas(shape, path):
    """Kernel #5 (lookup_level_pallas_grouped_nhwc): W1 = 16 with 8-aligned
    rows takes the grouped Pallas kernel; the odd width of
    tests/test_corr.py:208 takes its fallback, kernel #3.  The port's
    function computes the same on both."""
    vol, coords = _volume(12, *shape)
    want = corr_pallas.lookup_level_pallas_grouped_nhwc(
        vol, jnp.asarray(coords), interpret=True)
    got = corr_lookup.lookup_level_grouped(_bf16(vol),
                                           torch.from_numpy(coords))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), _f32(want), atol=TOL_EXACT,
                               rtol=0)


def test_level_grouped_reads_row_padding_like_level():
    """The tracker hands kernel #5 row-padded slabs and no real dims: the
    padding rows are zeros and are sampled as such, so #5 on the padded
    slab equals #3 on the unpadded level."""
    f1, f2, coords = _features(5, 2, 16, 12, 16)
    t1, t2 = torch.from_numpy(f1), torch.from_numpy(f2)
    padded = tcorr.build_pyramid_bf16(t1, t2, 4, pad_rows_to=8)
    plain = tcorr.build_pyramid_bf16(t1, t2, 4)
    c = torch.from_numpy(coords)
    for lvl, (vp, v) in enumerate(zip(padded, plain)):
        assert vp.shape[-2] % 8 == 0
        got = corr_lookup.lookup_level_grouped(vp, c / 2 ** lvl)
        want = corr_lookup.lookup_level(v, c / 2 ** lvl)
        np.testing.assert_array_equal(got.numpy(), want.numpy())


def _l0_inputs(seed=16, E=2, C=16, H=18, W=20):
    # odd halving (18 -> 9 -> 4 -> 2, 20 -> 10 -> 5 -> 2): crops exercise
    # the masks, as tests/test_corr.py:264
    f1, f2, coords = _features(seed, E, C, H, W)
    vol0 = jcorr.build_pyramid_bf16(jnp.asarray(f1), jnp.asarray(f2), 1,
                                    pad_rows_to=8)[0]
    return f1, f2, coords, vol0, corr_pallas.pyramid_dims(H, W)


def test_l0_plain_matches_pallas():
    """Kernel #4 (lookup_pyramid_l0_nhwc).  Both sides sum a block's
    level-0 rows in f32, round to bf16, sum its columns in f32 and apply
    f32 weights carrying 4^-l.  An f32 sum of at most 8 bf16 values is
    exact here, so the bf16 roundings coincide and only the final four
    products' f32 rounding differs: block sums reach ~8 before the 4^-l
    scale, hence atol 1e-5."""
    _, _, coords, vol0, dims = _l0_inputs()
    want = corr_pallas.lookup_pyramid_l0_nhwc(vol0, jnp.asarray(coords),
                                              dims, interpret=True)
    got = corr_lookup.lookup_pyramid_l0(_bf16(vol0),
                                        torch.from_numpy(coords), dims)
    assert got.dtype == torch.float32
    assert got.shape == want.shape == (2, 18, 20, 196)
    np.testing.assert_allclose(got.numpy(), _f32(want), atol=1e-5, rtol=0)


def test_l0_plain_matches_per_level_lookup():
    """Kernel #4 against the per-level lookup (#3) on pooled levels, as
    tests/test_corr.py:264: pooling first and sampling after rounds at
    other places (each pooled level to bf16), so bf16 tolerance."""
    f1, f2, coords, vol0, dims = _l0_inputs()
    t1, t2 = torch.from_numpy(f1), torch.from_numpy(f2)
    levels = tcorr.build_pyramid_bf16(t1, t2, 4)
    c = torch.from_numpy(coords)
    got = corr_lookup.lookup_pyramid_l0(_bf16(vol0), c, dims)
    per = torch.cat([corr_lookup.lookup_level(v, c / 2 ** lvl)
                     for lvl, v in enumerate(levels)], dim=-1)
    np.testing.assert_allclose(got.numpy(), per.numpy(), atol=3e-2,
                               rtol=3e-2)


def test_l0_plain_ignores_padding_rows():
    """Rows of the slab beyond the real level-0 height never enter a block
    sum, whatever they hold."""
    _, _, coords, vol0, dims = _l0_inputs()
    v = _bf16(vol0)
    assert v.shape[-2] == 24 and dims[0][0] == 18
    c = torch.from_numpy(coords)
    want = corr_lookup.lookup_pyramid_l0(v, c, dims)
    v2 = v.clone()
    v2[..., 18:, :] = 7.0
    np.testing.assert_array_equal(
        corr_lookup.lookup_pyramid_l0(v2, c, dims).numpy(), want.numpy())


@pytest.mark.parametrize("grouped,width", [(False, 16), (True, 16),
                                           (True, 12)])
def test_corr_pyramid_pallas_nhwc_matches_jax(grouped, width):
    """CorrPyramidPallas.nhwc on row-padded slabs: ungrouped (kernel #2),
    grouped at W1 = 16 (kernel #5) and grouped at W1 = 12 (the JAX class
    falls back to kernel #3; so does the port's)."""
    f1, f2, coords = _features(21, 2, 16, 16, width)
    jl = jcorr.build_pyramid_bf16(jnp.asarray(f1), jnp.asarray(f2), 4,
                                  pad_rows_to=8)
    want = corr_pallas.CorrPyramidPallas(list(jl), interpret=True,
                                         grouped=grouped).nhwc(
        jnp.asarray(coords))
    got = tcorr.CorrPyramidPallas([_bf16(lv) for lv in jl],
                                  grouped=grouped).nhwc(
        torch.from_numpy(coords))
    assert got.shape == want.shape == (2, 16, width, 196)
    np.testing.assert_allclose(got.numpy(), _f32(want), atol=TOL_EXACT,
                               rtol=0)


def test_corr_pyramid_pallas_routes_like_jax(monkeypatch):
    """Which lookup each configuration reaches (the launch counters on the
    card count exactly these calls)."""
    calls = []
    for name in ("lookup_pyramid", "lookup_level", "lookup_level_grouped"):
        real = getattr(corr_lookup, name)
        monkeypatch.setattr(
            corr_lookup, name,
            lambda *a, _n=name, _r=real: calls.append(_n) or _r(*a))

    def run(width, grouped, n_levels=4, rows=8):
        calls.clear()
        levels = [torch.zeros(1, 2, width, rows, 4, dtype=torch.bfloat16)
                  for _ in range(n_levels)]
        tcorr.CorrPyramidPallas(levels, grouped=grouped).nhwc(
            torch.zeros(1, 2, width, 2))
        return list(calls)

    assert run(16, False) == ["lookup_pyramid"]
    assert run(16, True) == ["lookup_level_grouped"] * 4
    assert run(12, True) == ["lookup_level"] * 4          # W1 % 16 != 0
    assert run(16, True, rows=6) == ["lookup_level"] * 4  # H2 % 8 != 0
    assert run(16, False, n_levels=2) == ["lookup_level"] * 2


def test_corr_pyramid_pallas_call_matches_jax():
    """from_volume + __call__ (channel-major, kernel #3 per level) against
    the JAX class, on a volume whose last level is 1x1."""
    f1, f2, coords = _features(11, 2, 16, 8, 10)
    vol = jcorr.build_volume(jnp.asarray(f1), jnp.asarray(f2))
    want = corr_pallas.CorrPyramidPallas.from_volume(vol, interpret=True)(
        jnp.asarray(coords))
    tvol = torch.from_numpy(np.asarray(vol))
    cp = tcorr.CorrPyramidPallas.from_volume(tvol)
    assert [tuple(v.shape[-2:]) for v in cp.levels] == \
        [(8, 10), (4, 5), (2, 2), (1, 1)]
    got = cp(torch.from_numpy(coords))
    assert got.shape == want.shape == (2, 196, 8, 10)
    np.testing.assert_allclose(got.numpy(), _f32(want), atol=TOL_EXACT,
                               rtol=0)


def test_corr_pyramid_cat_and_index():
    """CorrPyramid.cat / __getitem__ (edge add and remove), as
    tests/test_corr.py:101."""
    f1, f2, coords = _features(4, 3, 8, 6, 8)
    cp = tcorr.CorrPyramid.build(torch.from_numpy(f1), torch.from_numpy(f2))
    cp2 = cp.cat(cp)
    assert cp2.levels[0].shape[0] == 6
    cp3 = cp2[torch.tensor([0, 2, 4])]
    assert cp3.levels[0].shape[0] == 3
    # cp2 = cp ++ cp, so slots (0, 2, 4) hold cp's edges (0, 2, 1)
    c = torch.from_numpy(coords)[[0, 2, 1]]
    want = tcorr.CorrPyramid([lv[[0, 2, 1]] for lv in cp.levels])(c)
    np.testing.assert_array_equal(cp3(c).numpy(), want.numpy())


def test_alt_corr_level_matches_jax():
    """alt_corr_level against the JAX function and, as
    tests/test_corr.py:87, against the lookup from the volume.  f32 dot
    products of 8 terms of magnitude ~1/16 summed in another order:
    atol 1e-5 against JAX, 1e-4 against the volume path."""
    rng = np.random.RandomState(3)
    E, C, H, W = 3, 8, 5, 6
    f1 = rng.randn(E, C, H, W).astype(np.float32)
    f2 = rng.randn(E, C, H, W).astype(np.float32)
    coords = (rng.rand(E, H, W, 2) * np.array([W + 2, H + 2]) - 1.5
              ).astype(np.float32)
    want = jcorr.alt_corr_level(jnp.asarray(f1), jnp.asarray(f2),
                                jnp.asarray(coords), radius=3, chunk=1)
    t1, t2, c = (torch.from_numpy(a) for a in (f1, f2, coords))
    got = tcorr.alt_corr_level(t1, t2, c, radius=3, chunk=2)
    assert got.shape == want.shape == (E, 49, H, W)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    vol = tcorr.lookup_level(tcorr.build_volume(t1, t2), c, 3)
    np.testing.assert_allclose(got.numpy(), vol.numpy(), atol=1e-4, rtol=0)


def test_level_wrappers_reject_bad_inputs():
    """The one-level and one-slab wrappers check their inputs before any
    launch; the checks run on CPU tensors too."""
    vol = torch.zeros(1, 2, 2, 8, 4, dtype=torch.bfloat16)
    coords = torch.zeros(1, 2, 2, 2)
    corr_lookup._check_inputs([vol], coords, n_levels=1)
    with pytest.raises(ValueError):
        corr_lookup._check_inputs([vol, vol], coords, n_levels=1)
    with pytest.raises(ValueError):
        corr_lookup._check_inputs([vol.float()], coords, n_levels=1)
    with pytest.raises(ValueError):
        corr_lookup._check_inputs([vol[..., ::2]], coords, n_levels=1)
    with pytest.raises(ValueError):
        corr_lookup._check_inputs([vol], torch.zeros(2, 2, 2, 2), n_levels=1)


def test_l0_plain_wide_range_matches_pallas():
    """Kernel #4's plain version against the Pallas kernel on a slab
    scaled element by element by random powers of two over 2^-12 .. 2^12
    (outputs up to about 300).  Sums of such values are no longer exact in
    f32, and the Pallas kernel forms a block's row sums as one MXU
    contraction over all slab rows, in the backend's order, where the
    plain version (like the CUDA kernel) adds row after row: a row sum may
    land on the other side of a bf16 rounding boundary.  So: all outputs
    within one bf16 ulp of the largest output (2^-8 relative to it), and
    all but 1 in 1000 within the f32 rounding of four products of that
    magnitude (one f32 ulp below 512 is 6.1e-5: atol 2.5e-4)."""
    _, _, coords, vol0, dims = _l0_inputs()
    rng = np.random.RandomState(11)
    k = rng.randint(-12, 13, size=vol0.shape).astype(np.float32)
    wide = (vol0.astype(jnp.float32) * jnp.exp2(jnp.asarray(k))
            ).astype(jnp.bfloat16)
    want = _f32(corr_pallas.lookup_pyramid_l0_nhwc(
        wide, jnp.asarray(coords), dims, interpret=True))
    got = corr_lookup.lookup_pyramid_l0(_bf16(wide),
                                        torch.from_numpy(coords), dims)
    err = np.abs(got.numpy() - want)
    top = np.abs(want).max()
    assert 64.0 < top < 512.0
    assert err.max() <= top * 2.0 ** -8
    assert (err > 2.5e-4).mean() < 1e-3


@pytest.mark.parametrize("addr,h2p,w2,plan", [
    (0, 48, 80, ("bulk", True)),          # the tracking slab
    (256, 48, 75, ("bulk", False)),       # odd width: 2-byte loads
    (0, 8, 9, ("bulk", False)),
    (0, 16, 14, ("bulk", True)),
    (2, 48, 80, ("coop", True)),          # base 2 bytes off
    (8, 48, 80, ("coop", True)),          # base 8 bytes off
    (0, 7, 9, ("coop", False)),           # plane of 126 bytes
    (0, 7, 14, ("coop", True)),           # plane of 196 bytes
    (0, 0, 0, ("bulk", True)),            # empty slab: nothing is read
    (0, 64, 112, ("bulk", True)),         # 14,336-byte planes: 8 stages fit
    (0, 120, 120, ("coop", True)),        # 8 stages do not fit, 4 do
    (0, 240, 240, ("direct", True)),      # one plane a warp does not fit
    (2, 240, 240, ("direct", False)),     # device-memory words misaligned
    (0, 240, 241, ("direct", False))])
def test_l0_plan_rule(addr, h2p, w2, plan):
    """How the level-0 kernel reaches a slab, from its address and shape:
    the copy engine needs 16-byte aligned planes of a multiple of 16
    bytes and room for L0_WARPS x L0_STAGES of them; else the warps stage
    one plane each with 2-byte loads; a plane that does not fit is summed
    from device memory.  Pairs of taps come as one 4-byte load where the
    width is even (and, from device memory, the base 4-byte aligned)."""
    mode = {"bulk": corr_lookup.L0_BULK, "coop": corr_lookup.L0_COOP,
            "direct": corr_lookup.L0_DIRECT}[plan[0]]
    assert corr_lookup.l0_plan(addr, h2p, w2) == (mode, plan[1])
    stage = (h2p * w2 * 2 + 15) // 16 * 16
    n_stages = {"bulk": corr_lookup.L0_STAGES, "coop": 1, "direct": 0}[plan[0]]
    assert corr_lookup.L0_WARPS * n_stages * stage + corr_lookup.L0_FIXED \
        <= corr_lookup.L0_SMEM_MAX
