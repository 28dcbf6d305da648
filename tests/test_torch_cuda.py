"""The port's CUDA kernels on the card, against their plain versions.

These tests need an NVIDIA GPU and skip without one.  They import no JAX,
so they also run where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py configures JAX for the CPU tests.)
``chip_smoke.py`` repeats the comparisons at the main path's shapes.
"""
import copy
import os

import numpy as np
import pytest
import torch

from nerf_slam_tpu_torch.models import update
from nerf_slam_tpu_torch.ops import corr, corr_lookup, segment
from nerf_slam_tpu_torch.solver import dba

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
    assert torch.equal(got, corr_lookup.lookup_pyramid_plain(levels, c))


@pytest.mark.parametrize("E,H,W", [(2, 16, 16), (3, 10, 14), (2, 7, 9)])
def test_level_kernels_match_plain(dev, E, H, W):
    """Kernels #3 and #5, level by level on row-padded and unpadded slabs
    (7 rows halve down to an empty last level), coords in level units; each
    counts under its own name."""
    f1, f2, c = _inputs(dev, E + W, E, H, W)
    before = dict(corr_lookup.launches)
    n = 0
    for pad in (1, 8):
        for lvl, vol in enumerate(corr.build_pyramid_bf16(f1, f2, 4,
                                                          pad_rows_to=pad)):
            cl = (c / 2 ** lvl).contiguous()
            for fn, plain in (
                    (corr_lookup.lookup_level,
                     corr_lookup.lookup_level_plain),
                    (corr_lookup.lookup_level_grouped,
                     corr_lookup.lookup_level_grouped_plain)):
                got = fn(vol, cl)
                torch.cuda.synchronize()
                assert got.shape == (E, H, W, 49)
                torch.testing.assert_close(got, plain(vol, cl),
                                           atol=TOL_F32, rtol=0)
            torch.testing.assert_close(
                corr_lookup.lookup_level_cm(vol, cl),
                corr_lookup.lookup_level_plain(vol, cl).permute(0, 3, 1, 2),
                atol=TOL_F32, rtol=0)
            n += int(vol.shape[-2] > 0)      # an empty level launches nothing
    assert corr_lookup.launches["corr_lookup_level"] == \
        before["corr_lookup_level"] + 2 * n
    assert corr_lookup.launches["corr_lookup_level_grouped"] == \
        before["corr_lookup_level_grouped"] + n


def test_level_kernel_empty_level_launches_nothing(dev):
    vol = torch.zeros(2, 3, 5, 0, 0, dtype=torch.bfloat16, device=dev)
    c = torch.rand(2, 3, 5, 2, device=dev)
    before = dict(corr_lookup.launches)
    out = corr_lookup.lookup_level(vol, c)
    assert out.shape == (2, 3, 5, 49) and (out == 0).all()
    assert corr_lookup.launches == before


@pytest.mark.parametrize("E,H,W", [(2, 16, 16), (3, 18, 20), (2, 7, 9),
                                   (1, 42, 80)])
def test_l0_kernel_matches_plain(dev, E, H, W):
    """Kernel #4 on a row-padded level-0 slab: even halving, odd halving
    (crops), a last level of 0 rows, and the tracking shape.  Far
    coordinates exercise the clipped window starts."""
    f1, f2, c = _inputs(dev, E + H, E, H, W)
    c[0, 0, :2] = torch.tensor([[-40.0, 3.0], [1e4, 1e4]], device=dev)
    vol0 = corr.build_pyramid_bf16(f1, f2, 1, pad_rows_to=8)[0]
    dims = corr_lookup.pyramid_dims(H, W)
    before = corr_lookup.launches["corr_lookup_l0"]
    got = corr_lookup.lookup_pyramid_l0(vol0, c, dims)
    torch.cuda.synchronize()
    assert corr_lookup.launches["corr_lookup_l0"] == before + 1
    assert got.shape == (E, H, W, 196) and got.dtype == torch.float32
    torch.testing.assert_close(
        got, corr_lookup.lookup_pyramid_l0_plain(vol0, c, dims),
        atol=TOL_F32, rtol=0)
    with pytest.raises(ValueError):
        corr_lookup.lookup_pyramid_l0(vol0, c, ((H + 8, W),) + dims[1:])


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


# ---------------------------------------------------------------------------
# the redesigned kernels (#1 one warp per pixel-edge with word loads, #4
# staged planes): shapes that decide their load widths and copy modes
# ---------------------------------------------------------------------------

def _wide(vol, seed):
    """``vol`` scaled element by element by random powers of two over
    2^-12 .. 2^12 (exact in bf16): sums of such values round differently
    in another order, so an order change shows as a bit difference."""
    rng = np.random.RandomState(seed)
    k = torch.from_numpy(rng.randint(-12, 13, size=tuple(vol.shape))
                         .astype(np.float32)).to(vol.device)
    return (vol.float() * torch.exp2(k)).to(torch.bfloat16)


def _misaligned(v):
    """A contiguous copy of ``v`` whose first element lies 2 bytes past a
    4-byte boundary."""
    buf = torch.empty(v.numel() + 1, dtype=v.dtype, device=v.device)
    out = buf[1:].view(v.shape)
    out.copy_(v)
    assert out.data_ptr() % 4 == 2 and out.is_contiguous()
    return out


def _far(c):
    """Coords whose windows lie wholly outside every level."""
    c = c.clone()
    c[..., 0::2, :, :] = -40.0
    c[..., 1::2, :, :] = 1e4
    return c


@pytest.mark.parametrize("E,H,W,pad", [(2, 6, 75, 8), (1, 5, 9, 1),
                                       (3, 4, 14, 8), (1, 5, 9, 8),
                                       (2, 16, 16, 8)])
@pytest.mark.parametrize("variant", ["plain", "wide", "misaligned", "far",
                                     "nan"])
def test_grouped4_kernel_edges(dev, E, H, W, pad, variant):
    """Kernel #1 bit for bit against its plain version at widths whose row
    pitches are only 2-byte aligned (75, 9), at an odd element count
    (1x5x9 unpadded: 2-byte loads), from a base 2 bytes off, with windows
    wholly out of bounds, NaN coords, E = 1, n_act of 0 and of E, and on
    slabs of a wide dynamic range."""
    f1, f2, c = _inputs(dev, 3 * E + W, E, H, W)
    slabs = corr.build_pyramid_bf16(f1, f2, 4, pad_rows_to=pad)
    if variant == "wide":
        slabs = [_wide(v, 7 + i) for i, v in enumerate(slabs)]
    elif variant == "misaligned":
        slabs = [_misaligned(v) if v.numel() else v for v in slabs]
        assert corr_lookup.load_width(slabs[0].data_ptr(),
                                      slabs[0].numel()) == 2
    elif variant == "far":
        c = _far(c)
    elif variant == "nan":
        c[0, 1, 2] = float("nan")
        c[-1, 2, :, 0] = float("nan")
    dims = corr_lookup.pyramid_dims(H, W)
    for n in (None, 0, E, max(E - 1, 0)):
        na = None if n is None else torch.tensor([n], dtype=torch.int32,
                                                 device=dev)
        got = corr_lookup.lookup_pyramid_grouped4(slabs, c, dims, na)
        want = corr_lookup.lookup_pyramid_grouped4_plain(slabs, c, dims, na)
        torch.cuda.synchronize()
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.isfinite(got.float()).all()
        assert torch.equal(got, want), \
            f"n_act={n}: max |err| {(got.float() - want.float()).abs().max()}"
        if n is not None:
            assert (got[n:] == 0).all()
        if variant == "far":
            assert (got == 0).all()


@pytest.mark.parametrize("E,H,W,pad", [(2, 6, 75, 8), (1, 7, 9, 1),
                                       (2, 12, 14, 8), (1, 7, 9, 8),
                                       (1, 42, 80, 8)])
@pytest.mark.parametrize("variant", ["plain", "wide", "misaligned", "far",
                                     "poison"])
def test_l0_kernel_edges(dev, E, H, W, pad, variant):
    """Kernel #4 bit for bit against its plain version: odd widths (2-byte
    loads), planes that are no multiple of 16 bytes or start 2 bytes off
    (staged by the warp, not by the copy engine), windows wholly out of
    bounds, poisoned padding rows, E = 1, a wide dynamic range."""
    f1, f2, c = _inputs(dev, 5 * E + W, E, H, W)
    vol0 = corr.build_pyramid_bf16(f1, f2, 1, pad_rows_to=pad)[0]
    dims = corr_lookup.pyramid_dims(H, W)
    mode, pair = corr_lookup.l0_plan(vol0.data_ptr(), *vol0.shape[-2:])
    assert pair == (W % 2 == 0)
    assert mode == (corr_lookup.L0_BULK if (vol0.shape[-2] * W) % 8 == 0
                    else corr_lookup.L0_COOP)
    if variant == "wide":
        vol0 = _wide(vol0, 11)
    elif variant == "misaligned":
        vol0 = _misaligned(vol0)
        assert corr_lookup.l0_plan(vol0.data_ptr(), *vol0.shape[-2:]) == \
            (corr_lookup.L0_COOP, W % 2 == 0)
    elif variant == "far":
        c = _far(c)
    want = corr_lookup.lookup_pyramid_l0_plain(vol0, c, dims)
    if variant == "poison":
        vol0 = vol0.clone()
        vol0[..., H:, :] = 7.0
    got = corr_lookup.lookup_pyramid_l0(vol0, c, dims)
    torch.cuda.synchronize()
    assert got.shape == (E, H, W, 196) and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    assert torch.equal(got, want), \
        f"max |err| {(got - want).abs().max()}"
    if variant == "far":
        assert (got == 0).all()


@pytest.mark.parametrize("W2", [240, 241])
def test_l0_kernel_plane_beyond_shared_memory(dev, W2):
    """Kernel #4 on planes too large to stage (2 x 2 pixels of 240 x 240
    and 240 x 241): summed straight from device memory, still bit-equal."""
    rng = np.random.RandomState(W2)
    vol0 = torch.from_numpy(rng.randn(1, 2, 2, 240, W2).astype(np.float32)
                            ).to(dev).to(torch.bfloat16)
    c = torch.from_numpy((rng.rand(1, 2, 2, 2) * 240).astype(np.float32)
                         ).to(dev)
    dims = corr_lookup.pyramid_dims(240, W2)
    assert corr_lookup.l0_plan(vol0.data_ptr(), 240, W2) == \
        (corr_lookup.L0_DIRECT, W2 % 2 == 0)
    got = corr_lookup.lookup_pyramid_l0(vol0, c, dims)
    torch.cuda.synchronize()
    assert torch.equal(got, corr_lookup.lookup_pyramid_l0_plain(vol0, c,
                                                                dims))


@pytest.mark.parametrize("E,H,W,pad", [(2, 6, 75, 8), (1, 5, 9, 1),
                                       (3, 4, 14, 8), (1, 5, 9, 8),
                                       (2, 16, 16, 8), (1, 7, 9, 1),
                                       (2, 12, 14, 8), (1, 42, 80, 8)])
@pytest.mark.parametrize("variant", ["plain", "wide", "misaligned", "far",
                                     "nan"])
def test_level_kernel_edges(dev, E, H, W, pad, variant):
    """Kernels #3 and #5 (one device kernel, eight lanes a pixel) bit for
    bit against lookup_level_plain at every level of the shapes the
    grouped4 and level-0 tests use: odd widths (row pitches only 2-byte
    aligned), odd element counts and bases 2 bytes off (2-byte loads),
    planes smaller than the window, row-padded and unpadded slabs, pixel
    counts that leave a warp part-filled, E = 1, windows wholly out of
    bounds, NaN coords (NaN out, as in the plain version) and a wide
    dynamic range."""
    f1, f2, c = _inputs(dev, 7 * E + W, E, H, W)
    if variant == "far":
        c = _far(c)
    elif variant == "nan":
        c[0, 1, 2] = float("nan")
        c[-1, 2, :, 0] = float("nan")
    slabs = corr.build_pyramid_bf16(f1, f2, 4, pad_rows_to=pad)
    for lvl, vol in enumerate(slabs):
        if vol.numel() == 0:
            continue                # no taps: the wrapper launches nothing
        if variant == "wide":
            vol = _wide(vol, 13 + lvl)
        elif variant == "misaligned":
            vol = _misaligned(vol)
        cl = (c / 2 ** lvl).contiguous()
        want = corr_lookup.lookup_level_plain(vol, cl)
        nan = torch.isnan(want)
        assert bool(nan.any()) == (variant == "nan")
        for fn in (corr_lookup.lookup_level,
                   corr_lookup.lookup_level_grouped):
            got = fn(vol, cl)
            torch.cuda.synchronize()
            assert got.shape == want.shape and got.dtype == torch.float32
            assert torch.equal(torch.isnan(got), nan)
            assert torch.equal(got[~nan], want[~nan]), \
                f"level {lvl}: max |err| {(got - want)[~nan].abs().max()}"
            if variant == "far":
                assert (got == 0).all()


@pytest.mark.parametrize("E,H,W", [(1, 42, 80), (3, 10, 14), (2, 7, 9),
                                   (1, 5, 11)])
@pytest.mark.parametrize("variant", ["plain", "wide", "misaligned", "far",
                                     "nan"])
def test_pyramid_kernel_edges(dev, E, H, W, variant):
    """Kernel #2 (the grouped4 kernel's exact mode) bit for bit against
    lookup_pyramid_plain: the motion filter's shape (E = 1, 42 x 80; levels
    42x80 .. 5x10), E = 3, odd widths W1 (row pitches only 2-byte aligned,
    odd element counts: 2-byte loads), level bases 2 bytes off, windows
    wholly out of bounds, NaN coords (NaN out, as in the plain version)
    and a wide dynamic range."""
    f1, f2, c = _inputs(dev, 11 * E + W, E, H, W)
    levels = [lv.to(torch.bfloat16).contiguous() for lv in
              corr.build_pyramid(corr.build_volume(f1, f2))]
    if variant == "wide":
        levels = [_wide(v, 17 + i) for i, v in enumerate(levels)]
    elif variant == "misaligned":
        levels = [_misaligned(v) if v.numel() else v for v in levels]
        assert all(corr_lookup.load_width(v.data_ptr(), v.numel()) == 2
                   for v in levels if v.numel())
    elif variant == "far":
        c = _far(c)
    elif variant == "nan":
        c[0, 1, 2] = float("nan")
        c[-1, 2, :, 0] = float("nan")
    want = corr_lookup.lookup_pyramid_plain(levels, c)
    before = corr_lookup.launches["corr_lookup_pyramid"]
    got = corr_lookup.lookup_pyramid(levels, c)
    torch.cuda.synchronize()
    assert corr_lookup.launches["corr_lookup_pyramid"] == before + 1
    assert got.shape == (E, H, W, 196) and got.dtype == torch.float32
    nan = torch.isnan(want)
    assert bool(nan.any()) == (variant == "nan")
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan], want[~nan]), \
        f"max |err| {(got - want)[~nan].abs().max()}"
    if variant == "far":
        assert (got == 0).all()


# ---------------------------------------------------------------------------
# bit-reproducibility: the segment sums and a whole update round
# ---------------------------------------------------------------------------

def test_segment_sums_repeat_bit_for_bit(dev):
    """The GRU's per-keyframe mean (bf16, 48 edges over 6 keyframes at the
    336x640 feature shape) and the coupling assembly's sum (f32, 96 edges
    over 672 segments) give the same bits on 20 calls, with heavily
    repeated ids; both within their rounding of the f64 sums.
    ``index_add_``, which adds with atomics, does not repeat its bits."""
    rng = np.random.RandomState(0)
    ids_m = rng.randint(-1, 6, size=48)
    x_m = torch.from_numpy(rng.randn(48, 42, 80, 128).astype(np.float32))
    ids_e = rng.randint(-1, 40, size=96)
    x_e = torch.from_numpy(rng.randn(96, 6, 3360).astype(np.float32))
    xm, xe = x_m.to(dev).to(torch.bfloat16), x_e.to(dev)
    im, ie = torch.from_numpy(ids_m).to(dev), torch.from_numpy(ids_e).to(dev)
    segment.reset_launches()
    first_m = update.segment_mean(xm, im, 28)
    first_e = dba.seg_sum(xe, ie, 672)
    for _ in range(20):
        assert torch.equal(update.segment_mean(xm, im, 28), first_m)
        assert torch.equal(dba.seg_sum(xe, ie, 672), first_e)
    assert segment.launches == {"segment_sum": 42}        # the kernel's
    for x, ids, n, got, mean in ((xm.cpu().double(), ids_m, 28, first_m,
                                  True),
                                 (x_e.double(), ids_e, 672, first_e, False)):
        want = torch.zeros((n,) + tuple(x.shape[1:]), dtype=torch.float64)
        cnt = torch.zeros(n, dtype=torch.float64)
        for e, s in enumerate(ids):
            if s >= 0:
                want[s] += x[e]
                cnt[s] += 1
        scale = torch.zeros_like(want)
        for e, s in enumerate(ids):
            if s >= 0:
                scale[s] += x[e].abs()
        if mean:
            d = cnt.clamp(min=1).reshape(-1, *[1] * (x.dim() - 1))
            want, scale = want / d, scale / d
        u = 2.0 ** -8 if mean else 0.0          # one bf16 rounding
        err = (got.cpu().double() - want).abs()
        assert (err <= u * want.abs() + 1e-6 * scale + 1e-30).all()


WEIGHTS = os.path.join(os.path.dirname(__file__), "..",
                       "weights_synthetic.npz")


def test_update_round_repeats_bit_for_bit(dev):
    """One whole RaftVisualFrontend.update round (GRU iterations, DBA,
    export tail) from the same state gives the same bits on 20 calls: the
    trained weights in bf16 on 96x128 frames, several edges per keyframe
    (repeated segment ids in the GRU's mean and the DBA's sums)."""
    from nerf_slam_tpu_torch.datasets import (SyntheticConfig,
                                              SyntheticDataset)
    from nerf_slam_tpu_torch.models import DroidNet, load_flax_weights
    from nerf_slam_tpu_torch.tracking import (FrontendConfig,
                                              RaftVisualFrontend)
    from nerf_slam_tpu_torch.utils.checkpoint import load_arrays

    flat, meta = load_arrays(WEIGHTS)
    net = load_flax_weights(DroidNet(dtype=torch.bfloat16), flat)
    H, W = 96, 128
    cfg = FrontendConfig(buffer=12, e_active=24, e_inactive=16, p_window=12,
                         k_depth=14, keyframe_warmup=4, max_factors=20,
                         motion_filter_thresh=-1.0, keyframe_thresh=-1.0,
                         damping_scale=float(meta["damping_scale"]),
                         damping_offset=float(meta["damping_offset"]))
    fe = RaftVisualFrontend(net, cfg, (H, W), device=dev)
    ds = SyntheticDataset(SyntheticConfig(n_frames=30, height=H, width=W))
    for k in range(7):
        fe(k, ds[k])
    assert fe.is_initialized and fe.graph.n_edges > 6
    assert len(set(fe.graph.ii.tolist())) < fe.graph.n_edges
    snap = copy.deepcopy({k: v for k, v in vars(fe).items() if k != "net"})
    runs = []
    for _ in range(20):
        vars(fe).update(copy.deepcopy(snap))
        assert fe.update(n_iters=2) is True
        st = fe.state
        runs.append([t.clone() for t in (
            st.cam_T_world, st.idepths, st.damping, st.idepths_up,
            st.pose_cov, st.idepths_cov, fe.edges.hidden, fe.edges.flow)])
    torch.cuda.synchronize()
    assert all(torch.isfinite(t.float()).all() for t in runs[0])
    for r in runs[1:]:
        for a, b in zip(runs[0], r):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the map backends on the card against the same code on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grid", [
    dict(n_levels=4, log2_table_size=10, base_resolution=8,
         finest_resolution=64), {}], ids=["small", "default"])
def test_hash_encode_on_card_matches_cpu(dev, grid):
    """The hash encode and its backward on the card: indices equal to the
    CPU's, features within 1e-6, the table and position gradients within
    1e-5 of their largest entry (the bits are held by
    test_hash_table_gradient_fixed_order_on_card).  TF32 off: full f32
    products."""
    from nerf_slam_tpu_torch.fusion import hashgrid
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = hashgrid.HashGridConfig(**grid)
    rng = np.random.RandomState(3)
    pos = torch.from_numpy(rng.rand(20000, 3).astype(np.float32))
    table = torch.from_numpy(rng.uniform(-1, 1, (
        cfg.n_levels, cfg.table_size, cfg.n_features)).astype(np.float32))
    g = torch.from_numpy(rng.randn(20000, cfg.out_dim).astype(np.float32))
    idx_c = hashgrid._corner_indices_weights(pos, cfg)[0]
    idx_d = hashgrid._corner_indices_weights(pos.to(dev), cfg)[0]
    assert torch.equal(idx_d.cpu(), idx_c)
    outs = []
    for d in ("cpu", dev):
        t = table.to(d).detach().requires_grad_(True)
        p = pos.to(d).detach().requires_grad_(True)
        out = hashgrid.encode_chunked(t, p, cfg, 8192)
        out.backward(g.to(d))
        outs.append([x.detach().cpu() for x in (out, t.grad, p.grad)])
    (oc, tc, pc), (od, td, pd) = outs
    torch.testing.assert_close(od, oc, atol=1e-6, rtol=0)
    for got, want in ((td, tc), (pd, pc)):
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=1e-5 * float(want.abs().max()))


def test_hash_table_gradient_fixed_order_on_card(dev):
    """The fixed-order table gradient of the default hash grid (20,000
    points in chunks of 8192): five calls on the card give the same bits,
    and they equal the CPU's, since both add each table row's terms one
    after another in the same order."""
    from nerf_slam_tpu_torch.fusion import hashgrid
    cfg = hashgrid.HashGridConfig()
    rng = np.random.RandomState(4)
    pos = torch.from_numpy((0.3 + 0.4 * rng.rand(20000, 3)).astype(
        np.float32))
    table = torch.from_numpy(rng.uniform(-1, 1, (
        cfg.n_levels, cfg.table_size, cfg.n_features)).astype(np.float32))
    g = torch.from_numpy(rng.randn(20000, cfg.out_dim).astype(np.float32))

    def grad(d):
        t = table.to(d).detach().requires_grad_(True)
        hashgrid.encode_chunked(t, pos.to(d), cfg, 8192).backward(g.to(d))
        return t.grad

    first = grad(dev)
    for _ in range(4):
        assert torch.equal(grad(dev), first)
    assert torch.equal(first.cpu(), grad("cpu"))
    # the scatter alone, on many colliding terms
    idx = torch.from_numpy(rng.randint(0, 300, size=200000).astype(np.int32))
    vals = torch.from_numpy((rng.randn(200000, 2) * 10.0 ** rng.uniform(
        -6, 6, (200000, 1))).astype(np.float32))
    on_card = hashgrid._scatter_rows(idx.to(dev), vals.to(dev), 301)
    assert torch.equal(on_card.cpu(), hashgrid._scatter_rows(idx, vals, 301))


def test_segment_sum_nonfinite_on_card_matches_cpu(dev):
    """Non-finite blocks at the DBA assembly's shape (96 edges, 6 x 3360
    entries, 40 segments): NaN and +-inf planted in dropped rows (id -1
    and past the end) and in kept ones.  The kernel's sum has its NaN and
    inf exactly where the CPU's has them, with their signs, and the
    finite entries agree within 1e-6 of the segment's sum of |x| (the
    CPU's GEMM adds in another order); they are the bits of the rows
    added in ascending order, and a second call repeats them."""
    rng = np.random.RandomState(5)
    ids = rng.randint(0, 40, size=96)
    ids[::7] = -1
    ids[3] = 45
    x = (rng.randn(96, 6, 3360) * 2.0).astype(np.float32)
    flat = x.reshape(96, -1)
    for r, v in ((0, np.nan), (3, np.inf), (7, -np.inf), (10, np.nan),
                 (11, np.inf), (12, -np.inf), (20, np.inf), (21, -np.inf)):
        flat[r, rng.randint(0, flat.shape[1], size=50)] = v
    ids[20] = ids[21] = 5                 # +inf and -inf meet: NaN
    xt, it = torch.from_numpy(x), torch.from_numpy(ids)
    want = dba.seg_sum(xt, it, 40)
    segment.reset_launches()
    got = dba.seg_sum(xt.to(dev), it.to(dev), 40)
    again = dba.seg_sum(xt.to(dev), it.to(dev), 40)
    assert segment.launches == {"segment_sum": 2}         # the kernel's
    assert torch.equal(again.view(torch.int32), got.view(torch.int32))
    # the rows added in ascending order: the same bits, NaN and inf too
    assert _same_bits(got.reshape(40, -1), _in_row_order(
        xt.to(dev), it.to(dev), 40, torch.float32, False)[0])
    got = got.cpu()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.isposinf(got), torch.isposinf(want))
    assert torch.equal(torch.isneginf(got), torch.isneginf(want))
    assert torch.isnan(want).any() and torch.isinf(want).any()
    fin = torch.isfinite(want)
    scale = torch.zeros_like(want)
    for e, sg in enumerate(ids):
        if 0 <= sg < 40:
            scale[sg] += torch.where(torch.isfinite(xt[e]), xt[e], 0).abs()
    assert ((got - want).abs()[fin] <= 1e-6 * scale[fin] + 1e-30).all()


def test_stereo_frontend_repeats_bit_for_bit(dev):
    """The stereo tracker (trained weights in bf16, 96x128 stereo frames
    of the synthetic room, filters off) twice on fresh state: the same
    keyframes, poses, inverse depths and right-camera features to the
    bit, with (i, i) stereo edges in the graph and finite outputs."""
    from nerf_slam_tpu_torch.datasets import (SyntheticConfig,
                                              SyntheticDataset)
    from nerf_slam_tpu_torch.models import DroidNet, load_flax_weights
    from nerf_slam_tpu_torch.tracking import (FrontendConfig,
                                              RaftVisualFrontend)
    from nerf_slam_tpu_torch.utils.checkpoint import load_arrays

    flat, meta = load_arrays(WEIGHTS)
    net = load_flax_weights(DroidNet(dtype=torch.bfloat16), flat)
    H, W = 96, 128
    cfg = FrontendConfig(buffer=12, e_active=32, e_inactive=16, p_window=12,
                         k_depth=14, keyframe_warmup=4, max_factors=24,
                         motion_filter_thresh=-1.0, keyframe_thresh=-1.0,
                         stereo=True,
                         damping_scale=float(meta["damping_scale"]),
                         damping_offset=float(meta["damping_offset"]))
    ds = SyntheticDataset(SyntheticConfig(n_frames=30, height=H, width=W,
                                          stereo=True, baseline=0.1))
    frames = [ds[k] for k in range(8)]
    runs = []
    for _ in range(2):
        fe = RaftVisualFrontend(net, cfg, (H, W), device=dev)
        for k, f in enumerate(frames):
            fe(k, f)
        st = fe.state
        assert int((fe.graph.ii == fe.graph.jj).sum()) > 0
        runs.append([t.clone() for t in (
            st.timestamps, st.cam_T_world, st.idepths, st.features1,
            fe.edges.flow)])
    assert all(torch.isfinite(t.float()).all() for t in runs[0])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_tsdf_integrate_on_card_matches_cpu(dev):
    """Three frames of the synthetic room into a 64^3 volume on the card
    and on the CPU: tsdf, weight and color within 1e-5 but for voxels
    whose projection rounds across a .5 pixel boundary in one of them (at
    most 0.1% of the grid); the ray cast of the card's volume sees the
    surface."""
    from nerf_slam_tpu_torch.datasets import SyntheticConfig, SyntheticDataset
    from nerf_slam_tpu_torch.fusion import TsdfFusion, TsdfFusionConfig
    ds = SyntheticDataset(SyntheticConfig(n_frames=9, height=60, width=80,
                                          seed=21, n_objects=4))
    rng = np.random.RandomState(0)
    fusions = [TsdfFusion(TsdfFusionConfig(grid_size=64), device=d)
               for d in ("cpu", dev)]
    for k in (0, 4, 8):
        p = ds[k]
        cov = rng.uniform(0.0, 40.0, (60, 80)).astype(np.float32)
        for f in fusions:
            f.integrate_frame(np.linalg.inv(p["poses"]), p["intrinsics"],
                              p["depths"], cov, p["images"])
    (tc, wc, cc), (td, wd, cd) = [[v.cpu() for v in f.volume]
                                  for f in fusions]
    bad = ((td - tc).abs() > 1e-5) | ((wd - wc).abs() > 1e-5 * wc.clamp(
        min=1)) | ((cd - cc).abs() > 1e-5).any(dim=0)
    assert int((wc > 0).sum()) > 2000
    assert int(bad.sum()) <= 1e-3 * 64 ** 3, int(bad.sum())
    p = ds[4]
    rgb, depth = fusions[1].render(p["poses"], p["intrinsics"], (60, 80))
    assert np.isfinite(rgb).all() and (depth > 0).mean() > 0.5



def test_mesh_renderer_on_card_matches_cpu(dev):
    """The ground-truth mesh renderer on the card against the CPU on a
    random triangle soup: the same pixels hit, depths within 1e-5."""
    from nerf_slam_tpu_torch.utils.evaluation import MeshRenderer
    rng = np.random.RandomState(4)
    n = 300
    centers = rng.randn(n, 3) * [0.8, 0.6, 0.3] + [0, 0, 3.0]
    verts = (centers[:, None, :] + rng.randn(n, 3, 3) * 0.4).reshape(-1, 3)
    mesh = (verts.astype(np.float32),
            np.arange(3 * n, dtype=np.int32).reshape(n, 3))
    c2w = np.eye(4)
    c2w[:3, 3] = [0.1, -0.05, 0.2]
    depths = [MeshRenderer(mesh, (60.0, 56.0, 39.5, 30.0), (80, 60),
                           tri_chunk=128, px_chunk=1024,
                           device=d).render_mesh(c2w) for d in ("cpu", dev)]
    assert (depths[0] > 0).mean() > 0.3
    np.testing.assert_array_equal(depths[1] > 0, depths[0] > 0)
    np.testing.assert_allclose(depths[1], depths[0], atol=1e-5)


def test_flow_distance_matrix_on_card_matches_cpu(dev):
    """``utils.rgbd``'s flow-distance matrix, both variants, on the card
    against the CPU: the same pairs valid, values within 1e-5 relative."""
    from nerf_slam_tpu_torch.geometry import se3
    from nerf_slam_tpu_torch.utils import rgbd
    n, h, w = 7, 12, 16
    c2w = np.tile(np.eye(4), (n, 1, 1))
    a = 0.25 * np.arange(n)
    c2w[:, 0, 3], c2w[:, 2, 3] = np.sin(a), -2.0 + (1 - np.cos(a))
    poses = se3.from_matrix(torch.as_tensor(np.linalg.inv(c2w),
                                            dtype=torch.float32)).numpy()
    disps = np.full((n, h, w), 0.5, np.float32) + np.linspace(
        0, 0.2, w, dtype=np.float32)
    intr = np.array([20.0, 20.0, w / 2, h / 2], np.float32)
    for beta in (None, 0.4):
        cpu, card = [rgbd.compute_distance_matrix_flow(
            poses, disps, intr, beta=beta, chunk=16, device=d)
            for d in ("cpu", dev)]
        assert (np.isinf(cpu) == np.isinf(card)).all()
        fin = np.isfinite(cpu)
        np.testing.assert_allclose(card[fin], cpu[fin], rtol=1e-5,
                                   atol=1e-6)


def test_device_peak_flops_names_the_card(dev):
    from nerf_slam_tpu_torch.utils.runtime import device_peak_flops
    name, bf16 = device_peak_flops()
    assert name == torch.cuda.get_device_name(0)
    if "H100 80GB HBM3" in name:
        assert bf16 == 989e12 and device_peak_flops("f32")[1] == 67e12


# ---------------------------------------------------------------------------
# the dense BA replayed as a CUDA graph
# ---------------------------------------------------------------------------

# the benchmark's tracker: edge slots, pose window, depth slots, buffer
DBA_E, DBA_P, DBA_K, DBA_N = 96, 32, 40, 100
# (kf0, kf1, earlier frames with edges into the window) per call: three
# plans per case, each with padded edge and depth slots
DBA_WINDOWS = {"gauge": [(0, 12, 0), (0, 16, 0), (0, 20, 0)],
               "padded": [(30, 38, 2), (41, 47, 1), (52, 62, 3)],
               "stereo": [(20, 30, 2), (33, 41, 1), (50, 59, 3)],
               "sparse": [(10, 20, 2), (24, 33, 1), (60, 70, 3)]}


def _dba_problem(dev, seed, h, w, window, case):
    """A dense BA call at the tracker's padded shapes: a trajectory and
    depths with flow targets from them plus noise, the starting point
    perturbed, edges |i - j| <= 3 inside the window ``(kf0, kf1)`` and
    from ``n_old`` earlier frames into it (stereo: an (i, i) edge a
    frame), some sensed depths.  Returns dba_iterations' arguments."""
    from nerf_slam_tpu_torch.geometry import camera, se3

    kf0, kf1, n_old = window
    rng = np.random.RandomState(seed)
    xi = np.zeros((DBA_N, 6), np.float32)
    xi[:, 0] = np.arange(DBA_N) * 0.05
    xi += rng.randn(DBA_N, 6).astype(np.float32) * 0.01
    gt = se3.exp(torch.from_numpy(xi)).to(dev)
    disps_gt = torch.from_numpy(
        rng.uniform(0.5, 1.5, (DBA_N, h, w)).astype(np.float32)).to(dev)
    intr = torch.tensor([[0.9 * w, 0.9 * w, w / 2, h / 2]],
                        device=dev).repeat(DBA_N, 1)
    edges = [(i, j) for i in range(kf0 - n_old, kf1)
             for j in range(kf0, kf1) if i != j and abs(i - j) <= 3]
    rig = None
    if case == "stereo":
        edges += [(i, i) for i in range(kf0, kf1)]
        rig = se3.exp(torch.tensor([-0.1, 0, 0, 0, 0, 0.0])).to(dev)
    edges = edges[:DBA_E - 3]
    ii = np.array([e[0] for e in edges])
    jj = np.array([e[1] for e in edges])
    p = dba.plan(ii, jj, kf0, kf1, DBA_E, DBA_P, DBA_K, device=dev)
    if case == "sparse":
        pa, pb, pv = dba.compute_pairs(
            *(t.cpu().numpy() for t in (p.pi, p.pj, p.kk)),
            p.edge_valid.cpu().numpy() > 0, pad_to=1024)
        p = p._replace(**{k: torch.as_tensor(v, device=dev) for k, v in
                          (("pair_a", pa.astype(np.int64)),
                           ("pair_b", pb.astype(np.int64)),
                           ("pair_valid", pv))})
    else:
        p = p._replace(pair_a=None, pair_b=None, pair_valid=None)
    n = len(edges)
    tgt, _, _ = camera.projective_transform(
        gt, disps_gt, intr, p.ii[:n], p.jj[:n], stereo_rel=rig)
    targets = torch.zeros((DBA_E, h, w, 2), device=dev)
    targets[:n] = tgt + torch.from_numpy(
        rng.randn(n, h, w, 2).astype(np.float32) * 0.05).to(dev)
    weights = torch.zeros((DBA_E, h, w, 2), device=dev)
    weights[:n] = torch.from_numpy(
        rng.uniform(0.3, 1.0, (n, h, w, 2)).astype(np.float32)).to(dev)
    pert = np.concatenate([rng.randn(DBA_N, 3) * 0.02,
                           rng.randn(DBA_N, 3) * 0.01], -1)
    poses = se3.retr(gt, torch.from_numpy(pert.astype(np.float32)).to(dev))
    disps = disps_gt * torch.from_numpy(rng.uniform(
        0.8, 1.2, (DBA_N, h, w)).astype(np.float32)).to(dev)
    eta = torch.from_numpy(rng.uniform(
        1e-3, 1e-2, (DBA_K, h, w)).astype(np.float32)).to(dev)
    sens = disps_gt[p.kx] * (torch.arange(DBA_K, device=dev) % 3 == 0
                             )[:, None, None]
    return (poses, disps, intr, targets, weights, eta, sens, p), \
        dict(iters=2, stereo_rel=rig)


@pytest.mark.parametrize("case", ["gauge", "padded", "stereo", "sparse"])
@pytest.mark.parametrize("h,w", [(48, 64), (43, 77)])
def test_dba_graph_replay_equals_eager(dev, monkeypatch, case, h, w):
    """dba_iterations on the card replays a CUDA graph of the eager
    steps: over three calls whose plans and values differ, the poses and
    inverse depths equal the eager solve's to the bit; one capture, a
    replay on every call (the first included), no eager solve; a later
    replay leaves an earlier call's returned tensors unchanged."""
    monkeypatch.setattr(dba, "_GRAPHS", {})
    before = dict(dba.GRAPH_COUNTS)
    kept = []
    for call, window in enumerate(DBA_WINDOWS[case]):
        args, kw = _dba_problem(dev, 100 * call + h, h, w, window, case)
        got = dba.dba_iterations(*args, **kw)
        want = dba._iterations(*args, ep=0.1, lm=1e-4, shards=None, **kw)
        assert all(torch.isfinite(t).all() for t in got)
        assert (got[0] != args[0]).any()                     # a real step
        for g, e in zip(got, want):
            assert torch.equal(g, e)
        kept.append((got, [t.clone() for t in got]))
    for got, copy_ in kept:
        assert all(torch.equal(a, b) for a, b in zip(got, copy_))
    assert dba.GRAPH_COUNTS == dict(
        before, capture=before["capture"] + 1,
        replay=before["replay"] + len(DBA_WINDOWS[case]))
    assert len(dba._GRAPHS) == 1


@pytest.mark.parametrize("case", ["shards", "requires_grad"])
def test_dba_graph_not_under_shards_or_grad(dev, monkeypatch, case):
    """On the card, a call with edge shards or with an input that
    requires grad runs the eager steps: no capture, the eager bits."""
    monkeypatch.setattr(dba, "_GRAPHS", {})
    args, kw = _dba_problem(dev, 7, 48, 64, DBA_WINDOWS["padded"][0],
                            "padded")
    args, kw["shards"] = list(args), None
    if case == "requires_grad":
        args[1] = args[1].clone().requires_grad_(True)
    else:
        p, half = args[7], DBA_E // 2
        kw["shards"] = [dba.EdgeShard(p._replace(**{
            k: getattr(p, k)[sl] for k in
            ("ii", "jj", "pi", "pj", "kk", "edge_valid")}),
            args[3][sl], args[4][sl])
            for sl in (slice(0, half), slice(half, None))]
    before = dict(dba.GRAPH_COUNTS)
    got = dba.dba_iterations(*args, **kw)
    want = dba._iterations(*args, ep=0.1, lm=1e-4, **kw)
    assert dba.GRAPH_COUNTS == dict(before, eager=before["eager"] + 1)
    assert not dba._GRAPHS
    for g, e in zip(got, want):
        assert torch.equal(g, e)


# ---------------------------------------------------------------------------
# the segment-sum kernel against the one-hot product (its plain version)
# ---------------------------------------------------------------------------

def _assembly_ids(dev):
    """The dense BA's segment ids at the benchmark's shapes, from a plan
    with padded edge and depth slots (ids -1 there and for poses outside
    the window): (ids, n_seg) of Hgrid (4E into P * P), v (2E into P),
    C/w (E into K), Ehat (2E into P * K) and the GRU pool (48 edges into
    K)."""
    kf0, kf1, n_old = DBA_WINDOWS["padded"][2]
    edges = [(i, j) for i in range(kf0 - n_old, kf1)
             for j in range(kf0, kf1) if i != j and abs(i - j) <= 3]
    p = dba.plan(np.array([e[0] for e in edges]),
                 np.array([e[1] for e in edges]), kf0, kf1, DBA_E, DBA_P,
                 DBA_K, device=dev)

    def pair(a, b, n):
        return torch.where((a >= 0) & (b >= 0), a * n + b, -1)

    pp = torch.cat([p.pi, p.pj])
    return {"hgrid": (pair(torch.cat([p.pi, p.pi, p.pj, p.pj]),
                           torch.cat([p.pi, p.pj, p.pi, p.pj]), DBA_P),
                      DBA_P * DBA_P),
            "v": (pp, DBA_P), "cw": (p.kk, DBA_K),
            "ehat": (pair(pp, torch.cat([p.kk, p.kk]), DBA_K),
                     DBA_P * DBA_K),
            "pool": (torch.where(p.edge_valid[:48] > 0, p.kk[:48], -1),
                     DBA_K)}


# name: (ids, row shape, dtype, output: "sum", "mean" or "f32_sums"); ids
# are _assembly_ids' or (ids, n_seg) written out
SEG_CASES = {
    "ehat": ("ehat", (6, 3072), torch.float32, "sum"),
    "pool_mean": ("pool", (48, 64, 128), torch.bfloat16, "mean"),
    "pool_sum": ("pool", (48, 64, 128), torch.bfloat16, "sum"),
    "pool_shard_sums": ("pool", (48, 64, 128), torch.bfloat16, "f32_sums"),
    "hgrid": ("hgrid", (6, 6), torch.float32, "sum"),
    "cw": ("cw", (2, 3072), torch.float32, "sum"),
    "v_scalar_loads": ("v", (6,), torch.float32, "sum"),
    "bf16_scalar_loads": (([2, -1, 0, 2, 5, 2], 6), (3, 5), torch.bfloat16,
                          "mean"),
    "one_row_empty_segments": (([3], 5), (6, 3072), torch.float32, "sum"),
    "all_dropped": (([-1, 7, -1], 3), (8, 8), torch.float32, "mean"),
}


def _seg_call(x, ids, n_seg, out):
    """The public entry each output kind takes: (sums, counts or None)."""
    if out == "f32_sums":
        return segment.segment_sum_count(x, ids, n_seg)
    fn = segment.segment_mean if out == "mean" else segment.segment_sum
    return fn(x, ids, n_seg), None


def _in_row_order(x, ids, n_seg, dtype, mean):
    """The kernel's function spelled out with tensor ops: per segment its
    rows added one after another in ascending order, in f32 from +0
    (elementwise IEEE additions), divided by max(count, 1) for a mean,
    rounded once to ``dtype``.  Returns (sums (n_seg, F), counts)."""
    flat = x.reshape(ids.shape[0], -1).float()
    out = torch.zeros((n_seg, flat.shape[1]), device=x.device)
    count = torch.zeros((n_seg, 1), dtype=torch.int64, device=x.device)
    for r, s in enumerate(ids.tolist()):
        if 0 <= s < n_seg:
            out[s] = out[s] + flat[r]
            count[s] += 1
    if mean:
        out = out / torch.clamp(count, min=1)
    return out.to(dtype), count


def _same_bits(a, b) -> bool:
    """Equal, NaN where NaN: bit-for-bit up to NaN payloads."""
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan],
                                                            b[~nan])


@pytest.mark.parametrize("name", sorted(SEG_CASES))
def test_segment_sum_kernel_matches_onehot(dev, name):
    """The kernel at the tracker's shapes (the dense BA's four sums, the
    GRU pool as mean, sum and shard sums) and at the edges (one element a
    load, one row, empty segments, every row dropped), one launch a call:
    the bits and counts of its rows added in ascending order, and within
    f32 rounding of the one-hot product on the card (1e-6 of the
    segment's sum of |x|, plus one rounding of a bf16 output): cuBLAS
    accumulates some shapes in another order (``chip_smoke.py`` prints
    where the two differ)."""
    key, shape, dtype, out = SEG_CASES[name]
    ids, n_seg = (_assembly_ids(dev)[key] if isinstance(key, str)
                  else (torch.tensor(key[0], device=dev), key[1]))
    g = torch.Generator(device=dev).manual_seed(len(name))
    x = (2.0 * torch.randn((ids.shape[0],) + shape, generator=g,
                           device=dev)).to(dtype)
    out_dt = torch.float32 if out == "f32_sums" else dtype
    segment.reset_launches()
    got, count = _seg_call(x, ids, n_seg, out)
    assert segment.launches == {"segment_sum": 1}
    got = got.reshape(n_seg, -1)
    want, want_count = _in_row_order(x, ids, n_seg, out_dt, out == "mean")
    torch.cuda.synchronize()
    assert got.dtype == out_dt
    assert torch.equal(got, want), \
        f"max |err| {(got.float() - want.float()).abs().max()}"
    if count is not None:
        assert torch.equal(count, want_count)
    hit = (ids[None, :] == torch.arange(n_seg, device=dev)[:, None]).any(1)
    assert (got[~hit] == 0).all()
    plain = segment.sums_plain(x, ids, n_seg, out_dt, out == "mean")[0]
    scale = _in_row_order(x.abs(), ids, n_seg, torch.float32,
                          out == "mean")[0]
    tol = 1e-6 * scale + (2.0 ** -8 * plain.float().abs()
                          if out_dt == torch.bfloat16 else 0.0)
    assert ((got.float() - plain.float()).abs() <= tol + 1e-30).all()


def test_segment_sum_kernel_in_cuda_graph(dev):
    """Captured under ``torch.cuda.graph`` (the DBA's solve graph
    captures it so) the kernel launches once at capture, and each replay
    gives the eager call's bits for the values copied in."""
    ids, n_seg = _assembly_ids(dev)["ehat"]
    g = torch.Generator(device=dev).manual_seed(11)
    static_x = torch.randn((ids.shape[0], 6, 3072), generator=g, device=dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):               # eager first: the library
        segment.segment_sum(static_x, ids, n_seg)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    segment.reset_launches()
    with torch.cuda.graph(graph):
        out = segment.segment_sum(static_x, ids, n_seg)
    assert segment.launches == {"segment_sum": 1}
    for _ in range(3):
        new = torch.randn(static_x.shape, generator=g, device=dev)
        static_x.copy_(new)
        graph.replay()
        assert torch.equal(out, segment.segment_sum(new, ids, n_seg))
    assert segment.launches == {"segment_sum": 4}


@pytest.mark.parametrize("dtype,out", [(torch.float32, "sum"),
                                       (torch.bfloat16, "mean"),
                                       (torch.bfloat16, "f32_sums")])
def test_segment_sum_kernel_gradient_matches_plain(dev, dtype, out):
    """With grad the kernel's sums go through its autograd Function: the
    forward gives the row-order sums' bits and the one-hot product's NaN
    and inf, and the gradient equals the one-hot product's on the card,
    NaN and inf planted in kept and dropped rows included."""
    ids = torch.tensor([0, -1, 1, 0, 2, 1, 9, 2, 0, 3], device=dev)
    g = torch.Generator(device=dev).manual_seed(12)
    x = torch.randn((10, 6, 64), generator=g, device=dev).to(dtype)
    x[0, 0, 3], x[1, 2, 2], x[4, 5, 7] = float("nan"), float("inf"), \
        -float("inf")
    x[6, 1, 1], x[7, 5, 7] = float("nan"), float("inf")     # NaN in seg 2
    x[8, 3, 3] = float("inf")
    xk = x.clone().requires_grad_(True)
    xp = x.clone().requires_grad_(True)
    segment.reset_launches()
    got = _seg_call(xk, ids, 4, out)[0].reshape(4, -1)
    want = segment.sums_plain(
        xp, ids, 4, torch.float32 if out == "f32_sums" else dtype,
        out == "mean")[0]
    gout = torch.randn(want.shape, generator=g, device=dev).to(want.dtype)
    gk, = torch.autograd.grad(got, xk, gout)
    gp, = torch.autograd.grad(want, xp, gout)
    assert _same_bits(got, _in_row_order(
        x, ids, 4, want.dtype, out == "mean")[0])
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    assert torch.isinf(want).any()
    assert gk.dtype == dtype and torch.equal(gk, gp)
    assert segment.launches["segment_sum"] >= 2     # forward, backward
