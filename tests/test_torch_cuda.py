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
from nerf_slam_tpu_torch.ops import corr, corr_lookup
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
    first_m = update.segment_mean(xm, im, 28)
    first_e = dba.seg_sum(xe, ie, 672)
    for _ in range(20):
        assert torch.equal(update.segment_mean(xm, im, 28), first_m)
        assert torch.equal(dba.seg_sum(xe, ie, 672), first_e)
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
