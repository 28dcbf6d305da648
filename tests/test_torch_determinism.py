"""The port's segment sums against ``jax.ops.segment_sum``.

The port pools per-edge blocks by segment id in a fixed order
(``nerf_slam_tpu_torch/ops/segment.py``): the GRU's per-keyframe mean
(``segment_mean``) and the assembly of the reduced camera system
(``solver/dba.py``'s ``seg_sum``).  Inputs are made with numpy from a seed
and go through both packages; ids < 0 are dropped, as the JAX callers drop
them by sending them to an extra segment that they cut off.

Tolerances.  f32: the two sum the same values in different orders, so
they agree to a few f32 ulps of the largest partial sum (|x| summed over
the segment): 1e-6 of it.  bf16: the port sums in f32 and rounds once,
so it lies within one bf16 rounding (2^-8 relative) of the exact sum
plus the f32 error; JAX on the CPU may round each partial sum to bf16, so
the two agree within E roundings of the sum of |x|.  The card tests
(tests/test_torch_cuda.py) hold the sums to the same bits over repeated
calls.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nerf_slam_tpu_torch.models import update
from nerf_slam_tpu_torch.ops import segment
from nerf_slam_tpu_torch.solver import dba

BF16_U = 2.0 ** -8       # bf16 unit roundoff (8-bit significand)

# (ids, n_seg): repeated ids, dropped ids, empty segments, E = 1
CASES = {
    "repeated": ([3, 0, 3, 3, 1, 0, 3, 3], 5),
    "dropped": ([-1, 2, -1, 0, 2, -1], 4),
    "all_dropped": ([-1, -1, -1], 3),
    "empty_segments": ([6, 6, 1], 8),
    "one_edge": ([2], 3),
    "one_edge_dropped": ([-1], 2),
    "one_segment": ([0] * 9, 1),
}


def _jax_sum(x, ids, n_seg):
    """The JAX callers' segment sum: ids < 0 go to segment n_seg, cut."""
    safe = np.where(ids < 0, n_seg, ids)
    return jax.ops.segment_sum(jnp.asarray(x), jnp.asarray(safe),
                               num_segments=n_seg + 1)[:n_seg]


def _inputs(case, shape, seed):
    ids, n_seg = CASES[case]
    ids = np.asarray(ids, np.int64)
    rng = np.random.RandomState(seed)
    x = (rng.randn(ids.shape[0], *shape) * 2.0).astype(np.float32)
    return x, ids, n_seg


def _abs_sum(x, ids, n_seg):
    """Per-segment sum of |x| in f64: the scale of every partial sum."""
    out = np.zeros((n_seg,) + x.shape[1:])
    for e, s in enumerate(ids):
        if s >= 0:
            out[s] += np.abs(x[e].astype(np.float64))
    return out


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("shape", [(6, 6), (3, 4, 5)])
def test_segment_sum_f32_matches_jax(case, shape):
    x, ids, n_seg = _inputs(case, shape, 1)
    got = dba.seg_sum(torch.from_numpy(x), torch.from_numpy(ids), n_seg)
    want = np.asarray(_jax_sum(x, ids, n_seg))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * max(1.0, _abs_sum(x, ids,
                                                             n_seg).max()))
    empty = np.setdiff1d(np.arange(n_seg), ids)
    assert (got.numpy()[empty] == 0).all()


@pytest.mark.parametrize("case", sorted(CASES))
def test_segment_sum_bf16_rounds_once(case):
    """bf16 blocks: within one bf16 rounding of the exact (f64) sum, plus
    the f32 accumulation's error, and within E roundings of JAX's bf16
    segment sum; the result stays bf16."""
    x, ids, n_seg = _inputs(case, (4, 8), 2)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    x16 = xb.float().numpy()                    # the values actually summed
    got = segment.segment_sum(xb, torch.from_numpy(ids), n_seg)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    exact = np.zeros((n_seg, 4, 8))
    for e, s in enumerate(ids):
        if s >= 0:
            exact[s] += x16[e]
    scale = _abs_sum(x16, ids, n_seg)
    assert (np.abs(got - exact)
            <= BF16_U * np.abs(exact) + 1e-6 * scale + 1e-30).all()
    want = np.asarray(_jax_sum(jnp.asarray(x16, jnp.bfloat16), ids, n_seg)
                      .astype(jnp.float32))
    assert (np.abs(got - want) <= len(ids) * BF16_U * scale + 1e-30).all()


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segment_mean_matches_jax(case, dtype):
    """The GRU's per-keyframe mean against GraphAgg._pooled's (JAX)
    segment sum over the segment count; empty segments are 0."""
    x, ids, n_seg = _inputs(case, (3, 4, 8), 3)
    tdt = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(tdt)
    x_in = xt.float().numpy()
    got = update.segment_mean(xt, torch.from_numpy(ids), n_seg)
    assert got.dtype == tdt
    summed = np.asarray(_jax_sum(x_in, ids, n_seg))
    count = np.asarray(_jax_sum(np.ones(len(ids), np.float32), ids, n_seg))
    want = summed / np.maximum(count, 1.0)[:, None, None, None]
    scale = _abs_sum(x_in, ids, n_seg) / np.maximum(count, 1.0)[
        :, None, None, None]
    tol = (1e-6 * scale if dtype == "float32"
           else BF16_U * np.abs(want) + 1e-6 * scale)
    assert (np.abs(got.float().numpy() - want) <= tol + 1e-30).all()


def test_segment_sums_repeat_to_the_bit():
    """The same inputs give the same bits on every call (the card test
    holds the same at the tracker's shapes)."""
    rng = np.random.RandomState(4)
    ids = torch.from_numpy(rng.randint(-1, 5, size=40))
    x = torch.from_numpy(rng.randn(40, 6, 36).astype(np.float32))
    first = dba.seg_sum(x, ids, 6)
    xb = x.to(torch.bfloat16)
    first_mean = update.segment_mean(xb, ids, 6)
    for _ in range(5):
        assert torch.equal(dba.seg_sum(x, ids, 6), first)
        assert torch.equal(update.segment_mean(xb, ids, 6), first_mean)


# non-finite blocks: (ids, n_seg, [(row, column, value)]) -- the value is
# planted into row ``row`` at flat column ``column``
NONFINITE = {
    "dropped_inf": ([0, 1, 2, -1], 3, [(3, 0, np.inf)]),
    "dropped_nan_past_the_end": ([0, 5, 1, 1], 2, [(1, 2, np.nan)]),
    "kept_nan": ([0, 1, 1, 2], 3, [(1, 0, np.nan)]),
    "kept_pos_inf": ([0, 1, 2, 2], 3, [(2, 3, np.inf)]),
    "kept_neg_inf": ([2, 2, 0, -1], 3, [(0, 1, -np.inf)]),
    "pos_and_neg_inf_one_segment": ([1, 0, 1, 1], 2,
                                    [(0, 4, np.inf), (3, 4, -np.inf)]),
    "two_pos_inf_one_segment": ([1, 1, 0], 2, [(0, 2, np.inf),
                                               (1, 2, np.inf)]),
    "mixed": ([0, -1, 1, 0, 2, 1], 3, [(0, 0, np.nan), (1, 1, np.inf),
                                       (2, 1, -np.inf), (3, 5, np.inf),
                                       (5, 5, np.nan)]),
}


def _nonfinite_inputs(case, seed):
    ids, n_seg, plant = NONFINITE[case]
    ids = np.asarray(ids, np.int64)
    rng = np.random.RandomState(seed)
    x = (rng.randn(ids.shape[0], 2, 3) * 2.0).astype(np.float32)
    flat = x.reshape(ids.shape[0], -1)
    for r, c, v in plant:
        flat[r, c] = v
    return x, ids, n_seg


@pytest.mark.parametrize("case", sorted(NONFINITE))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segment_sum_nonfinite_matches_jax(case, dtype):
    """NaN and inf against ``jax.ops.segment_sum`` with the ids as they
    are (JAX drops ids outside [0, n_seg) itself): every NaN and every inf
    of the port's sum sits where JAX's does, with JAX's sign; the finite
    entries agree to the tolerances of the finite tests above (1e-6 of
    the segment's sum of |x| in f32, E bf16 roundings of it in bf16)."""
    x, ids, n_seg = _nonfinite_inputs(case, 5)
    tdt = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(tdt)
    x_in = xt.float().numpy()
    got = segment.segment_sum(xt, torch.from_numpy(ids), n_seg)
    assert got.dtype == tdt
    got = got.float().numpy()
    want = np.asarray(jax.ops.segment_sum(
        jnp.asarray(x_in, getattr(jnp, dtype)), jnp.asarray(ids),
        num_segments=n_seg).astype(jnp.float32))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isposinf(got), np.isposinf(want))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    scale = _abs_sum(np.where(np.isfinite(x_in), x_in, 0.0),
                     np.where(ids < n_seg, ids, -1), n_seg)
    tol = (1e-6 * np.maximum(scale, 1.0) if dtype == "float32"
           else len(ids) * BF16_U * scale + 1e-30)
    assert (np.abs(got[fin] - want[fin]) <= tol[fin]).all()
    # something non-finite survived where it should, and nothing leaked
    assert np.isfinite(want).sum() > 0


@pytest.mark.parametrize("case", sorted(NONFINITE))
def test_segment_mean_nonfinite_matches_jax(case):
    """The mean keeps each non-finite value in its own segment and column
    (NaN and inf divided by the count), like JAX's sum over the count."""
    x, ids, n_seg = _nonfinite_inputs(case, 6)
    got = update.segment_mean(torch.from_numpy(x), torch.from_numpy(ids),
                              n_seg).numpy()
    summed = np.asarray(jax.ops.segment_sum(
        jnp.asarray(x), jnp.asarray(ids), num_segments=n_seg))
    count = np.asarray(jax.ops.segment_sum(
        jnp.ones(len(ids)), jnp.asarray(ids), num_segments=n_seg))
    want = summed / np.maximum(count, 1.0)[:, None, None]
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got) * np.sign(got),
                                  np.isinf(want) * np.sign(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segment_sum_finite_bits_unchanged(dtype):
    """On finite blocks the sums are the one-hot product's bits, as before
    the non-finite handling: the tracker's reproducibility and its
    trajectory rest on them."""
    rng = np.random.RandomState(7)
    ids = torch.from_numpy(rng.randint(-1, 6, size=48))
    x = torch.from_numpy(rng.randn(48, 6, 36).astype(np.float32)) \
        .to(getattr(torch, dtype))
    hit = ids[None, :] == torch.arange(6)[:, None]
    plain = (hit.float() @ x.reshape(48, -1).float()).to(x.dtype) \
        .reshape(6, 6, 36)
    assert torch.equal(segment.segment_sum(x, ids, 6), plain)
    count = torch.clamp(hit.sum(1, keepdim=True), min=1)
    plain_mean = ((hit.float() @ x.reshape(48, -1).float()) / count) \
        .to(x.dtype).reshape(6, 6, 36)
    assert torch.equal(segment.segment_mean(x, ids, 6), plain_mean)


# the backward of the kernel's sums: (x dtype, what is differentiated)
GRAD_KINDS = [("float32", "sum"), ("float32", "mean"), ("bfloat16", "sum"),
              ("bfloat16", "mean"), ("bfloat16", "f32_sums")]
GRAD_CASES = {**{k: (ids, n, []) for k, (ids, n) in CASES.items()},
              **NONFINITE}


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
@pytest.mark.parametrize("dtype,kind", GRAD_KINDS)
def test_segment_sum_grad_matches_onehot_autograd(case, dtype, kind):
    """The gradient rule of the card's autograd Function, in plain PyTorch,
    against autograd through the one-hot product: g of the row's segment
    (over its count for a mean) for kept rows, 0 for dropped rows, at
    non-finite entries and in the (segment, column)s they poison; the
    same bits, cast to x's dtype."""
    ids, n_seg, plant = GRAD_CASES[case]
    ids = np.asarray(ids, np.int64)
    rng = np.random.RandomState(8)
    x = (rng.randn(ids.shape[0], 2, 3) * 2.0).astype(np.float32)
    flat = x.reshape(ids.shape[0], -1)
    for r, c, v in plant:
        flat[r, c] = v
    tdt = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    it = torch.from_numpy(ids)
    out_dt = torch.float32 if kind == "f32_sums" else tdt
    sums, count = segment.sums_plain(xt, it, n_seg, out_dt, kind == "mean")
    g = torch.from_numpy(rng.randn(*sums.shape).astype(np.float32)) \
        .to(out_dt)
    want, = torch.autograd.grad(sums, xt, g)
    got = segment.segment_sum_grad(g, xt.detach(), it, n_seg,
                                   count if kind == "mean" else None)
    assert got.dtype == tdt and got.shape == xt.shape
    assert torch.equal(got, want)
    if plant:
        assert (got.float().reshape(len(ids), -1)[
            ~torch.isfinite(xt.detach().float().reshape(len(ids), -1))]
            == 0).all()


def test_cpu_sums_launch_no_kernel():
    """CPU tensors take the plain version, with and without grad and over
    shards: the kernel's launch count stays 0, and its launcher refuses
    them."""
    rng = np.random.RandomState(9)
    x = torch.from_numpy(rng.randn(10, 3, 4).astype(np.float32))
    ids = torch.from_numpy(rng.randint(-1, 4, size=10))
    segment.reset_launches()
    segment.segment_sum(x, ids, 4)
    segment.segment_sum_count(x.to(torch.bfloat16), ids, 4)
    segment.segment_mean(x, ids, 4)
    segment.segment_mean([x[:6], x[6:]], [ids[:6], ids[6:]], 4)
    xg = x.clone().requires_grad_(True)
    segment.segment_mean(xg, ids, 4).sum().backward()
    assert xg.grad is not None
    assert segment.launches == {"segment_sum": 0}
    with pytest.raises(ValueError, match="CUDA"):
        segment._launch(x, ids, 4, torch.float32, False)
