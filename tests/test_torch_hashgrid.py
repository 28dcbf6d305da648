"""The port's hash-grid encoding against the JAX package's
(``fusion/hashgrid.py``): the corner indices and trilinear weights, the
encode forward, and its hand-written backward (the table and position
gradients against ``jax.vjp`` of the JAX encode), on the same numpy
positions and table."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nerf_slam_tpu.fusion import hashgrid as jhash
from nerf_slam_tpu_torch.fusion import hashgrid as thash

# 4 levels at resolutions 8, 16, 32, 64 over a 2^10 table: the first
# level's 9^3 corners fit the table (dense index), the others hash
SMALL = dict(n_levels=4, log2_table_size=10, base_resolution=8,
             finest_resolution=64)


def _cfgs(**kw):
    return jhash.HashGridConfig(**kw), thash.HashGridConfig(**kw)


def _positions(n, seed):
    """Points in the cube, a few outside it (clamped) and some exactly on
    a level's cell boundaries."""
    rng = np.random.RandomState(seed)
    p = rng.rand(n, 3).astype(np.float32)
    p[:8] = rng.uniform(-0.2, 1.2, (8, 3))
    p[8:16] = np.round(p[8:16] * 8) / 8
    return p


def test_resolutions_and_dense_switch():
    cj, ct = _cfgs(**SMALL)
    np.testing.assert_array_equal(ct.resolutions(), cj.resolutions())
    dense = (ct.resolutions() + 1) ** 3 <= ct.table_size
    assert dense.tolist() == [True, False, False, False]


@pytest.mark.parametrize("kw", [SMALL, {}], ids=["small", "default"])
def test_corner_indices_weights_match(kw):
    """Indices equal; weights within 1e-7.  At the default 2^19 table
    (16 levels, finest 2048: dense and hashed levels, corner coordinates
    up to 2049) only the index math is run."""
    cj, ct = _cfgs(**kw)
    p = _positions(512, 0)
    ij, wj, fj = jhash._corner_indices_weights(jnp.asarray(p), cj)
    it, wt, ft = thash._corner_indices_weights(torch.from_numpy(p), ct)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), atol=1e-7)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), atol=1e-7)


def _table(cfg, seed):
    rng = np.random.RandomState(seed)
    # larger than the init range so that the gradients are not all tiny
    return rng.uniform(-1, 1, (cfg.n_levels, cfg.table_size,
                               cfg.n_features)).astype(np.float32)


def test_encode_forward_and_backward_match():
    """f32 throughout.  Forward within 1e-6; the table and position
    gradients against jax.vjp within 1e-5 relative to their largest
    entry: the scatter-adds sum colliding corners in another order."""
    cj, ct = _cfgs(**SMALL)
    p = _positions(300, 1)
    table = _table(ct, 2)
    g = np.random.RandomState(3).randn(300, ct.out_dim).astype(np.float32)

    out_j, vjp = jax.vjp(lambda t, q: jhash.encode(t, q, cj),
                         jnp.asarray(table), jnp.asarray(p))
    dt_j, dp_j = vjp(jnp.asarray(g))

    tt = torch.from_numpy(table).requires_grad_(True)
    pt = torch.from_numpy(p).requires_grad_(True)
    out_t = thash.encode(tt, pt, ct)
    out_t.backward(torch.from_numpy(g))

    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               atol=1e-6)
    for got, want in ((tt.grad, dt_j), (pt.grad, dp_j)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def test_encode_skips_the_gradients_nobody_asks_for():
    """Positions without requires_grad (rays in the train step) get no
    position gradient; the table gradient is the same."""
    _, ct = _cfgs(**SMALL)
    p = torch.from_numpy(_positions(64, 4))
    t1 = torch.from_numpy(_table(ct, 5)).requires_grad_(True)
    t2 = t1.detach().clone().requires_grad_(True)
    thash.encode(t1, p, ct).sum().backward()
    pg = p.clone().requires_grad_(True)
    thash.encode(t2, pg, ct).sum().backward()
    assert p.grad is None and pg.grad is not None
    assert torch.equal(t1.grad, t2.grad)


def test_encode_chunked_equals_encode():
    """Chunks of 37 points (the last one short) give the same features
    and the same table gradient as one call, up to the order in which the
    table gradient's chunks are summed (1e-6 of its largest entry)."""
    _, ct = _cfgs(**SMALL)
    p = torch.from_numpy(_positions(200, 6)).reshape(10, 20, 3)
    t1 = torch.from_numpy(_table(ct, 7)).requires_grad_(True)
    t2 = t1.detach().clone().requires_grad_(True)
    a = thash.encode(t1, p, ct)
    b = thash.encode_chunked(t2, p, ct, 37)
    assert b.shape == (10, 20, ct.out_dim)
    assert torch.equal(a, b)
    g = torch.randn(a.shape, generator=torch.Generator().manual_seed(0))
    a.backward(g)
    b.backward(g)
    torch.testing.assert_close(t2.grad, t1.grad, rtol=0,
                               atol=1e-6 * float(t1.grad.abs().max()))


def test_init_table_range():
    _, ct = _cfgs(**SMALL)
    t = thash.init_table(ct, torch.Generator().manual_seed(0))
    assert t.shape == (4, 1024, 2) and t.dtype == torch.float32
    assert float(t.abs().max()) <= 1e-4 and float(t.std()) > 4e-5


def _table_grads(cj, ct, p, table, g):
    _, vjp = jax.vjp(lambda t: jhash.encode(t, jnp.asarray(p), cj),
                     jnp.asarray(table))
    (dt_j,) = vjp(jnp.asarray(g))
    tt = torch.from_numpy(table).requires_grad_(True)
    thash.encode(tt, torch.from_numpy(p), ct).backward(torch.from_numpy(g))
    return tt.grad, np.asarray(dt_j)


def test_table_gradient_fixed_order_matches_jax_vjp():
    """Many points in a few cells, so that every table row sums dozens of
    colliding corner terms: the fixed-order table gradient against
    jax.vjp of the JAX encode.  Both add each row's terms in the same
    order (corner by corner, then level, then point); JAX's CPU scatter
    may group them otherwise, so the bound is 1e-6 of the largest entry
    (measured: equal)."""
    cj, ct = _cfgs(**SMALL)
    p = (0.45 + 0.1 * np.random.RandomState(8).rand(2000, 3)) \
        .astype(np.float32)
    table = _table(ct, 9)
    g = np.random.RandomState(10).randn(2000, ct.out_dim).astype(np.float32)
    got, want = _table_grads(cj, ct, p, table, g)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


def test_scatter_rows_adds_in_sequence_and_repeats():
    """The table-gradient scatter equals adding the terms one by one in
    their order (values spread over 16 decades, so another order would
    round differently), and a second call gives the same bits."""
    rng = np.random.RandomState(11)
    idx = torch.from_numpy(rng.randint(0, 40, size=3000).astype(np.int32))
    vals = torch.from_numpy((rng.randn(3000, 2) * 10.0 ** rng.uniform(
        -8, 8, (3000, 1))).astype(np.float32))
    ref = torch.zeros(41, 2)
    for k in range(3000):
        ref[idx[k]] = ref[idx[k]] + vals[k]
    got = thash._scatter_rows(idx, vals, 41)
    assert torch.equal(got, ref)
    assert torch.equal(thash._scatter_rows(idx, vals, 41), got)


def test_table_gradient_repeats_to_the_bit():
    """The encode's table gradient, computed twice from the same inputs,
    gives the same bits (the card test holds the same on the GPU)."""
    _, ct = _cfgs(**SMALL)
    p = torch.from_numpy(_positions(500, 12))
    table = torch.from_numpy(_table(ct, 13))
    g = torch.from_numpy(np.random.RandomState(14).randn(
        500, ct.out_dim).astype(np.float32))
    grads = []
    for _ in range(2):
        t = table.clone().requires_grad_(True)
        thash.encode(t, p, ct).backward(g)
        grads.append(t.grad)
    assert torch.equal(grads[0], grads[1])
