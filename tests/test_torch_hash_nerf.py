"""The port's hash-grid NeRF against the JAX package's: the ``NGPField``
MLPs on converted flax parameters, one hash ``NerfFusion`` train step on
the same packet, rays and samples, and a short fit that must raise PSNR.

A 4-level grid over a 2^10 table (resolutions 8 .. 64, the first level
dense) keeps the CPU run short.  The MLPs compute in bf16 in both
packages, rounding at slightly different places inside a layer, so their
outputs agree to a few bf16 ulps; the losses of one step, means over
all rays, to 1e-3.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from nerf_slam_tpu.fusion import hashgrid as jhash
from nerf_slam_tpu.fusion import ngp as jngp
from nerf_slam_tpu.fusion.nerf_fusion import (NerfFusion as JaxFusion,
                                              NerfFusionConfig as JaxCfg)
from nerf_slam_tpu_torch.datasets import SyntheticConfig, SyntheticDataset
from nerf_slam_tpu_torch.fusion import hashgrid as thash
from nerf_slam_tpu_torch.fusion import ngp as tngp
from nerf_slam_tpu_torch.fusion.nerf_fusion import (Batch, NerfFusion,
                                                    NerfFusionConfig)
from nerf_slam_tpu_torch.geometry import se3
from nerf_slam_tpu_torch.models import flax_to_state_dict
from test_torch_nerf import N_VIEWS, RAYS, H, W, _flat, _np, _packet

# full f32 products: TF32 would keep about three decimal digits
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

GRID = dict(n_levels=4, log2_table_size=10, base_resolution=8,
            finest_resolution=64)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several test processes on a
    few cores, where many threads a process contend and slow every test
    far more than one thread does."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs():
    return (jngp.NGPConfig(encoding="hash",
                           grid=jhash.HashGridConfig(**GRID)),
            tngp.NGPConfig(encoding="hash",
                           grid=thash.HashGridConfig(**GRID)))


def test_ngp_field_matches():
    """Converted from the flax parameters (and the table), the field's
    sigma agrees to 3% (exp of a bf16 value) and rgb to 1e-2 (sigmoid of
    a bf16 value), from hash features and through the encoding."""
    cj, ct = _cfgs()
    params, jfield = jngp.init_ngp(jax.random.PRNGKey(5), cj)
    tfield = tngp.init_ngp(ct)
    assert isinstance(tfield, tngp.NGPField)
    tngp.load_ngp_params(tfield, np.asarray(params.table), params.mlp)
    rng = np.random.RandomState(0)
    feat = rng.randn(256, ct.grid.out_dim).astype(np.float32)
    d = rng.randn(256, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    sj, cj_ = jfield.apply(params.mlp, jnp.asarray(feat), jnp.asarray(d))
    with torch.no_grad():
        st, ct_ = tfield(torch.from_numpy(feat), torch.from_numpy(d))
    np.testing.assert_allclose(_np(st), _np(sj), rtol=3e-2)
    np.testing.assert_allclose(_np(ct_), _np(cj_), atol=1e-2)

    pos = rng.rand(4, 64, 3).astype(np.float32)
    dirs = np.broadcast_to(d[:64], (4, 64, 3)).copy()
    sj, cj_ = jngp.query(params, jfield, cj, jnp.asarray(pos),
                         jnp.asarray(dirs))
    with torch.no_grad():
        st, ct_ = tngp.query(tfield, torch.from_numpy(pos),
                             torch.from_numpy(dirs))
    assert st.shape == (4, 64) and ct_.shape == (4, 64, 3)
    np.testing.assert_allclose(_np(st), _np(sj), rtol=3e-2)
    np.testing.assert_allclose(_np(ct_), _np(cj_), atol=1e-2)


def test_hash_train_step_matches():
    """One train step of the hash NerfFusion on the JAX draws: the same
    losses within 1e-3 relative, and gradients aligned with the JAX ones
    (cosine > 0.99 over the MLPs and the table; the JAX gradient read from
    Adam's first moment, mu = (1 - b1) g).  The optimizer runs at the hash
    rate, ``NGPConfig.lr``."""
    cj, ct = _cfgs()
    cfg_kw = dict(buffer=N_VIEWS + 2, height=H, width=W, batch_rays=RAYS)
    jf = JaxFusion(JaxCfg(ngp=cj, **cfg_kw), seed=0)
    tf = NerfFusion(NerfFusionConfig(ngp=ct, **cfg_kw), seed=0,
                    device="cpu")
    assert tf.opt.param_groups[0]["lr"] == ct.lr == cj.lr
    tngp.load_ngp_params(tf.field, np.asarray(jf.params.table),
                         jf.params.mlp)
    pkt = _packet()
    jf.fuse({k: jnp.asarray(v) if isinstance(v, np.ndarray) and k !=
             "viz_idx" else v for k, v in pkt.items()})
    tf.fuse(pkt)

    key = jax.random.PRNGKey(12)
    zeros = jnp.zeros((jf.cfg.buffer, 6))
    _, _, opt_state, _, loss, l_rgb, l_d = jf._step_body(
        jf.params, zeros, jf.opt_state, jf.pose_opt_state, jf.train_set,
        key, 0.0, 1.0)
    kimg, kuv, ksamp = jax.random.split(key, 3)
    ts = jf.train_set
    p = ts.valid / jnp.maximum(ts.valid.sum(), 1.0)
    img_idx = jax.random.choice(kimg, jf.cfg.buffer, (RAYS,), p=p)
    uv = jax.random.uniform(kuv, (RAYS, 2))
    k1, k2 = jax.random.split(ksamp)
    ngp = jf.cfg.ngp
    draws = (jax.random.uniform(k1, (RAYS, ngp.n_uniform)),
             jax.random.normal(k2, (RAYS, ngp.n_depth)),
             jax.random.uniform(k2, (RAYS, ngp.n_depth)))
    batch = Batch(torch.from_numpy(np.asarray(img_idx).astype(np.int64)),
                  torch.from_numpy(_np(uv)),
                  tuple(torch.from_numpy(_np(x)) for x in draws))
    lt, lrt, ldt = tf.loss(batch)
    for a, b in ((lt, loss), (lrt, l_rgb), (ldt, l_d)):
        np.testing.assert_allclose(float(a.detach()), float(b), rtol=1e-3)
    lt.backward()
    mu = _flat(opt_state[0].mu.mlp)
    gj = {k: v.numpy() / 0.1 for k, v in flax_to_state_dict(mu).items()}
    gj["table"] = np.asarray(opt_state[0].mu.table) / 0.1
    dots = nj = nt = 0.0
    for name, prm in tf.field.named_parameters():
        a, b = _np(prm.grad), gj[name]
        dots += float((a * b).sum())
        nj += float((b * b).sum())
        nt += float((a * a).sum())
    assert dots / np.sqrt(nj * nt) > 0.99


def _synthetic_packet(n=4):
    """Ground-truth views of the synthetic room as a SLAM packet."""
    ds = SyntheticDataset(SyntheticConfig(n_frames=16, height=H, width=W,
                                          n_objects=3, seed=3))
    views = [ds[k] for k in range(0, 4 * n, 4)]
    c2w = torch.from_numpy(np.stack([v["poses"] for v in views])).double()
    depth = np.stack([v["depths"] for v in views]).astype(np.float32)
    return {"viz_idx": np.arange(n), "viz_count": n,
            "cam0_poses": se3.from_matrix(torch.linalg.inv(c2w)).float(),
            "cam0_images": np.stack([v["images"] for v in views]),
            "cam0_idepths_up": (1.0 / np.maximum(depth, 1e-3)),
            "cam0_depths_cov_up": np.full(depth.shape, 1e-3, np.float32),
            "cam0_intrinsics": np.stack([v["intrinsics"] for v in views])
            / 8.0,
            "gt_depths": depth, "is_last_frame": True}


def test_hash_fit_raises_psnr():
    """A short hash-grid fit on four views of the synthetic room (128
    rays of 48 samples a step) raises the training-view PSNR and keeps
    the loss finite."""
    ct = tngp.NGPConfig(encoding="hash", grid=thash.HashGridConfig(**GRID),
                        n_uniform=32, n_depth=16)
    tf = NerfFusion(NerfFusionConfig(buffer=6, height=H, width=W,
                                     batch_rays=128, ngp=ct,
                                     eval_every=50, eval_views=4),
                    seed=0, device="cpu")
    assert tf.fuse(_synthetic_packet()) is True
    loss = tf.fit_volume(100)
    assert np.isfinite(float(loss))
    first, last = tf.results[0], tf.results[-1]
    assert [r["iteration"] for r in tf.results] == [50, 100]
    assert last["psnr"] > first["psnr"], tf.results
