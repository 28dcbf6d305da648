"""The port's PE-NeRF mapping against the JAX package: encodings, the
field, sampling, volume rendering, the packet ingest and one training
step's loss and gradients, on the same numpy inputs and the same random
draws (the JAX side's draws are regenerated from its key and handed to
the port).

Both fields compute their layers in bf16 on f32 weights (the JAX
``PEField`` hard-codes ``dtype=bf16``), and the two frameworks round at
slightly different places inside a layer (bias add before or after the
bf16 rounding), so field outputs agree to a few bf16 ulps: the tolerances
below are stated per quantity.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nerf_slam_tpu.fusion import hashgrid as jhash
from nerf_slam_tpu.fusion import ngp as jngp
from nerf_slam_tpu.fusion.nerf_fusion import (NerfFusion as JaxFusion,
                                              NerfFusionConfig as JaxCfg)
from nerf_slam_tpu_torch.fusion import ngp as tngp
from nerf_slam_tpu_torch.fusion.nerf_fusion import (Batch, NerfFusion,
                                                    NerfFusionConfig)
from nerf_slam_tpu_torch.models import flax_to_state_dict

torch.backends.cuda.matmul.allow_tf32 = False

H, W, N_VIEWS, RAYS = 24, 32, 4, 256


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def fields():
    cfg_j = jngp.NGPConfig()
    params, jfield = jngp.init_ngp(jax.random.PRNGKey(3), cfg_j)
    tfield = tngp.load_ngp_params(tngp.PEField(tngp.NGPConfig()),
                                   params.table, params.mlp)
    return params, jfield, cfg_j, tfield


def test_encodings_match():
    rng = np.random.RandomState(0)
    pos = rng.rand(64, 3).astype(np.float32)
    d = rng.randn(64, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    np.testing.assert_allclose(
        _np(tngp.positional_encoding(torch.from_numpy(pos), 10)),
        _np(jngp.positional_encoding(jnp.asarray(pos), 10)), atol=2e-5)
    np.testing.assert_allclose(_np(tngp.sh_encode_deg4(torch.from_numpy(d))),
                               _np(jhash.sh_encode_deg4(jnp.asarray(d))),
                               atol=1e-6)


def test_pefield_matches(fields):
    """sigma = exp(raw) of a bf16 raw output: 3% relative; rgb is a
    sigmoid of a bf16 value: 1e-2 absolute."""
    params, jfield, cfg_j, tfield = fields
    rng = np.random.RandomState(1)
    pos = rng.rand(512, 3).astype(np.float32)
    d = rng.randn(512, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    sj, cj = jngp.query(params, jfield, cfg_j, jnp.asarray(pos),
                        jnp.asarray(d))
    with torch.no_grad():
        st, ct = tngp.query(tfield, torch.from_numpy(pos),
                            torch.from_numpy(d))
    np.testing.assert_allclose(_np(st), _np(sj), rtol=3e-2)
    np.testing.assert_allclose(_np(ct), _np(cj), atol=1e-2)


def test_sampling_and_render_match(fields):
    """The same draws give the same sorted samples (f32 arithmetic:
    1e-6); rendering integrates the field's outputs (rgb/acc to 1e-2,
    depth in normalized units to 1e-2)."""
    params, jfield, cfg_j, tfield = fields
    rng = np.random.RandomState(2)
    R = 128
    origins = (0.5 + 0.1 * rng.randn(R, 3)).astype(np.float32)
    dirs = (rng.randn(R, 3) * 0.3 + np.array([0, 0, 1.0])).astype(np.float32)
    guess = rng.uniform(0.2, 0.9, R).astype(np.float32)
    valid = (rng.rand(R) > 0.3).astype(np.float32)
    key = jax.random.PRNGKey(7)
    tj = jngp.sample_along_rays(key, jnp.asarray(origins),
                                jnp.asarray(dirs), jnp.asarray(guess),
                                jnp.asarray(valid), cfg_j)
    k1, k2 = jax.random.split(key)
    draws = (jax.random.uniform(k1, (R, cfg_j.n_uniform)),
             jax.random.normal(k2, (R, cfg_j.n_depth)),
             jax.random.uniform(k2, (R, cfg_j.n_depth)))
    tt = tngp.sample_along_rays(torch.from_numpy(guess),
                                torch.from_numpy(valid), tfield.cfg,
                                tuple(torch.from_numpy(_np(x))
                                      for x in draws))
    np.testing.assert_allclose(_np(tt), _np(tj), atol=1e-6)
    out_j = jngp.render_rays(params, jfield, cfg_j, jnp.asarray(origins),
                             jnp.asarray(dirs), tj)
    with torch.no_grad():
        out_t = tngp.render_rays(tfield, tfield.cfg,
                                 torch.from_numpy(origins),
                                 torch.from_numpy(dirs),
                                 torch.from_numpy(_np(tj)))
    for a, b in zip(out_t[:3], out_j[:3]):
        np.testing.assert_allclose(_np(a), _np(b), atol=1e-2)


def _packet(seed=4):
    """A SLAM viz packet of N_VIEWS cameras looking into the scene."""
    rng = np.random.RandomState(seed)
    poses = np.zeros((N_VIEWS, 7), np.float32)
    poses[:, 2] = 1.5 + 0.1 * rng.randn(N_VIEWS)      # centre z ~ -1.5
    poses[:, :2] = 0.1 * rng.randn(N_VIEWS, 2)
    q = np.concatenate([0.05 * rng.randn(N_VIEWS, 3),
                        np.ones((N_VIEWS, 1))], -1)
    poses[:, 3:] = q / np.linalg.norm(q, axis=-1, keepdims=True)
    idepths = rng.uniform(0.3, 0.8, (N_VIEWS, H, W)).astype(np.float32)
    idepths[:, :3] = 0.0                                # no depth there
    return {
        "viz_idx": np.arange(N_VIEWS), "cam0_poses": poses,
        "cam0_images": rng.randint(0, 256, (N_VIEWS, H, W, 3)
                                   ).astype(np.uint8),
        "cam0_idepths_up": idepths,
        "cam0_depths_cov_up": rng.uniform(1e-3, 0.3, (N_VIEWS, H, W)
                                          ).astype(np.float32),
        "cam0_intrinsics": np.tile(np.float32([[W / 8, W / 8, W / 16,
                                                H / 16]]), (N_VIEWS, 1)),
        "gt_depths": (1.0 / np.maximum(idepths, 0.3)).astype(np.float32),
        "is_last_frame": False,
    }


def test_fuse_and_train_step_match():
    """Packet ingest builds the same training set (f32: 1e-5); one train
    step on the JAX draws gives the same losses (2e-2 relative) and
    gradients: per tensor within 10% of its largest entry, and aligned
    overall (cosine > 0.99).  The JAX gradient is read from Adam's first
    moment after one step, mu = (1 - b1) g."""
    cfg_kw = dict(buffer=N_VIEWS + 2, height=H, width=W, batch_rays=RAYS)
    jf = JaxFusion(JaxCfg(**cfg_kw), seed=0)
    tf = NerfFusion(NerfFusionConfig(**cfg_kw), seed=0, device="cpu")
    tngp.load_ngp_params(tf.field, jf.params.table, jf.params.mlp)
    pkt = _packet()
    jf.fuse({k: jnp.asarray(v) if isinstance(v, np.ndarray) and k not in
             ("viz_idx",) else v for k, v in pkt.items()})
    tf.fuse(pkt)
    for name in ("c2w", "images", "depths", "depths_cov", "gt_depths",
                 "intrinsics", "valid"):
        np.testing.assert_allclose(_np(getattr(tf.train_set, name)),
                                   _np(getattr(jf.train_set, name)),
                                   atol=1e-5, rtol=1e-5, err_msg=name)

    key = jax.random.PRNGKey(11)
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
        np.testing.assert_allclose(float(a.detach()), float(b), rtol=2e-2)
    lt.backward()
    mu = _flat(opt_state[0].mu.mlp)
    gj = flax_to_state_dict({k: v / 0.1 for k, v in mu.items()})
    dots = nj = nt = 0.0
    for name, prm in tf.field.named_parameters():
        a, b = _np(prm.grad), _np(gj[name])
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=0.1 * np.abs(b).max() + 1e-12,
                                   err_msg=name)
        dots += float((a * b).sum())
        nj += float((b * b).sum())
        nt += float((a * a).sum())
    assert dots / np.sqrt(nj * nt) > 0.99


@pytest.mark.parametrize("mask,thresh", [("raw", None),
                                         ("ours_w_thresh", None),
                                         ("ours_w_thresh", 0.3),
                                         ("no_depth", None)])
def test_mask_types_match(mask, thresh):
    """The depth-uncertainty masks of the packet ingest (the median sigma
    of the packet, or an absolute threshold once set) give the JAX
    package's training set (f32: 1e-5)."""
    cfg_kw = dict(buffer=N_VIEWS, height=H, width=W, mask_type=mask)
    jf = JaxFusion(JaxCfg(**cfg_kw), seed=0)
    tf = NerfFusion(NerfFusionConfig(**cfg_kw), seed=0, device="cpu")
    jf.set_sigma_thresh(thresh)
    tf.set_sigma_thresh(thresh)
    pkt = _packet()
    jf.fuse(pkt)
    tf.fuse(pkt)
    for name in ("depths", "depths_cov"):
        np.testing.assert_allclose(_np(getattr(tf.train_set, name)),
                                   _np(getattr(jf.train_set, name)),
                                   atol=1e-5, rtol=1e-5, err_msg=name)
    masked = (_np(tf.train_set.depths) < 0).mean()
    assert 0.05 < masked < 1.0 or mask == "no_depth"
