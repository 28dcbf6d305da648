"""DroidNet of the port against the flax DroidNet, both carrying the
trained ``weights_synthetic.npz`` (the port through models/convert.py).

f32 on both sides isolates the algorithm: the convolutions sum in
different orders, so outputs agree to ~1e-5 relative; tolerances are
5e-5 of each output's largest magnitude.  The bf16 case runs each
package in its working type, where every layer rounds to bf16 at its own
places: agreement is then a few bf16 ulps (2^-8 relative) per layer,
and the tolerance is 5% of each output's largest magnitude.
"""
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nerf_slam_tpu.models import DroidNet as JaxDroidNet
from nerf_slam_tpu.models.layers import BasicEncoder as JaxEncoder
from nerf_slam_tpu.utils.checkpoint import load_arrays, unflatten_into
from nerf_slam_tpu_torch.models import (BasicEncoder, DroidNet,
                                        flax_to_state_dict,
                                        load_flax_weights)
from nerf_slam_tpu_torch.models.layers import gradient_clip

torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False

H, W = 48, 64
h, w = H // 8, W // 8
WEIGHTS = os.path.join(os.path.dirname(__file__), "..",
                       "weights_synthetic.npz")


@pytest.fixture(scope="module")
def flat():
    return load_arrays(WEIGHTS)[0]


def _nets(flat, jdtype, tdtype):
    jnet = JaxDroidNet(dtype=jdtype)
    params = unflatten_into(jnet.init_params(jax.random.PRNGKey(0), H, W),
                            flat)
    tnet = load_flax_weights(DroidNet(dtype=tdtype), flat)
    return jnet, params, tnet


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, frac):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=frac * np.abs(want).max())


def _inputs(seed, E=3):
    rng = np.random.RandomState(seed)
    return dict(
        img=rng.randn(2, H, W, 3).astype(np.float32),
        net=np.tanh(rng.randn(E, h, w, 128)).astype(np.float32),
        inp=np.maximum(rng.randn(E, h, w, 128), 0).astype(np.float32),
        corr=(rng.randn(E, h, w, 196) * 0.5).astype(np.float32),
        flow=(rng.randn(E, h, w, 4) * 4).astype(np.float32),
        seg=np.array([0, 1, -1])[:E], K=3)


def test_converter_covers_every_parameter(flat):
    sd = flax_to_state_dict(flat)
    own = DroidNet(dtype=torch.float32).state_dict()
    assert set(sd) == set(own)
    for k, v in own.items():
        assert tuple(sd[k].shape) == tuple(v.shape), k
    k = "context_net.conv1.weight"
    np.testing.assert_array_equal(
        sd[k].numpy(),
        flat["params.context_net.conv1.kernel"].transpose(3, 2, 0, 1))


@pytest.mark.parametrize("norm,dim", [("instance", 128), ("none", 256)])
def test_basic_encoder_matches(flat, norm, dim):
    """The bare encoder (instance norm eps 1e-5, symmetric padding)."""
    name = "feature_net" if norm == "instance" else "context_net"
    x = _inputs(0)["img"]
    jenc = JaxEncoder(dim, norm, dtype=jnp.float32)
    sub = {k[len(f"params.{name}."):]: v for k, v in flat.items()
           if k.startswith(f"params.{name}.")}
    params = unflatten_into(jenc.init(jax.random.PRNGKey(0),
                                      jnp.zeros((1, H, W, 3))),
                            {f"params.{k}": v for k, v in sub.items()})
    want = jenc.apply(params, jnp.asarray(x))
    tenc = BasicEncoder(dim, norm)
    tenc.load_state_dict(flax_to_state_dict(
        {f"params.{k}": v for k, v in sub.items()}))
    got = tenc(torch.from_numpy(x))
    assert tuple(got.shape) == (2, h, w, dim)
    _close(got, want, 5e-5)


@pytest.mark.parametrize("dtypes,frac", [
    ((jnp.float32, torch.float32), 5e-5),
    ((jnp.bfloat16, torch.bfloat16), 5e-2)])
def test_droidnet_matches(flat, dtypes, frac):
    """features, context, update (with and without the hoisted context
    gates, with GraphAgg's eta and upsample mask) and aggregate."""
    jnet, params, tnet = _nets(flat, *dtypes)
    d = _inputs(1)
    J = {k: jnp.asarray(v) for k, v in d.items() if k != "K"}
    T = {k: torch.from_numpy(v) for k, v in d.items() if k != "K"}
    K = d["K"]
    with torch.no_grad():
        _close(tnet.features(T["img"]),
               jnet.apply(params, J["img"], method=JaxDroidNet.features),
               frac)
        for got, want in zip(tnet.context(T["img"]),
                             jnet.apply(params, J["img"],
                                        method=JaxDroidNet.context)):
            _close(got, want, frac)
        want = jnet.apply(params, J["net"], J["inp"], J["corr"], J["flow"],
                          J["seg"], K, True, method=JaxDroidNet.update)
        got = tnet.update(T["net"], T["inp"], T["corr"], T["flow"],
                          T["seg"], K, True)
        assert len(got) == len(want) == 5
        for g, wnt in zip(got, want):
            assert tuple(g.shape) == tuple(wnt.shape)
            _close(g, wnt, frac)
        gj = jnet.apply(params, J["inp"],
                        method=JaxDroidNet.update_precompute)
        gt = tnet.update_precompute(T["inp"])
        for g, wnt in zip(gt, gj):
            _close(g, wnt, frac)
        want = jnet.apply(params, J["net"], None, J["corr"], J["flow"],
                          J["seg"], K, False, None, gj,
                          method=JaxDroidNet.update)
        got = tnet.update(T["net"], None, T["corr"], T["flow"], T["seg"], K,
                          False, gt)
        assert len(got) == len(want) == 4
        for g, wnt in zip(got, want):
            _close(g, wnt, frac)
        for g, wnt in zip(tnet.aggregate(T["net"], T["seg"], K),
                          jnet.apply(params, J["net"], J["seg"], K,
                                     method=JaxDroidNet.aggregate)):
            _close(g, wnt, frac)


def test_gradient_clip_zeroes_large_and_nonfinite_gradients():
    x = torch.tensor([1.0, 2.0, 3.0, 4.0], requires_grad=True)
    g = torch.tensor([0.005, -0.02, float("nan"), -0.009])
    gradient_clip(x).backward(g)
    np.testing.assert_array_equal(
        x.grad.numpy(), np.float32([0.005, 0.0, 0.0, -0.009]))
    np.testing.assert_array_equal(gradient_clip(x).detach().numpy(),
                                  x.detach().numpy())
