"""The port's DROID training gradients against the JAX package's, on the CPU.

    JAX_PLATFORMS=cpu python scripts/compare_training_grads.py

At the size of ``tests/test_torch_training.py`` (48x64, 4 frames, the
edges of ``tests/test_training.py``, two update iterations, flax's
initial parameters carried across), prints per gradient leaf how far
apart the packages are: in f32 the relative L2 distance of the port and
of the jitted JAX run from the op-by-op JAX run (the largest five
leaves of each); in bf16 the cosine of the port's and of JAX's bf16
gradient to each other and to the op-by-op f32 gradient, over the
feature encoder's convolution weights and over the other leaves.  The
leaves whose exact gradient is zero (the feature encoder's biases ahead
of instance norms, the unused upsample head) are left out.  About four
minutes: the JAX runs are op by op.

It imports both packages (as the tests do).
"""
from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def main():
    from nerf_slam_tpu.datasets import SyntheticConfig, SyntheticDataset
    from nerf_slam_tpu.geometry import se3
    from nerf_slam_tpu.models import DroidNet as JNet
    from nerf_slam_tpu.models import training as jtr
    from nerf_slam_tpu.utils.checkpoint import _flatten
    from nerf_slam_tpu_torch.models import (DroidNet, flax_to_state_dict,
                                            load_flax_weights)
    from nerf_slam_tpu_torch.models import training as ttr

    H, W = 48, 64
    h, w = H // 8, W // 8
    ds = SyntheticDataset(SyntheticConfig(n_frames=4, height=H, width=W))
    imgs, poses, disps, intr = [], [], [], []
    for k in range(4):
        p = ds[k]
        imgs.append(p["images"])
        poses.append(np.linalg.inv(p["poses"]))
        disps.append(1.0 / np.maximum(p["depths"][::8, ::8], 0.1))
        intr.append(p["intrinsics"] / 8.0)
    arrays = (np.stack(imgs),
              np.asarray(se3.from_matrix(jnp.asarray(np.stack(poses)))),
              np.stack(disps).astype(np.float32),
              np.stack(intr).astype(np.float32))
    pairs = [(a, b) for a in range(4) for b in range(4)
             if a != b and abs(a - b) <= 2]
    ii = np.array([p[0] for p in pairs])
    jj = np.array([p[1] for p in pairs])
    jb = jtr.TrainBatch(*map(jnp.asarray, arrays))
    tb = ttr.TrainBatch(*(torch.as_tensor(np.array(a)) for a in arrays))
    iij, jjj = jnp.asarray(ii), jnp.asarray(jj)
    params = JNet().init(
        jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)),
        jnp.zeros((1, h, w, 128)), jnp.zeros((1, h, w, 128)),
        jnp.zeros((1, h, w, 196)), jnp.zeros((1, h, w, 4)),
        jnp.array([0]), 1)
    flat = {k: np.asarray(v) for k, v in _flatten(params).items()}

    def jax_grads(dtype, jit):
        net = JNet(dtype=dtype)
        f = jax.value_and_grad(
            lambda p: jtr.droid_loss(net, p, jb, iij, jjj, num_steps=2),
            has_aux=True)
        (_, _), g = (jax.jit(f) if jit else f)(params)
        return {k: v.numpy() for k, v in flax_to_state_dict(
            {k: np.asarray(v) for k, v in _flatten(g).items()}).items()}

    def port_grads(dtype, param_dtype=None):
        net = load_flax_weights(DroidNet(dtype=dtype,
                                         param_dtype=param_dtype), flat)
        g, _ = ttr.grad_fn(net, tb, torch.as_tensor(ii), torch.as_tensor(jj),
                           num_steps=2)
        return {n: x.float().numpy()
                for (n, _), x in zip(net.named_parameters(), g)}

    def real(name):
        return not (name.startswith("update_net.agg.upmask_0") or (
            name.startswith("feature_net") and name.endswith(".bias")
            and name != "feature_net.conv2.bias"))

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    def cos(a, b):
        return float(np.sum(a * b) / (np.linalg.norm(a) * np.linalg.norm(b)))

    eager = jax_grads(None, False)
    jitted = jax_grads(None, True)
    port = port_grads(torch.float32)
    for tag, other in (("port", port), ("jitted JAX", jitted)):
        d = sorted(((rel(other[k], eager[k]), k) for k in eager if real(k)),
                   reverse=True)
        print(f"f32, {tag} vs op-by-op JAX, relative L2, largest: "
              + ", ".join(f"{k} {v:.2e}" for v, k in d[:5]))
    j16 = jax_grads(jnp.bfloat16, False)
    p16 = port_grads(torch.bfloat16, torch.float32)
    for group, pick in (("feature-encoder weights",
                         lambda k: k.startswith("feature_net")),
                        ("other leaves",
                         lambda k: not k.startswith("feature_net"))):
        ks = [k for k in eager if real(k) and pick(k)]
        for tag, vals in (
                ("port bf16 vs JAX bf16", [cos(p16[k], j16[k]) for k in ks]),
                ("JAX bf16 vs f32", [cos(j16[k], eager[k]) for k in ks]),
                ("port bf16 vs f32", [cos(p16[k], eager[k]) for k in ks])):
            print(f"bf16, {group} ({len(ks)}), cosine {tag}: min "
                  f"{min(vals):.4f}, max {max(vals):.4f}")


if __name__ == "__main__":
    main()
