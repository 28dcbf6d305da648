"""Hash-grid depth against the PE field's, in both packages, on the CPU.

    JAX_PLATFORMS=cpu python scripts/compare_hash_depth.py [--steps 300]

Decides whether the port's hash-grid NeRF fits worse depth than its PE
field because of the port or because of the field.  The port's tracker
(trained ``weights_synthetic.npz``, f32) runs over synthetic frames at
48x64 and its final packet, the keyframes with their depths and depth
variances, is fused into four ``NerfFusion``s: the JAX package's and the
port's hash field (a 2^14 table, instant-ngp's other defaults) and the
two packages' PE fields.  Each pair starts from the same weights (the
JAX field's initialization converted into the port's) and takes the same
random draws: the port's steps get the rays and samples that the JAX
scan draws from its key (``NerfFusion.draw_batch``'s draws, from JAX's
generator).  After ``--steps`` steps each field is evaluated at its
training views; the script prints one JSON line per field (PSNR, depth
L1 and scale-aligned depth L1 in cm) and a verdict line: the packages
agree when their aligned depth L1 differ by at most 2 cm or 15%, and
their PSNR by at most 1 dB.  The evaluation renders draw their own
samples in each package, so the two never agree to the bit.

It imports both packages (the only place outside the tests that does).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

jax.config.update("jax_platforms", "cpu")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--frames", type=int, default=12)
    p.add_argument("--height", type=int, default=48)
    p.add_argument("--width", type=int, default=64)
    p.add_argument("--rays", type=int, default=256)
    p.add_argument("--log2_table", type=int, default=14)
    p.add_argument("--fields", type=str, default="hash,pe")
    p.add_argument("--threads", type=int, default=4)
    return p.parse_args(argv)


def tracked_packet(args) -> dict:
    """The port tracker's final packet over the synthetic frames (filters
    off: every frame a keyframe), as numpy arrays."""
    from nerf_slam_tpu_torch.datasets import SyntheticConfig, SyntheticDataset
    from nerf_slam_tpu_torch.models import DroidNet, load_flax_weights
    from nerf_slam_tpu_torch.tracking import (FrontendConfig,
                                              RaftVisualFrontend)
    from nerf_slam_tpu_torch.utils.checkpoint import load_arrays

    flat, meta = load_arrays(os.path.join(ROOT, "weights_synthetic.npz"))
    net = load_flax_weights(DroidNet(dtype=torch.float32), flat)
    cfg = FrontendConfig(
        buffer=args.frames + 2, e_active=48, e_inactive=48,
        p_window=args.frames + 2, k_depth=args.frames + 4,
        motion_filter_thresh=-1.0, keyframe_thresh=-1.0,
        damping_scale=float(meta["damping_scale"]),
        damping_offset=float(meta["damping_offset"]))
    fe = RaftVisualFrontend(net, cfg, (args.height, args.width),
                            device="cpu")
    ds = SyntheticDataset(SyntheticConfig(
        n_frames=args.frames, height=args.height, width=args.width))
    pkt = None
    for k in range(len(ds)):
        out = fe(k, ds[k])
        if out is not None and "viz_idx" in out:
            pkt = out
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in pkt.items()}


def port_batch(jf, key):
    """The port's Batch of the draws the JAX step makes from ``key``."""
    from nerf_slam_tpu_torch.fusion.nerf_fusion import Batch
    cfg, ts = jf.cfg, jf.train_set
    R = cfg.batch_rays
    kimg, kuv, ksamp = jax.random.split(key, 3)
    p = ts.valid / jnp.maximum(ts.valid.sum(), 1.0)
    img_idx = jax.random.choice(kimg, cfg.buffer, (R,), p=p)
    uv = jax.random.uniform(kuv, (R, 2))
    k1, k2 = jax.random.split(ksamp)
    draws = (jax.random.uniform(k1, (R, cfg.ngp.n_uniform)),
             jax.random.normal(k2, (R, cfg.ngp.n_depth)),
             jax.random.uniform(k2, (R, cfg.ngp.n_depth)))

    def t(x):
        return torch.from_numpy(np.array(x, np.float32))

    return Batch(torch.from_numpy(np.asarray(img_idx).astype(np.int64)),
                 t(uv), tuple(t(x) for x in draws))


def fit_pair(encoding: str, pkt: dict, args) -> dict:
    """The JAX and the port field of one encoding, fitted on ``pkt`` from
    the same weights with the same draws; returns their evaluation rows."""
    from nerf_slam_tpu.fusion import hashgrid as jhash
    from nerf_slam_tpu.fusion import ngp as jngp
    from nerf_slam_tpu.fusion.nerf_fusion import (NerfFusion as JaxFusion,
                                                  NerfFusionConfig as JaxCfg)
    from nerf_slam_tpu_torch.fusion import hashgrid as thash
    from nerf_slam_tpu_torch.fusion import ngp as tngp
    from nerf_slam_tpu_torch.fusion.nerf_fusion import (NerfFusion,
                                                        NerfFusionConfig)

    grid = dict(log2_table_size=args.log2_table)
    kw = dict(buffer=args.frames + 2, height=args.height, width=args.width,
              batch_rays=args.rays)
    jf = JaxFusion(JaxCfg(ngp=jngp.NGPConfig(
        encoding=encoding, grid=jhash.HashGridConfig(**grid)), **kw), seed=0)
    tf = NerfFusion(NerfFusionConfig(ngp=tngp.NGPConfig(
        encoding=encoding, grid=thash.HashGridConfig(**grid)), **kw),
        seed=0, device="cpu")
    tngp.load_ngp_params(tf.field, jf.params.table, jf.params.mlp)
    jf.fuse(pkt)
    tf.fuse(pkt)
    # the keys the JAX scan splits off for its steps, in order
    key, batches = jf.key, []
    for _ in range(args.steps):
        key, sub = jax.random.split(key)
        batches.append(port_batch(jf, sub))
    rows = {}
    t0 = time.perf_counter()
    jf.fit_volume(args.steps)
    rows["jax"] = dict(jf.evaluate_training_views(max_views=8),
                       fit_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    for b in batches:
        tf.train_step(b)
        tf.iteration += 1
    rows["port"] = dict(tf.evaluate_training_views(max_views=8),
                        fit_s=time.perf_counter() - t0)
    return rows


def agree(a: dict, b: dict) -> bool:
    da = abs(a["depth_l1_aligned_cm"] - b["depth_l1_aligned_cm"])
    return (da <= max(2.0, 0.15 * a["depth_l1_aligned_cm"])
            and abs(a["psnr"] - b["psnr"]) <= 1.0)


def main(argv=None) -> int:
    args = parse_args(argv)
    torch.set_num_threads(args.threads)
    pkt = tracked_packet(args)
    print(json.dumps({"keyframes": int(pkt["viz_count"]),
                      "size": [args.height, args.width],
                      "steps": args.steps, "rays": args.rays}), flush=True)
    results = {}
    for enc in args.fields.split(","):
        rows = fit_pair(enc, pkt, args)
        for pkg, row in rows.items():
            results[(enc, pkg)] = row
            print(json.dumps({"field": enc, "package": pkg,
                              **{k: row[k] for k in (
                                  "iteration", "psnr", "depth_l1_cm",
                                  "depth_l1_aligned_cm", "fit_s")}}),
                  flush=True)
    verdict = {enc: agree(results[(enc, "jax")], results[(enc, "port")])
               for enc in args.fields.split(",")}
    if ("hash", "jax") in results and ("pe", "jax") in results:
        verdict["jax_hash_minus_pe_aligned_l1_cm"] = (
            results[("hash", "jax")]["depth_l1_aligned_cm"]
            - results[("pe", "jax")]["depth_l1_aligned_cm"])
        verdict["port_hash_minus_pe_aligned_l1_cm"] = (
            results[("hash", "port")]["depth_l1_aligned_cm"]
            - results[("pe", "port")]["depth_l1_aligned_cm"])
    print(json.dumps({"packages_agree": verdict}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
