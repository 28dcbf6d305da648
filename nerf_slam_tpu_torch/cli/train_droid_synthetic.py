"""Train DROID weights on procedural synthetic scenes (PyTorch).

    python -m nerf_slam_tpu_torch.cli.train_droid_synthetic \\
        --phases stable --init weights_synthetic.npz --out weights.npz --eval

The JAX package's ``scripts/train_droid_synthetic.py`` on the port: the
same curriculum (``PHASES``: resolution and per-frame motion rising
toward the 336x640 production cell), the same scenes (``make_batch``:
seed-fixed synthetic rooms with objects and jittered orbits), the same
neighbourhood edge graph, BA-in-the-loop training
(``models/training.py``) with gradient accumulation, the weight EMA and
held-out checkpoint selection.  Every phase trains in this one process
and checkpoints every ``--save_every`` steps (weights, EMA, Adam state,
the best held-out weights); a rerun resumes from the newest in-phase
checkpoint.  The network computes in bf16 with f32 weights, as the JAX
trainer's ``DroidNet(dtype=bfloat16)`` does; training from scratch starts
from PyTorch's default initialization drawn from ``--seed``.

The weights are written as flat flax keys in an ``.npz`` with the JSON
sidecar (``damping_scale``, ``damping_offset``: the BA damping the
training used), so the port's CLI and the JAX package both load them.
``--eval`` tracks the production cell (336x640, 30 frames, buffer 24)
through the port's ``slam_demo`` with each phase's weights and prints
the ATE-RMSE.  Runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import time
from typing import Dict, List, Optional

import numpy as np
import torch

# curriculum: resolution and per-frame motion ramp toward the production
# cell's statistics (336x640, 12 deg a frame); steps are per phase
PHASES = {
    "full": [
        dict(name="p1", H=96, W=128, frames=7, scenes=64, steps=8000,
             gru_steps=8, lr=2e-4, deg_lo=2.0, deg_hi=14.0,
             max_objects=8, remat=False),
        dict(name="p2", H=192, W=320, frames=7, scenes=48, steps=3000,
             gru_steps=8, lr=1e-4, deg_lo=3.0, deg_hi=16.0,
             max_objects=8, remat=True),
        dict(name="p3", H=256, W=448, frames=5, scenes=32, steps=1500,
             gru_steps=6, lr=5e-5, deg_lo=6.0, deg_hi=18.0,
             max_objects=8, remat=True),
    ],
    # the production cell's resolution and motion; warm-start with --init
    "finetune": [
        dict(name="p4", H=336, W=640, frames=5, scenes=16, steps=600,
             gru_steps=4, lr=3e-5, deg_lo=8.0, deg_hi=16.0,
             max_objects=6, remat=True),
    ],
    # stabilized finetune: 4-scene gradient accumulation, weight EMA,
    # held-out checkpoint selection, a share of plain orbits
    "stable": [
        dict(name="p2b", H=192, W=320, frames=7, scenes=64, steps=600,
             gru_steps=8, lr=3e-5, deg_lo=3.0, deg_hi=16.0,
             max_objects=8, remat=True, accum=4, ema=0.998,
             holdout=8, plain_frac=0.3),
        dict(name="p4b", H=336, W=640, frames=5, scenes=48, steps=400,
             gru_steps=4, lr=1e-5, deg_lo=8.0, deg_hi=16.0,
             max_objects=6, remat=True, accum=4, ema=0.998,
             holdout=8, plain_frac=0.4),
    ],
    "quick": [
        dict(name="q1", H=96, W=128, frames=5, scenes=4, steps=30,
             gru_steps=4, lr=2e-4, deg_lo=2.0, deg_hi=12.0,
             max_objects=4, remat=False),
    ],
    "stable2": [
        dict(name="p2c", H=192, W=320, frames=7, scenes=64, steps=700,
             gru_steps=8, lr=1.5e-5, deg_lo=3.0, deg_hi=16.0,
             max_objects=8, remat=True, accum=4, ema=0.998,
             holdout=8, plain_frac=0.3),
    ],
    # smoke of the accumulation / EMA / held-out path
    "quick2": [
        dict(name="q2", H=96, W=128, frames=5, scenes=4, steps=4,
             gru_steps=4, lr=2e-4, deg_lo=2.0, deg_hi=12.0,
             max_objects=4, remat=False, accum=2, ema=0.99,
             holdout=2, plain_frac=0.5),
    ],
}

# each phase's scene seeds start at 1000 * (1 + index)
PHASE_INDEX = {"p1": 0, "p2": 1, "p3": 2, "p4": 3, "q1": 0,
               "p2b": 4, "p4b": 5, "p2c": 6, "q2": 0}

# the BA damping of the training forward (1.0 * eta + 1e-4): the tracker
# must run the same, so it rides the weights' sidecar
DAMPING = {"damping_scale": 1.0, "damping_offset": 1e-4}


def _quat_from_matrix(R):
    """(3,3) rotation -> [x,y,z,w] quaternion, numpy (Shepperd)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] >= R[1, 1] and R[0, 0] >= R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        x = 0.25 * s
        w = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 1] + R[1, 0]) / s
        z = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] >= R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        y = 0.25 * s
        w = (R[0, 2] - R[2, 0]) / s
        x = (R[0, 1] + R[1, 0]) / s
        z = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        z = 0.25 * s
        w = (R[1, 0] - R[0, 1]) / s
        x = (R[0, 2] + R[2, 0]) / s
        y = (R[1, 2] + R[2, 1]) / s
    return np.array([x, y, z, w])


def _se3_from_matrix_np(Ts):
    """(N,4,4) -> (N,7) [t, q] f32."""
    out = np.zeros((Ts.shape[0], 7), np.float32)
    for i, T in enumerate(Ts):
        out[i, :3] = T[:3, 3]
        out[i, 3:] = _quat_from_matrix(T[:3, :3])
    return out


def make_batch(seed: int, spec: Dict):
    """One training scene: ``spec["frames"]`` frames of a synthetic room
    drawn from ``seed`` (host tensors)."""
    from ..datasets import SyntheticConfig, SyntheticDataset
    from ..models.training import TrainBatch

    H, W, n_frames = spec["H"], spec["W"], spec["frames"]
    r = np.random.RandomState(seed + 17)
    deg = r.uniform(spec["deg_lo"], spec["deg_hi"])
    if r.rand() < 0.5:
        deg = -deg                       # both orbit directions
    # plain_frac: the share of clean orbits (no objects, no jitter)
    plain = r.rand() < spec.get("plain_frac", 0.0)
    ds = SyntheticDataset(SyntheticConfig(
        n_frames=n_frames, height=H, width=W, seed=seed + 1,
        fov_deg=r.uniform(60.0, 80.0),
        orbit_radius=r.uniform(0.6, 1.4),
        room_half=r.uniform(1.6, 2.6),
        room_height=r.uniform(2.0, 3.0),
        deg_per_frame=deg,
        start_deg=r.uniform(0.0, 360.0),
        n_objects=0 if plain else r.randint(0, spec["max_objects"] + 1),
        bob_amp=0.0 if plain else r.uniform(0.0, 0.35),
        target_jitter=0.0 if plain else r.uniform(0.0, 0.35)))
    imgs, poses, disps, intr = [], [], [], []
    for k in range(n_frames):
        p = ds[k]
        imgs.append(p["images"])
        poses.append(np.linalg.inv(p["poses"]))
        d = p["depths"][::8, ::8]
        disps.append(1.0 / np.maximum(d, 0.1))
        intr.append(p["intrinsics"] / 8.0)
    return TrainBatch(
        images=torch.from_numpy(np.stack(imgs)),
        poses_gt=torch.from_numpy(_se3_from_matrix_np(np.stack(poses))),
        disps_gt=torch.from_numpy(np.stack(disps).astype(np.float32)),
        intrinsics=torch.from_numpy(np.stack(intr).astype(np.float32)))


def neighborhood_graph(N: int, radius: int = 3, device=None):
    """Every ordered pair of distinct frames at most ``radius`` apart."""
    pairs = [(a, b) for a in range(N) for b in range(N)
             if a != b and abs(a - b) <= radius]
    ii, jj = zip(*pairs)
    return (torch.tensor(ii, device=device), torch.tensor(jj, device=device))


def _flat(tensors: List[torch.Tensor], names: List[str], prefix: str):
    return {f"{prefix}{n}": t for n, t in zip(names, tensors)}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_phase(spec: Dict, init_path: Optional[str], out_path: str,
              device: str = "cuda", save_every: int = 100, seed: int = 0,
              stop_after: Optional[int] = None, log=print) -> Dict:
    """Train one curriculum phase and write ``out_path`` (+ sidecar).

    Warm-starts from ``init_path`` (flat flax keys) when given; resumes
    from ``<out_path>.<phase>.ckpt.npz`` when that exists (every
    ``save_every`` steps: weights, EMA, Adam moments and count, the best
    held-out weights and score), so an interrupted phase continues as it
    would have.  ``stop_after``: return after that many steps of this
    call, at a checkpoint (to test the resume).  Returns a summary: the
    last step's mean metrics, whether every gradient was finite, seconds
    per scene-gradient and per optimizer step, peak device memory.
    """
    from ..models import (DroidNet, flax_to_state_dict, load_flax_weights,
                          state_dict_to_flax)
    from ..models.training import (Optimizer, apply_fn, eval_fn, grad_fn,
                                   warmup_cosine_decay_schedule)
    from ..utils.checkpoint import load_arrays, save_arrays

    dev = torch.device(device)
    name, H, W = spec["name"], spec["H"], spec["W"]
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        net = DroidNet(dtype=torch.bfloat16, param_dtype=torch.float32)
    net.to(dev)
    names = [n for n, _ in net.named_parameters()]
    params = list(net.parameters())

    steps = spec["steps"]
    accum = int(spec.get("accum", 1))
    ema_decay = float(spec.get("ema", 0.0))
    n_hold = int(spec.get("holdout", 0))
    sched = warmup_cosine_decay_schedule(
        0.0, spec["lr"], min(100, steps // 4), steps,
        end_value=0.05 * spec["lr"])
    opt = Optimizer(params, sched, max_norm=1.0)

    ckpt = out_path + f".{name}.ckpt.npz"
    start_step, best_geo, best = 0, float("inf"), None
    ema = None
    if os.path.exists(ckpt):
        flat, meta = load_arrays(ckpt)

        def part(prefix):
            return [torch.from_numpy(flat[f"{prefix}{n}"]).to(dev)
                    for n in names]
        load_flax_weights(net, flat)
        opt.load_state_dict({"mu": part("mu."), "nu": part("nu."),
                             "count": meta["count"]})
        if f"ema.{names[0]}" in flat:
            ema = part("ema.")
        if f"best.{names[0]}" in flat:
            best, best_geo = part("best."), float(meta["best_geo"])
        start_step = int(meta["step"])
        log(f"[{name}] resume from step {start_step}")
    elif init_path and os.path.exists(init_path):
        load_flax_weights(net, load_arrays(init_path)[0])
        log(f"[{name}] warm-start from {init_path}")
    if ema is None:
        ema = [p.detach().clone() for p in params]

    ii, jj = neighborhood_graph(spec["frames"], device=dev)
    log(f"[{name}] generating {spec['scenes']} scenes ({spec['frames']} "
        f"frames at {H}x{W})...")
    base = 1000 * (1 + PHASE_INDEX.get(name, 0))
    batches = [make_batch(base + s, spec).to(dev)
               for s in range(spec["scenes"])]
    hold = [make_batch(900000 + s, spec).to(dev) for s in range(n_hold)]
    kw = dict(num_steps=spec["gru_steps"], bf16_pyramid=True)
    eval_net = None
    if hold:
        eval_net = DroidNet(dtype=torch.bfloat16,
                            param_dtype=torch.float32).to(dev)

    def holdout_score(cand, it):
        with torch.no_grad():
            for p, c in zip(eval_net.parameters(), cand):
                p.copy_(c)
        ms = [eval_fn(eval_net, b, ii, jj, **kw) for b in hold]
        geo = float(np.mean([float(m["geodesic"]) for m in ms]))
        rot = float(np.mean([float(m["rot_error_deg"]) for m in ms]))
        log(f"[{name} {time.time() - t0:7.1f}s] step {it:4d} HELD-OUT geo "
            f"{geo:.4f} rot {rot:.2f}deg")
        return geo

    def save_ckpt(step):
        flat = state_dict_to_flax(net.state_dict())
        flat.update(_flat(opt.mu, names, "mu."))
        flat.update(_flat(opt.nu, names, "nu."))
        flat.update(_flat(ema, names, "ema."))
        meta = {"step": step, "count": opt.count, "height": H, "width": W}
        if best is not None:
            flat.update(_flat(best, names, "best."))
            meta["best_geo"] = best_geo
        save_arrays(ckpt, flat, meta)

    # which scene each gradient takes: random draws under accumulation
    # (those of the steps before start_step replayed), else a permutation
    rs = np.random.RandomState(7)
    if accum > 1 or ema_decay > 0 or n_hold > 0:
        for _ in range(start_step * accum):
            rs.randint(len(batches))

        def draw(it):
            return rs.randint(len(batches))
    else:
        order = rs.permutation(np.arange(
            len(batches) * (1 + steps // max(1, len(batches)))))

        def draw(it):
            return order[it % len(order)] % len(batches)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    finite = torch.ones((), dtype=torch.bool, device=dev)
    t_grad = t_step = 0.0
    n_grad = n_step = 0
    t0 = time.time()
    mss = []
    for it in range(start_step, steps):
        _sync(dev)
        ts = time.perf_counter()
        g_sum = [torch.zeros_like(p) for p in params]
        mss = []
        for _ in range(accum):
            tg = time.perf_counter()
            g, m = grad_fn(net, batches[draw(it)], ii, jj,
                           remat=spec.get("remat", False), **kw)
            for s, x in zip(g_sum, g):
                s.add_(x)
            finite &= torch.stack([torch.isfinite(x).all() for x in g]).all()
            mss.append(m)
            _sync(dev)
            t_grad += time.perf_counter() - tg
            n_grad += 1
        apply_fn(net, opt, g_sum, float(np.float32(1.0 / accum)), ema,
                 ema_decay)
        _sync(dev)
        t_step += time.perf_counter() - ts
        n_step += 1
        if it % 20 == 0 or it == steps - 1:
            m = {k: float(np.mean([float(x[k]) for x in mss]))
                 for k in mss[0]}
            log(f"[{name} {time.time() - t0:7.1f}s] step {it:4d} loss "
                f"{m['loss']:.4f} geo {m['geodesic']:.4f} flow "
                f"{m['flow']:.3f} res {m['residual']:.3f} rot "
                f"{m['rot_error_deg']:.2f}deg")
        if ((it + 1) % save_every == 0 or it == steps - 1) and hold:
            cand = ema if ema_decay > 0 else params
            geo = holdout_score(cand, it + 1)
            if geo < best_geo:
                best_geo, best = geo, [c.detach().clone() for c in cand]
        done = it + 1 - start_step
        if (it + 1) % save_every == 0 and it != steps - 1:
            save_ckpt(it + 1)
            if stop_after is not None and done >= stop_after:
                return {"stopped_at": it + 1}

    final = best if best is not None else (ema if ema_decay > 0
                                           else params)
    if best is not None:
        log(f"[{name}] shipping best held-out checkpoint (geo "
            f"{best_geo:.4f})")
    flat = state_dict_to_flax(dict(zip(names, final)))
    save_arrays(out_path, flat, meta={"phase": name, "steps": steps,
                                      "height": H, "width": W, **DAMPING})
    if os.path.exists(ckpt):
        os.remove(ckpt)
        os.remove(ckpt + ".json")
    log(f"[{name}] saved {out_path}")
    metrics = ({k: float(np.mean([float(x[k]) for x in mss]))
                for k in mss[0]} if mss else {})
    return {"metrics": metrics, "grads_finite": bool(finite),
            "s_per_grad": t_grad / max(n_grad, 1),
            "s_per_step": t_step / max(n_step, 1),
            "peak_mem_gib": (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                             if dev.type == "cuda" else None),
            "best_geo": best_geo if best is not None else None}


def eval_bench_cell(weights_path: str, device: str = "cuda") -> Dict:
    """ATE on the production cell (336x640, 30 frames, buffer 24, a full
    orbit) through the port's ``slam_demo`` with ``weights_path``."""
    from . import slam_demo
    return slam_demo.run(slam_demo.parse_args([
        "--weights", weights_path, "--height", "336", "--width", "640",
        "--n_frames", "30", "--buffer", "24", "--fusion", "none",
        "--out", os.devnull, "--device", device]))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="full", choices=sorted(PHASES))
    ap.add_argument("--out", default="weights_synthetic.npz")
    ap.add_argument("--init", default=None,
                    help="warm-start weights for the first phase")
    ap.add_argument("--eval", action="store_true",
                    help="production-cell ATE after each phase")
    ap.add_argument("--start-phase", type=int, default=0)
    ap.add_argument("--save_every", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    out = os.path.abspath(args.out)
    prev = args.init and os.path.abspath(args.init)
    for pi, spec in enumerate(PHASES[args.phases]):
        phase_out = out + f".{spec['name']}.npz"
        if pi < args.start_phase:
            prev = phase_out
            continue
        print(f"=== phase {spec['name']}: {spec} ===", flush=True)
        t0 = time.time()
        summary = run_phase(spec, prev, phase_out, device=args.device,
                            save_every=args.save_every, seed=args.seed,
                            log=lambda s: print(s, flush=True))
        print(f"=== phase {spec['name']} done in {time.time() - t0:.0f}s: "
              f"{json.dumps(summary)} ===", flush=True)
        prev = phase_out
        if args.eval:
            row = eval_bench_cell(phase_out, args.device)
            print(f"[{spec['name']}] production-cell ATE: "
                  f"{row.get('ate_rmse_m')}", flush=True)

    if prev and os.path.exists(prev):
        shutil.copyfile(prev, out)
        if os.path.exists(prev + ".json"):
            shutil.copyfile(prev + ".json", out + ".json")
        print(f"final weights -> {out}", flush=True)


if __name__ == "__main__":
    main()
