"""Time the hand-written lookup kernels alone, at the tracking shapes.

    python3 scripts/bench_corr_lookup.py [--repo DIR] [--tag NAME] [--no-check]

Builds ``nerf_slam_tpu_torch/ops/csrc/corr_lookup.cu`` of the tree at
``--repo`` (default: the tree this script lies in) and times, through that
tree's own wrappers, ``lookup_pyramid_grouped4`` (gated with 36 of 48
slots active, and ungated) and ``lookup_pyramid_l0`` at 48 slots of 42x80
pixels: the inputs of ``chip_smoke.py``'s kernel phase; then the
one-level lookups at their paths' four level shapes (``lookup_level`` at
feature width 75, ``lookup_level_grouped`` at 80) and
``lookup_pyramid`` at one slot.  Every kernel but the last is compared
with its plain version, bit for bit, unless ``--no-check`` (for a copy
whose kernel was cut on purpose to see what its loads or its stores
cost).

One process times one tree, so two versions are compared by running the
script once per tree inside one call on one card, in turns.  Prints the
card's name and power limit, then one JSON line.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

H, W, E, N_ACT, SEED = 336 // 8, 640 // 8, 48, 36, 0
SLEEP_CYCLES = 40_000_000


def time_ms(fn, reps=30, warmup=5):
    """Mean device time of one call: ``reps`` calls queued behind a device
    sleep and timed as one span, so the host's launch cost stays out."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--tag", default="")
    ap.add_argument("--no-check", action="store_true")
    ap.add_argument("--reps", type=int, default=30)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_corr_lookup: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.repo))
    from nerf_slam_tpu_torch.geometry import camera
    from nerf_slam_tpu_torch.ops import build, corr, corr_lookup

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    for name, rep in build.build(["corr_lookup"]).items():
        for line in rep.splitlines():
            if "registers" in line or "spill" in line or "warning" in line:
                print(f"  ptxas {name}: {line.strip()}", flush=True)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    grid = camera.coords_grid(H, W, device=dev)

    def feats():
        return torch.randn((E, 128, H, W), generator=g, device=dev)

    def flowed():
        return (grid[None] + 3.0 * torch.randn(
            (E, H, W, 2), generator=g, device=dev)).contiguous()

    res = {"tag": args.tag or args.repo}
    slabs = corr.build_pyramid_bf16(feats(), feats(), 4, pad_rows_to=8)
    coords = flowed()
    dims = corr_lookup.pyramid_dims(H, W)
    n_act = torch.tensor([N_ACT], dtype=torch.int32, device=dev)
    for key, na in (("grouped4_gated", n_act), ("grouped4_ungated", None)):
        if not args.no_check:
            got = corr_lookup.lookup_pyramid_grouped4(slabs, coords, dims, na)
            want = corr_lookup.lookup_pyramid_grouped4_plain(slabs, coords,
                                                             dims, na)
            res[key + "_err"] = float((got.float() - want.float()).abs()
                                      .max())
            res[key + "_equal"] = bool(torch.equal(got, want))
        res[key + "_ms"] = time_ms(
            lambda: corr_lookup.lookup_pyramid_grouped4(slabs, coords, dims,
                                                        na), args.reps)
    del slabs
    vol0 = corr.build_pyramid_bf16(feats(), feats(), 1, pad_rows_to=8)[0]
    coords = flowed()
    if not args.no_check:
        got = corr_lookup.lookup_pyramid_l0(vol0, coords, dims)
        want = corr_lookup.lookup_pyramid_l0_plain(vol0, coords, dims)
        res["l0_err"] = float((got - want).abs().max())
        res["l0_equal"] = bool(torch.equal(got, want))
        del want
    res["l0_ms"] = time_ms(
        lambda: corr_lookup.lookup_pyramid_l0(vol0, coords, dims),
        max(3, args.reps // 3), 2)
    del vol0

    # the one-level lookups: #3 at feature width 75, #5 at 80 (per level,
    # then the mean); then #2 at E = 1
    for key, fn, wf in (("level", corr_lookup.lookup_level, 75),
                        ("level_grouped", corr_lookup.lookup_level_grouped,
                         W)):
        f1 = torch.randn((E, 128, H, wf), generator=g, device=dev)
        f2 = torch.randn((E, 128, H, wf), generator=g, device=dev)
        slabs = corr.build_pyramid_bf16(f1, f2, 4, pad_rows_to=8)
        del f1, f2
        c = camera.coords_grid(H, wf, device=dev)[None] + 3.0 * torch.randn(
            (E, H, wf, 2), generator=g, device=dev)
        ms, equal = [], True
        for lvl, vol in enumerate(slabs):
            cl = (c / 2 ** lvl).contiguous()
            if not args.no_check:
                equal &= bool(torch.equal(
                    fn(vol, cl), corr_lookup.lookup_level_plain(vol, cl)))
            ms.append(time_ms(lambda: fn(vol, cl), args.reps))
        res[key + "_ms"] = ms + [sum(ms) / len(ms)]
        if not args.no_check:
            res[key + "_equal"] = equal
        del slabs
    levels = [lv.to(torch.bfloat16).contiguous() for lv in corr.build_pyramid(
        corr.build_volume(feats()[:1], feats()[:1]))]
    c = flowed()[:1].contiguous()
    res["pyramid_ms"] = time_ms(
        lambda: corr_lookup.lookup_pyramid(levels, c), args.reps)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
