"""Runtime accounting and profiling hooks.

The counterparts on a GPU of the JAX package's ``utils/runtime.py``:

- ``count_dispatch`` / ``count_sync`` with ``dispatch_snapshot`` and
  ``dispatch_delta``: per-name counters a caller bumps at its device
  dispatches and host-blocking fetches, and diffs around a run;
- ``profile_trace``: a ``torch.profiler`` trace (CPU and CUDA activities)
  around a block, written as a Chrome trace into ``logdir``;
- ``device_peak_flops``: the card's name and dense peak rate;
- ``DEVICE_LOCK``: the lock the pipeline's stages hold around their
  device work (a no-op under ``NERF_SLAM_TPU_NO_LOCK``), and
  ``fusion_device``: the mapping stage's device under ``--device_split``.

The JAX module's XLA compilation cache and compile counting have no
counterpart: PyTorch compiles nothing ahead of an eager call, and the
port's CUDA kernels are built once into ``nerf_slam_tpu_torch/_build/``
(``ops/build.py``).
"""
from __future__ import annotations

import os
import tempfile
import threading
import time
from contextlib import contextmanager
from typing import Optional

DISPATCH_COUNTS: dict = {}
SYNC_COUNTS: dict = {}


def count_dispatch(name: str) -> None:
    DISPATCH_COUNTS[name] = DISPATCH_COUNTS.get(name, 0) + 1


def count_sync(name: str) -> None:
    SYNC_COUNTS[name] = SYNC_COUNTS.get(name, 0) + 1


def dispatch_snapshot() -> dict:
    return {"dispatch": dict(DISPATCH_COUNTS), "sync": dict(SYNC_COUNTS)}


def dispatch_delta(snap: dict) -> dict:
    """Per-name counts since ``snap`` (a dispatch_snapshot())."""
    out = {"dispatch": {}, "sync": {}}
    for kind, counts in (("dispatch", DISPATCH_COUNTS),
                         ("sync", SYNC_COUNTS)):
        base = snap.get(kind, {})
        for k, v in counts.items():
            d = v - base.get(k, 0)
            if d:
                out[kind][k] = d
    out["dispatch_total"] = sum(out["dispatch"].values())
    out["sync_total"] = sum(out["sync"].values())
    return out


# NVIDIA H100 SXM (the 80GB HBM3 card) data sheet, dense (no sparsity):
# bf16 tensor-core and fp32 (non-tensor) FLOP/s
_PEAKS = {"H100 80GB HBM3": {"bf16": 989e12, "f32": 67e12}}


def device_peak_flops(dtype: str = "bf16") -> tuple:
    """(card name, dense peak FLOP/s for ``dtype`` "bf16" or "f32") of the
    current CUDA device; the rate is None for a card not in the table."""
    import torch
    name = torch.cuda.get_device_name()
    for key, peaks in _PEAKS.items():
        if key in name:
            return name, peaks[dtype]
    return name, None


def default_trace_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "nerf_slam_tpu_torch_trace")


@contextmanager
def profile_trace(logdir: Optional[str] = None):
    """``torch.profiler`` trace of the block, CPU and CUDA activities,
    written to ``logdir`` (default: ``nerf_slam_tpu_torch_trace`` in the
    temporary directory) as a Chrome trace; prints the path and the
    block's seconds.  The profiler records CPU ranges only on the thread
    that opened it; the CUDA kernels of every thread are recorded."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    logdir = logdir or default_trace_dir()
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    t0 = time.perf_counter()
    with profile(activities=activities) as prof:
        yield prof
    secs = time.perf_counter() - t0
    path = os.path.join(logdir, f"trace_{os.getpid()}_{int(time.time())}"
                                ".json")
    prof.export_chrome_trace(path)
    print(f"trace written to {path} ({secs:.2f}s)", flush=True)


class _NullLock:
    """Reentrant no-op stand-in for ``DEVICE_LOCK``."""

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False

    def acquire(self, *a, **k):
        return True

    def release(self):
        pass


# The pipeline's stages run as threads of one process and take this lock
# around their device work, so one stage's host syncs never interleave
# with another's launches on a shared card.  NERF_SLAM_TPU_NO_LOCK=1
# replaces it with a no-op: the stages then dispatch concurrently, which
# the tracking || mapping split over two cards (--device_split) needs.
DEVICE_LOCK = (_NullLock() if os.environ.get("NERF_SLAM_TPU_NO_LOCK")
               else threading.RLock())


def fusion_device(device_split: bool = False, base="cuda"):
    """The mapping stage's device: under ``device_split`` the second
    device of ``base``'s type (``cuda:1``) where two or more are visible,
    else None, which leaves mapping on ``base`` beside tracking (with one
    card the split falls back to shared-device scheduling)."""
    import torch
    if not device_split:
        return None
    kind = torch.device(base).type
    count = torch.cuda.device_count() if kind == "cuda" else 1
    if count < 2:
        print("device_split requested but only one device visible; "
              "falling back to shared-device scheduling")
        return None
    return torch.device(kind, 1)
