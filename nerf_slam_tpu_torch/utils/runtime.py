"""Runtime accounting and profiling hooks.

The counterparts on a GPU of the JAX package's ``utils/runtime.py``:

- ``span(name, **ids)``: the program's spans, a context manager at each
  layer boundary (the pipeline's lock, the tracker's frame, round and
  solve, the map's steps).  A span records only while a
  ``torch.profiler`` records (``torch.autograd.profiler
  ._is_profiler_enabled``, which PyTorch sets at the profiler's start and
  clears at its stop); otherwise ``span`` reads that one flag and returns
  a shared no-op.  Each recorded :class:`Span` keeps its name, its stage
  (the name of the thread that opened it: the pipeline's threads are
  named after their stages), its parent (the span open on the same
  thread when it opened), its ids (``k`` and ``session`` of a frame,
  ``iteration`` of a map step), its start and end in
  ``time.perf_counter_ns()`` (the clock onto which a profiler's device
  events map by the offset ``time.time_ns() - time.perf_counter_ns()``),
  and the syncs made directly inside it.  A sync is a point where the
  host waits for the device (``.item()``, ``.cpu()``, ``float(t)``, a
  blocking copy from pageable host memory, a stream or event
  synchronize); while recording, CUDA's sync debug mode warns at each,
  and each warning counts against the innermost open span of the thread
  that synced (``Recorder.loose_syncs`` counts those outside any span).
  The mode does not flag a device-wide ``torch.cuda.synchronize()`` or
  an event's wait, which no traced path of the program makes.  Spans
  stay out of the profiler's own events (a ``record_function`` range
  would add a device-side annotation to them); ``spans()`` reads the
  spans of the newest recording, kept in memory until the next starts;
- ``profile_trace``: a ``torch.profiler`` trace (CPU and CUDA activities)
  around a block, written as a Chrome trace into ``logdir``, with the
  spans of every thread on the kernels' timeline;
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

import json
import os
import tempfile
import threading
import time
import warnings
from contextlib import contextmanager
from typing import List, Optional

import torch
import torch.autograd.profiler as _profiler

# the text of the warning CUDA's sync debug mode gives at each sync
SYNC_WARNING = "called a synchronizing CUDA operation"


class Span:
    """One recorded span (see the module's docstring)."""

    __slots__ = ("name", "stage", "parent", "ids", "t0", "t1", "syncs",
                 "children")

    def __init__(self, name: str, ids: dict, parent: Optional["Span"],
                 stage: str):
        self.name, self.ids, self.parent, self.stage = name, ids, parent, \
            stage
        self.t0 = self.t1 = 0
        self.syncs = 0
        self.children: List[Span] = []

    def __enter__(self):
        RECORDER.stack().append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        RECORDER.stack().pop()
        if self.parent is not None:
            self.parent.children.append(self)
        RECORDER.done.append(self)
        return False

    @property
    def self_ns(self) -> int:
        """The duration less the part of it that child spans cover."""
        covered, end = 0, self.t0
        for c in sorted(self.children, key=lambda c: c.t0):
            lo, hi = max(c.t0, end), min(c.t1, self.t1)
            if hi > lo:
                covered += hi - lo
                end = hi
        return self.t1 - self.t0 - covered

    def subtree_syncs(self) -> int:
        """Syncs inside the span, its children's included."""
        return self.syncs + sum(c.subtree_syncs() for c in self.children)


class _NullSpan:
    """The span ``span()`` returns while nothing records."""

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class Recorder:
    """The process's spans: each thread's stack of open spans, the closed
    spans of the newest recording, and the sync counting a recording
    turns on (started and stopped with the profiler)."""

    def __init__(self):
        self._local = threading.local()
        self.done: List[Span] = []
        self.loose_syncs = 0
        self._saved: Optional[tuple] = None
        self._show = warnings.showwarning

    def stack(self) -> List[Span]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def open(self, name: str, ids: dict) -> Span:
        st = self.stack()
        return Span(name, ids, st[-1] if st else None,
                    threading.current_thread().name)

    def start(self):
        self.done = []
        self.loose_syncs = 0
        if self._saved is None and torch.cuda.is_available():
            ctx = warnings.catch_warnings()
            ctx.__enter__()
            warnings.filterwarnings("always", message=SYNC_WARNING)
            self._show = warnings.showwarning
            self._saved = (ctx, torch.cuda.get_sync_debug_mode())
            warnings.showwarning = self._on_warning
            torch.cuda.set_sync_debug_mode("warn")

    def stop(self):
        if self._saved is not None:
            ctx, mode = self._saved
            self._saved = None
            torch.cuda.set_sync_debug_mode(mode)
            ctx.__exit__(None, None, None)

    def _on_warning(self, message, category, filename, lineno, file=None,
                    line=None):
        if self._saved is not None and str(message).startswith(SYNC_WARNING):
            st = self.stack()
            if st:
                st[-1].syncs += 1
            else:
                self.loose_syncs += 1
            return
        self._show(message, category, filename, lineno, file, line)


RECORDER = Recorder()


def span(name: str, **ids):
    """A span named ``name`` with ``ids`` around a block: a recorded
    :class:`Span` while a profiler records, else a shared no-op."""
    if not _profiler._is_profiler_enabled:
        return _NULL_SPAN
    return RECORDER.open(name, ids)


def spans(name: Optional[str] = None) -> List[Span]:
    """The closed spans of the newest recording (those named ``name``)."""
    return [s for s in RECORDER.done if name is None or s.name == name]


def _hook_profiler():
    """Start and stop the recorder with every profiler."""
    start, stop = (_profiler._run_on_profiler_start,
                   _profiler._run_on_profiler_stop)
    if getattr(start, "recorder", None) is RECORDER:
        return

    def on_start():
        start()
        RECORDER.start()

    def on_stop():
        RECORDER.stop()
        stop()
    on_start.recorder = RECORDER
    _profiler._run_on_profiler_start = on_start
    _profiler._run_on_profiler_stop = on_stop


_hook_profiler()


# NVIDIA H100 SXM (the 80GB HBM3 card) data sheet, dense (no sparsity):
# bf16 tensor-core and fp32 (non-tensor) FLOP/s
_PEAKS = {"H100 80GB HBM3": {"bf16": 989e12, "f32": 67e12}}


def device_peak_flops(dtype: str = "bf16") -> tuple:
    """(card name, dense peak FLOP/s for ``dtype`` "bf16" or "f32") of the
    current CUDA device; the rate is None for a card not in the table."""
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
    that opened it and the CUDA kernels of every thread; the program's
    spans of every thread are added, a row per stage."""
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
    _add_spans_to_trace(path)
    print(f"trace written to {path} ({secs:.2f}s)", flush=True)


def _add_spans_to_trace(path: str):
    """Append the newest recording's spans to the Chrome trace at
    ``path``: complete events on the trace's clock (the profiler's
    ``time.time_ns()`` less the trace's ``baseTimeNanoseconds``, in us),
    one row per stage, with the span's ids, syncs and self time."""
    with open(path) as f:
        trace = json.load(f)
    off = (time.time_ns() - time.perf_counter_ns()
           - int(trace.get("baseTimeNanoseconds", 0)))
    pid, rows, events = os.getpid(), {}, trace["traceEvents"]
    for s in spans():
        if s.stage not in rows:
            rows[s.stage] = tid = 1 << 30 | len(rows)
            events.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tid, "args": {"name": f"spans {s.stage}"}})
        events.append({"ph": "X", "cat": "span", "name": s.name, "pid": pid,
                       "tid": rows[s.stage], "ts": (s.t0 + off) / 1e3,
                       "dur": (s.t1 - s.t0) / 1e3,
                       "args": dict(s.ids, syncs=s.syncs,
                                    self_us=s.self_ns / 1e3)})
    with open(path, "w") as f:
        json.dump(trace, f)


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
    if not device_split:
        return None
    kind = torch.device(base).type
    count = torch.cuda.device_count() if kind == "cuda" else 1
    if count < 2:
        print("device_split requested but only one device visible; "
              "falling back to shared-device scheduling")
        return None
    return torch.device(kind, 1)
