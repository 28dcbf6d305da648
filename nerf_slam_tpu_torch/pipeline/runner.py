"""Pipeline wiring + sequential / parallel execution.

Equivalent of examples/slam_demo.py:62-190's run() control flow: either
spawn one worker per stage (threads here, processes there) or round-robin
spin everything in the caller's thread for deterministic debugging
(reference :166-188).
"""
from __future__ import annotations

import queue
import time
from typing import List, Optional

from .module import ModuleThread, PipelineModule


def connect(src: PipelineModule, dst: PipelineModule, name: str,
            maxsize: int = 8) -> "queue.Queue":
    q = queue.Queue(maxsize=maxsize)
    src.register_output_queue(q)
    dst.register_input_queue(name, q)
    return q


def run_sequential(modules: List[PipelineModule],
                   max_spins: Optional[int] = None) -> None:
    """Round-robin spin until every module has shut down."""
    for m in modules:
        m.parallel_run = False
        if not m.is_initialized:
            m.initialize_module()
    spins = 0
    while not all(m.shutdown for m in modules):
        for m in modules:
            if not m.shutdown:
                m.spin()
        if any(m.failed for m in modules):
            # a crashed stage starves its consumers forever; fail the
            # run instead of spinning the survivors indefinitely
            for m in modules:
                m.shutdown_module()
            bad = [m.name for m in modules if m.failed]
            raise RuntimeError(f"pipeline stage(s) failed: {bad}")
        spins += 1
        if max_spins is not None and spins >= max_spins:
            break
    for m in modules:
        m.shutdown_module()


def run_parallel(modules: List[PipelineModule],
                 timeout_s: Optional[float] = None) -> None:
    """One thread per module; returns when the terminal stages finish."""
    for m in modules:
        m.parallel_run = True
    threads = [ModuleThread(m) for m in modules]
    for t in threads:
        t.start()
    t0 = time.time()
    # a source shutting down cascades: when a module with no consumers
    # left sees is_last_frame it shuts down.  Poll-join so a CRASHED
    # stage (m.failed) tears the whole pipeline down instead of starving
    # its consumers until the timeout.
    alive = list(threads)
    while alive:
        for t in list(alive):
            t.join(timeout=0.25)
            if not t.is_alive():
                alive.remove(t)
        if any(m.failed for m in modules):
            for m in modules:
                m.shutdown_module()
            for t in alive:
                t.join(timeout=5.0)
            bad = [m.name for m in modules if m.failed]
            raise RuntimeError(f"pipeline stage(s) failed: {bad}")
        if timeout_s is not None and time.time() - t0 > timeout_s:
            break
    for m in modules:
        m.shutdown_module()
