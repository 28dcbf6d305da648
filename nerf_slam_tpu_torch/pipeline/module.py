"""Pipeline module abstraction: MIMO stages connected by queues.

The lifecycle of NeRF-SLAM's pipeline runtime (pipeline_module.py):
``spin()`` loops get-input -> spin_once -> push-output, MIMO fan-in/out,
failure callbacks, cooperative shutdown.  Stages are threads of one
process, so device tensors pass between them without pickling.
"""
from __future__ import annotations

import queue
import threading
import time
import traceback
from abc import ABC, abstractmethod
from typing import Any, Callable, Dict, List, Optional


class PipelineModule(ABC):
    """Single-input single-output stage with optional extra IO."""

    def __init__(self, name: str, parallel_run: bool = True,
                 input_timeout: Optional[float] = None):
        self.name = name
        self.parallel_run = parallel_run
        self.shutdown = False
        self.failed = False       # spin_once raised; see runner checks
        self.is_initialized = False
        self.input_queues: Dict[str, "queue.Queue"] = {}
        self.output_queues: List["queue.Queue"] = []
        self.output_callbacks: List[Callable[[Any], None]] = []
        self.on_failure_callbacks: List[Callable[[], None]] = []
        self.input_timeout = input_timeout   # None = blocking
        self.spin_time_s = 0.0
        self.spin_count = 0

    # wiring ------------------------------------------------------------
    def register_input_queue(self, name: str, q: "queue.Queue"):
        self.input_queues[name] = q

    def register_output_queue(self, q: "queue.Queue"):
        self.output_queues.append(q)

    def register_output_callback(self, cb: Callable[[Any], None]):
        self.output_callbacks.append(cb)

    def register_on_failure_callback(self, cb: Callable[[], None]):
        self.on_failure_callbacks.append(cb)

    # lifecycle ----------------------------------------------------------
    def initialize_module(self):
        """Lazy init inside the worker thread (reference :20-25)."""
        self.is_initialized = True

    @abstractmethod
    def spin_once(self, packet: Any) -> Any:
        ...

    def get_input_packet(self) -> Any:
        """Fan-in: one packet from each named queue (reference :159-177).
        Returns None when all inputs are empty (non-blocking modules)."""
        if not self.input_queues:
            return {}
        out = {}
        got_any = False
        for name, q in self.input_queues.items():
            try:
                if self.input_timeout is None:
                    pkt = q.get(timeout=0.5)
                else:
                    pkt = q.get(timeout=self.input_timeout)
                got_any = True
            except queue.Empty:
                pkt = None
            out[name] = pkt
        return out if got_any else None

    def push_output_packet(self, packet: Any, max_wait_s: float = 10.0):
        """Push to all consumers; a consumer that stopped draining (e.g.
        SLAM terminated at buffer-full while the source keeps producing)
        must not deadlock the producer -- drop after a bounded wait."""
        if packet is None:
            return
        for q in self.output_queues:
            deadline = time.time() + max_wait_s
            while True:
                try:
                    q.put(packet, timeout=0.25)
                    break
                except queue.Full:
                    if time.time() > deadline:
                        break  # consumer gone: drop
        for cb in self.output_callbacks:
            cb(packet)

    def spin(self):
        """Main loop (reference :83-122).  In sequential mode handles at
        most one packet per call."""
        if not self.is_initialized:
            self.initialize_module()
        while not self.shutdown:
            pkt = self.get_input_packet()
            if pkt is None and self.input_queues and self.input_timeout \
                    is None:
                if not self.parallel_run:
                    return True
                continue
            t0 = time.perf_counter()
            try:
                out = self.spin_once(pkt)
            except Exception:
                traceback.print_exc()
                self.failed = True
                for cb in self.on_failure_callbacks:
                    cb()
                self.shutdown_module()
                return False
            self.spin_time_s += time.perf_counter() - t0
            self.spin_count += 1
            if out is None:
                for cb in self.on_failure_callbacks:
                    cb()
            else:
                self.push_output_packet(out)
            if not self.parallel_run:
                return True
        return True

    def shutdown_module(self):
        self.shutdown = True

    def stats(self) -> Dict[str, float]:
        return {"spins": self.spin_count,
                "total_s": self.spin_time_s,
                "mean_ms": 1e3 * self.spin_time_s
                / max(self.spin_count, 1)}


class ModuleThread(threading.Thread):
    def __init__(self, module: PipelineModule):
        super().__init__(name=module.name, daemon=True)
        self.module = module

    def run(self):
        self.module.spin()
