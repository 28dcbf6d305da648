"""Concrete pipeline stages: data source, SLAM, fusion, eval sink.

Equivalents of NeRF-SLAM's DataModule / SlamModule / FusionModule
wrappers.  ``DEVICE_LOCK`` serializes the SLAM and fusion stages' device
work when they run as threads, so one stage's host syncs never interleave
with the other's launches on the shared stream.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional

from .module import PipelineModule

DEVICE_LOCK = threading.RLock()


class DataModule(PipelineModule):
    """Source stage: iterates a dataset."""

    def __init__(self, dataset, parallel_run: bool = True,
                 img_stride: int = 1):
        super().__init__("data", parallel_run)
        self.dataset = dataset
        self.img_stride = img_stride
        self._idx = 0
        self._out_k = 0

    def spin_once(self, _):
        n = len(self.dataset)
        if self._idx >= n:
            self.shutdown_module()
            return None
        pkt = dict(self.dataset[self._idx])
        pkt["k"] = self._out_k
        pkt["is_last_frame"] = bool(pkt.get("is_last_frame", False)
                                    or self._idx + self.img_stride >= n)
        self._idx += self.img_stride
        self._out_k += 1
        if pkt["is_last_frame"]:
            self.shutdown_module()
        return pkt


class SlamModule(PipelineModule):
    """Tracking stage wrapping a RaftVisualFrontend."""

    def __init__(self, frontend, parallel_run: bool = True):
        super().__init__("slam", parallel_run)
        self.frontend = frontend

    def spin_once(self, packet):
        if isinstance(packet, dict) and "data" in packet:
            packet = packet["data"]
        if packet is None:
            return None
        with DEVICE_LOCK:
            out = self.frontend(packet["k"], packet)
        if self.frontend.stop_condition():
            self.shutdown_module()
        return out


class FusionModule(PipelineModule):
    """Mapping stage (NeRF): non-blocking input, so the field keeps
    training between SLAM packets."""

    def __init__(self, fusion, parallel_run: bool = True,
                 iters_per_spin: int = 10, extra_spins_after_done: int = 50,
                 idle_sleep_s: float = 0.05):
        super().__init__("fusion", parallel_run, input_timeout=1e-3)
        self.fusion = fusion
        self.iters_per_spin = iters_per_spin
        self.extra_spins_after_done = extra_spins_after_done
        # sharing one card with tracking, an unthrottled mapping loop
        # would starve it: idle spins yield outside the lock
        self.idle_sleep_s = idle_sleep_s
        self.done = False
        self._spins_since_done = 0

    def spin_once(self, packet):
        pkt = packet.get("slam") if isinstance(packet, dict) else packet
        with DEVICE_LOCK:
            self.done = (self.fusion.fuse_and_fit(pkt, self.iters_per_spin)
                         or self.done)
        if pkt is None and not self.done and self.parallel_run \
                and self.idle_sleep_s > 0:
            time.sleep(self.idle_sleep_s)
        if self.done:
            self._spins_since_done += 1
            if self._spins_since_done >= self.extra_spins_after_done:
                self.shutdown_module()
        return {"fusion_step": self.fusion.iteration}


class EvalSink(PipelineModule):
    """Collects SLAM packets for evaluation (GT poses etc.)."""

    def __init__(self, parallel_run: bool = True):
        super().__init__("eval", parallel_run)
        self.packets = []
        self.last_full: Optional[Dict[str, Any]] = None

    def spin_once(self, packet):
        if isinstance(packet, dict) and "slam" in packet:
            packet = packet["slam"]
        if packet is None:
            return None
        self.packets.append(packet)
        if "cam0_poses" in packet:
            self.last_full = packet
        if packet.get("is_last_frame"):
            self.shutdown_module()
        return packet
