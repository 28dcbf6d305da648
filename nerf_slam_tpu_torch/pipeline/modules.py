"""Concrete pipeline stages: data source, SLAM, fusion, GUI, eval sink.

Equivalents of NeRF-SLAM's DataModule / SlamModule / FusionModule /
GuiModule wrappers.  The SLAM, fusion and GUI stages hold
``utils.runtime.DEVICE_LOCK`` around their device work when they run as
threads (looked up at each spin, so a caller may swap in the no-op lock),
inside the spans ``lock.wait`` (acquiring it) and ``lock.hold``.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Any, Dict, Optional

from ..fusion.nerf_fusion import MASK_TYPES
from ..slam.meta_slam import SLAM
from ..utils import runtime
from .module import PipelineModule


@contextmanager
def _device_lock():
    """``runtime.DEVICE_LOCK`` (looked up now) around the block, its
    acquisition in a ``lock.wait`` span and the block in ``lock.hold``."""
    lock = runtime.DEVICE_LOCK
    with runtime.span("lock.wait"):
        lock.acquire()
    try:
        with runtime.span("lock.hold"):
            yield
    finally:
        lock.release()


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
    """Tracking stage wrapping a RaftVisualFrontend or a SLAM object
    (``VioSLAM``), whose call returns (backend state, tracker output)."""

    def __init__(self, frontend, parallel_run: bool = True):
        super().__init__("slam", parallel_run)
        self.frontend = frontend
        self._is_slam = isinstance(frontend, SLAM)

    def spin_once(self, packet):
        if isinstance(packet, dict) and "data" in packet:
            packet = packet["data"]
        if packet is None:
            return None
        with _device_lock():
            if self._is_slam:
                _, out = self.frontend(packet)
            else:
                out = self.frontend(packet["k"], packet)
        if self.frontend.stop_condition():
            self.shutdown_module()
        return out


class FusionModule(PipelineModule):
    """Mapping stage.  ``mode`` "nerf": non-blocking input, so the field
    keeps training between SLAM packets, and the stage ends
    ``extra_spins_after_done`` spins after the last packet; "sigma" or
    "tsdf" (a :class:`TsdfFusion`): each packet is integrated, and the
    stage ends at the last one."""

    def __init__(self, fusion, mode: str = "nerf",
                 parallel_run: bool = True, iters_per_spin: int = 10,
                 extra_spins_after_done: int = 50,
                 idle_sleep_s: float = 0.05):
        super().__init__("fusion", parallel_run, input_timeout=1e-3)
        if mode not in ("nerf", "sigma", "tsdf"):
            raise ValueError(f"unknown fusion mode {mode!r}")
        self.fusion = fusion
        self.mode = mode
        self.iters_per_spin = iters_per_spin
        self.extra_spins_after_done = extra_spins_after_done
        # sharing one card with tracking, an unthrottled mapping loop
        # would starve it: idle spins yield outside the lock
        self.idle_sleep_s = idle_sleep_s
        self.done = False
        self._spins_since_done = 0

    def handle_command(self, cmd: Dict[str, Any]):
        """A viewer's command to the map: ``mesh`` (an .obj at
        ``cmd["path"]``), ``eval`` (a NeRF results row), ``sigma_thresh``
        (the masking threshold of packets fused from now on), ``rebuild``
        (TSDF: replay the history, at ``cmd["value"]`` if given) and
        ``toggle_mask`` (NeRF: the next ``mask_type``)."""
        name = cmd.get("cmd")
        fusion = self.fusion
        if name == "mesh":
            out = cmd.get("path", "fusion_mesh.obj")
            if self.mode == "nerf":
                fusion.extract_mesh(path=out)
            else:
                from ..fusion.mesher import write_obj
                verts, faces, colors = fusion.extract_mesh()
                write_obj(out, verts, faces, colors)
            print(f"[fusion] mesh written to {out}")
        elif name == "eval":
            if hasattr(fusion, "evaluate_training_views"):
                print(f"[fusion] eval: {fusion.evaluate_training_views()}")
        elif name == "sigma_thresh":
            fusion.set_sigma_thresh(float(cmd.get("value", 10.0)))
        elif name == "rebuild":
            if hasattr(fusion, "rebuild"):
                if "value" in cmd:
                    fusion.rebuild(float(cmd["value"]))
                else:
                    fusion.rebuild()
        elif name == "toggle_mask":
            cfg = getattr(fusion, "cfg", None)
            if cfg is not None and hasattr(cfg, "mask_type"):
                cur = MASK_TYPES.index(cfg.mask_type)
                cfg.mask_type = MASK_TYPES[(cur + 1) % len(MASK_TYPES)]

    def spin_once(self, packet):
        pkt, gui_pkt = packet, None
        if isinstance(packet, dict) and ("slam" in packet
                                         or "gui" in packet):
            pkt, gui_pkt = packet.get("slam"), packet.get("gui")
        with _device_lock():
            if gui_pkt is not None:
                for cmd in gui_pkt.get("gui_commands", []):
                    self.handle_command(cmd)
            if self.mode == "nerf":
                self.done = (self.fusion.fuse_and_fit(pkt,
                                                      self.iters_per_spin)
                             or self.done)
            elif pkt is not None:
                self.done = self.fusion.fuse(pkt) or self.done
        if pkt is None and not self.done and self.parallel_run \
                and self.idle_sleep_s > 0:
            time.sleep(self.idle_sleep_s)
        if self.done:
            self._spins_since_done += 1
            if (self.mode != "nerf" or self._spins_since_done
                    >= self.extra_spins_after_done):
                self.shutdown_module()
        return {"fusion_step": getattr(self.fusion, "iteration", 0)}


class GuiModule(PipelineModule):
    """Visualization stage wrapping a :class:`gui.HeadlessGui` or
    :class:`gui.LiveViewer`; the GUI's queued commands leave through its
    output queue, which the CLI connects to the fusion stage (the GUI ->
    fusion back-channel)."""

    def __init__(self, gui, parallel_run: bool = True):
        super().__init__("gui", parallel_run, input_timeout=1e-3)
        self.gui = gui

    def spin_once(self, packet):
        pkt = packet.get("slam") if isinstance(packet, dict) else packet
        if pkt is not None:
            with _device_lock():
                self.gui.visualize(pkt)
            if pkt.get("is_last_frame"):
                self.shutdown_module()
        cmds = self.gui.pop_commands()
        return {"gui_commands": cmds} if cmds else None


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
