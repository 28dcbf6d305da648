"""SLAM class hierarchy (PyTorch).

The SLAM base runs frontend -> factor accumulation -> backend solve; the
visual(-inertial) SLAM wires the tracker (which solves its own dense BA)
with an optional inertial frontend whose preintegrated factors go to the
incremental backend.  The backend's variables and factors live on
``device``: the card unless the caller asks for the CPU.
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, Dict, Optional, Tuple

import torch

from ..solver.factor_graph import FactorGraph, Variables
from ..solver.nonlinear import IncrementalSolver


class SLAM(ABC):
    """frontend -> add factors -> backend solve."""

    def __init__(self, name: str, device: str = "cuda"):
        self.name = name
        self.device = torch.device(device)
        self.graph = FactorGraph()
        self.backend = IncrementalSolver()

    def __call__(self, batch: Dict[str, Any]):
        """-> (backend SolverResult or None, the frontend's output)."""
        x0, factors, viz_out = self._frontend(batch)
        if factors is not None and len(factors):
            for f in factors.factors.values():
                self.graph.add(f.to(self.device))
        state = None
        if len(self.graph) and x0 is not None:
            state = self.backend.update(self.graph, x0.to(self.device))
        return state, viz_out

    @abstractmethod
    def _frontend(self, batch) -> Tuple[Optional[Variables],
                                        Optional[FactorGraph], Any]:
        ...

    def stop_condition(self) -> bool:
        return False


class VioSLAM(SLAM):
    """Visual(-inertial) SLAM: the visual frontend runs its DBA
    internally; an optional inertial frontend contributes preintegrated
    factors to the backend graph."""

    def __init__(self, visual_frontend, inertial_frontend=None,
                 device: str = "cuda"):
        super().__init__("VioSLAM", device)
        self.visual_frontend = visual_frontend
        self.inertial_frontend = inertial_frontend

    def _frontend(self, batch):
        viz_out = self.visual_frontend(batch["k"], batch)
        x0, factors = None, None
        if self.inertial_frontend is not None:
            # the frontend gates on imu_t0_t1 itself (frame 0 has no
            # window but must seed the state-0 priors)
            x0, factors = self.inertial_frontend(batch)
        return x0, factors, viz_out

    def stop_condition(self) -> bool:
        return self.visual_frontend.stop_condition()
