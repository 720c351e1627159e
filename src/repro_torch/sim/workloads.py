"""Workload generator: Poisson arrivals of DNN inference jobs over the
paper's three application classes, each with an SLA deadline.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.configs.paper_workloads import WORKLOADS

APPS = list(WORKLOADS)


@dataclass
class Workload:
    wid: int
    app: str
    app_id: int
    arrival: float
    sla: float
    # filled as the workload executes
    decision: Optional[int] = None
    ctx: Optional[object] = None
    start: Optional[float] = None
    finish: Optional[float] = None
    accuracy: float = 0.0

    @property
    def response_time(self) -> float:
        return (self.finish - self.arrival) if self.finish else float("inf")

    @property
    def violated(self) -> bool:
        return self.response_time > self.sla


class WorkloadGenerator:
    def __init__(self, *, rate: float = 3.0, seed: int = 0,
                 sla_range=(1.2, 4.0)):
        """rate: mean arrivals per interval.  SLA = base_latency * U(range) —
        tight deadlines force the semantic arm, loose ones allow layer."""
        self.rate = rate
        self.rng = np.random.default_rng(seed)
        self.sla_range = sla_range
        self._next = 0

    def arrivals(self, t: float):
        out = []
        for _ in range(self.rng.poisson(self.rate)):
            app = APPS[self.rng.integers(len(APPS))]
            w = WORKLOADS[app]
            sla = w.base_latency_s * self.rng.uniform(*self.sla_range)
            out.append(Workload(self._next, app, APPS.index(app), t, sla))
            self._next += 1
        return out
