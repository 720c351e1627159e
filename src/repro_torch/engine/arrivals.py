"""Request sources: Poisson arrivals and trace-driven replay (the port's copy
of ``repro.engine.arrivals``; the same seed gives the same requests).

A source is a callable ``source(t) -> list[Request]`` returning the requests
arriving by backend-clock time ``t``; ``PlacementEngine.run`` polls it every
interval.  ``TraceSource`` replays an explicit ``[N, 3]`` array of
``(arrival_s, app_id, sla_s)`` rows — recorded production traces drive the
simulator the same way synthetic Poisson streams do.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.configs.paper_workloads import WORKLOADS
from repro_torch.engine.types import APPS, Request


class PoissonSource:
    """Poisson arrivals over the paper's application classes.

    SLA = base_latency * U(sla_range), like the sim workload generator.  When
    ``prompt_len``/``vocab_size`` are set, requests carry random prompts so
    the same source drives the TorchBackend.
    """

    def __init__(self, *, rate: float = 0.6, seed: int = 0,
                 sla_range=(0.5, 3.0), prompt_len: Optional[int] = None,
                 vocab_size: Optional[int] = None, max_new: int = 8):
        self.rate = rate
        self.rng = np.random.default_rng(seed)
        self.sla_range = sla_range
        self.prompt_len = prompt_len
        self.vocab_size = vocab_size
        self.max_new = max_new
        self._next_rid = 0

    def _make(self, t: float, app_id: int, sla: float) -> Request:
        tokens = None
        if self.prompt_len is not None:
            tokens = self.rng.integers(
                0, self.vocab_size or 128, self.prompt_len).astype(np.int32)
        r = Request(self._next_rid, app_id, tokens=tokens, sla_s=float(sla),
                    max_new=self.max_new, arrival_s=t)
        self._next_rid += 1
        return r

    def __call__(self, t: float):
        out = []
        for _ in range(self.rng.poisson(self.rate)):
            app_id = int(self.rng.integers(len(APPS)))
            sla = WORKLOADS[APPS[app_id]].base_latency_s \
                * self.rng.uniform(*self.sla_range)
            out.append(self._make(t, app_id, sla))
        return out


class TraceSource:
    """Replay an explicit arrival trace: rows of (arrival_s, app_id, sla_s),
    sorted by arrival time."""

    def __init__(self, trace, *, prompt_len: Optional[int] = None,
                 vocab_size: Optional[int] = None, max_new: int = 8,
                 seed: int = 0):
        trace = np.asarray(trace, np.float64).reshape(-1, 3)
        order = np.argsort(trace[:, 0], kind="stable")
        self.trace = trace[order]
        self.rng = np.random.default_rng(seed)
        self.prompt_len = prompt_len
        self.vocab_size = vocab_size
        self.max_new = max_new
        self._i = 0

    def __len__(self):
        return len(self.trace)

    @property
    def exhausted(self) -> bool:
        return self._i >= len(self.trace)

    def __call__(self, t: float):
        out = []
        while self._i < len(self.trace) and self.trace[self._i, 0] <= t:
            arr, app_id, sla = self.trace[self._i]
            tokens = None
            if self.prompt_len is not None:
                tokens = self.rng.integers(
                    0, self.vocab_size or 128,
                    self.prompt_len).astype(np.int32)
            out.append(Request(self._i, int(app_id), tokens=tokens,
                               sla_s=float(sla), max_new=self.max_new,
                               arrival_s=float(arr)))
            self._i += 1
        return out
