"""PlacementEngine — the one request lifecycle over any execution backend.

    Request -> admit -> decide (Policy) -> place -> execute (backend)
            -> observe/feedback -> EngineStats

The engine owns admission, decision timing, policy feedback and the shared
metrics schema; the backend owns execution (simulated hosts or real JAX
runners).  The same ``Policy`` instance runs unchanged against both.
"""
from __future__ import annotations

import time
import warnings
from typing import List, Optional, Protocol, runtime_checkable

from repro_torch.engine.types import EngineStats, Outcome, Request
from repro_torch.obs import get_tracer


@runtime_checkable
class ExecutionBackend(Protocol):
    now: float

    def submit(self, request: Request) -> None: ...

    def step(self, policy) -> List[Outcome]: ...

    def pending(self) -> int: ...

    def extra_metrics(self) -> dict: ...


class PlacementEngine:
    def __init__(self, policy, backend):
        self.policy = policy
        self.backend = backend
        self.stats = EngineStats()
        self.decide_time_s = 0.0
        self.n_decisions = 0

    # ------------------------------------------------------------ admission
    def submit(self, requests) -> None:
        """Admit requests: stamp arrival, run the policy decision, hand to
        the backend.  Decisions for a submitted wave all happen before any of
        its observations (the paper's decide-then-run loop).

        A wave of undecided same-tick arrivals is decided in ONE batched
        policy dispatch when the policy supports it (``decide_batch``, e.g.
        the MAB UCB computation) — the per-request dispatch dominates sched
        time at high arrival rates.
        """
        requests = list(requests)
        if not requests:
            return
        tr = get_tracer()
        with tr.span("admit", n=len(requests)):
            for r in requests:
                if r.arrival_s is None:
                    r.arrival_s = self.backend.now
                tr.instant("admit", req=r.rid)
            undecided = [r for r in requests if r.decision is None]
            if len(undecided) > 1 and hasattr(self.policy, "decide_batch"):
                t0 = time.perf_counter()
                with tr.span("decide", n=len(undecided), batched=True):
                    arms = self.policy.decide_batch(undecided)
                self.decide_time_s += time.perf_counter() - t0
                self.n_decisions += len(undecided)
                for r, arm in zip(undecided, arms):
                    r.decision = int(arm)
            else:
                for r in undecided:
                    t0 = time.perf_counter()
                    with tr.span("decide", req=r.rid):
                        r.decision = int(self.policy.decide(r))
                    self.decide_time_s += time.perf_counter() - t0
                    self.n_decisions += 1
            for r in requests:
                self.backend.submit(r)

    # ------------------------------------------------------------ execution
    def step(self) -> List[Outcome]:
        """One backend step; completed outcomes feed the policy and stats."""
        outcomes = self.backend.step(self.policy)
        tr = get_tracer()
        for o in outcomes:
            if not (o.shed or o.failed):
                # degradation terminals carry no execution signal — feeding
                # them to the policy would punish arms for injected faults
                self.policy.observe(o)
            self.stats.record(o)
            tr.instant("observe", req=o.request.rid,
                       violated=bool(o.violated), shed=bool(o.shed),
                       failed=bool(o.failed))
        return outcomes

    def run(self, source=None, n_intervals: int = 100) -> dict:
        """Drive the interval loop: poll arrivals, submit, step."""
        for _ in range(n_intervals):
            if source is not None:
                self.submit(source(self.backend.now))
            self.step()
        return self.summary()

    def drain(self, max_steps: int = 10_000) -> List[Outcome]:
        """Step until the backend has no in-flight work."""
        outcomes: List[Outcome] = []
        steps = 0
        while self.backend.pending() and steps < max_steps:
            outcomes.extend(self.step())
            steps += 1
        if self.backend.pending():
            warnings.warn(
                f"drain: {self.backend.pending()} requests still in flight "
                f"after {max_steps} steps (unplaceable fragments or backlog)",
                RuntimeWarning, stacklevel=2)
        return outcomes

    # -------------------------------------------------------------- metrics
    def summary(self) -> dict:
        s = self.stats.summary()
        extra = dict(self.backend.extra_metrics())
        # mirror the shared paged-cache counters into the stats schema so
        # policy/benchmark code can read them off EngineStats directly
        for f in ("prefix_hit_rate", "cow_copies", "preemptions",
                  "spilled_blocks", "kv_capacity_x", "kv_block_bytes",
                  "weight_quant_max_err", "blocks_shipped", "transfer_bytes",
                  "ttft_s", "ship_latency_p50", "ship_latency_p95",
                  "ship_latency_p99", "faults_injected", "retries",
                  "re_executions", "recovered", "recovery_latency_p50",
                  "recovery_latency_p95", "recovery_latency_p99",
                  "routed", "route_expected_overlap", "sync_deltas"):
            if f in extra:
                setattr(self.stats, f, extra[f])
        sched = self.decide_time_s + extra.pop("place_time_s", 0.0)
        s.update(extra)
        s["sched_time_s"] = round(sched, 4)
        s["sched_ms_per_decision"] = round(
            1e3 * sched / max(self.n_decisions, 1), 3)
        return s
