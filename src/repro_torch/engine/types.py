"""Shared request-lifecycle types for the placement engine (a copy of
``repro.engine.types``, so that the port and the JAX package exchange the
same schema; ``TorchBackend`` fills what ``JaxBackend`` fills).

One schema serves both execution backends (``repro.engine.sim_backend`` and
``repro.engine.jax_backend``): a ``Request`` is admitted, a ``Policy`` decides
its split mode, the backend executes it, and the completed run comes back as
an ``Outcome`` that feeds the policy and the shared ``EngineStats`` (the
paper's Table-I metrics schema).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch.configs.paper_workloads import WORKLOADS
from repro_torch.obs.metrics import Histogram

# Split decisions — shared by repro.sim, repro.core.mab and both backends.
LAYER, SEMANTIC, COMPRESSED = 0, 1, 2
MODE_NAMES = {LAYER: "layer", SEMANTIC: "semantic", COMPRESSED: "compressed"}

#: application classes, in stable id order (app_id indexes this list)
APPS = list(WORKLOADS)


def next_pow2(n: int) -> int:
    """Smallest power of two >= n — THE bucketing rule for every jit key in
    the serving stack (batch widths, prompt pads, decide waves, scan
    lengths), shared so the compile-churn policy can't drift per call site."""
    p = 1
    while p < n:
        p *= 2
    return p


def accuracy_for(app_id: int, decision: int) -> float:
    """Per-app accuracy of a split decision — single source of truth
    (``repro.configs.paper_workloads.WORKLOADS``) for both backends."""
    prof = WORKLOADS[APPS[app_id]]
    if decision == LAYER:
        return prof.accuracy
    if decision == SEMANTIC:
        return prof.accuracy - prof.sem_accuracy_drop
    return prof.accuracy - prof.comp_accuracy_drop


def reward_for(response_time: float, sla: float, accuracy: float) -> float:
    """The paper's per-workload reward (§III-B), numpy-scalar flavor."""
    return (float(response_time <= sla) + float(accuracy)) / 2.0


@dataclass
class Request:
    """One inference job flowing through the engine lifecycle.

    ``ctx`` is a declared field (the policy's decision context, e.g. the MAB
    context bucket) — policies must not inject ad-hoc attributes.  Latency
    fields report *true* per-request time: queue wait + execution, measured
    from admission to completion.
    """
    rid: int
    app_id: int
    tokens: Optional[np.ndarray] = None   # prompt (JaxBackend only)
    sla_s: float = 1.0
    max_new: int = 8
    arrival_s: Optional[float] = None     # admission time (backend clock)
    decision: Optional[int] = None
    ctx: Optional[object] = None          # policy decision context
    queue_wait_s: float = 0.0
    latency_s: float = 0.0
    ttft_s: float = 0.0                   # admission -> first generated token
    accuracy: float = 0.0
    output: Optional[np.ndarray] = None   # generated tokens (JaxBackend)
    # backend-clock stamp of the last fault that disrupted this request
    # (0.0 = undisturbed); the next successful (re)admission observes
    # ``now - fault_t`` into the recovery-latency histogram and clears it
    fault_t: float = 0.0
    # shared-prefix trace annotations for SimBackend's per-host prefix-hit
    # model (JaxBackend derives both from the real tokens instead):
    # requests of the same family share a prompt head covering
    # ``prefix_frac`` of the work a cache hit would save
    prefix_family: int = -1
    prefix_frac: float = 0.0

    @property
    def wid(self) -> int:
        """Workload id — placement policies key episodes on this."""
        return self.rid


@dataclass
class Outcome:
    """A completed request, as reported by an execution backend."""
    request: Request
    decision: int
    latency_s: float          # response time: completion - admission
    queue_wait_s: float
    accuracy: float
    finish_s: float           # backend-clock completion time
    # graceful-degradation terminals: a shed request was dropped by
    # deadline-aware load shedding (its deadline had already passed), a
    # failed one exhausted its retry budget.  Neither produced tokens;
    # EngineStats counts them separately and policies never observe them.
    shed: bool = False
    failed: bool = False

    # -- placement-policy feedback surface (A3C keys on these) -------------
    @property
    def wid(self) -> int:
        return self.request.rid

    @property
    def app_id(self) -> int:
        return self.request.app_id

    @property
    def sla(self) -> float:
        return self.request.sla_s

    @property
    def response_time(self) -> float:
        return self.latency_s

    @property
    def violated(self) -> bool:
        return self.latency_s > self.request.sla_s

    @property
    def reward(self) -> float:
        return reward_for(self.latency_s, self.request.sla_s, self.accuracy)


@dataclass
class EngineStats:
    """The shared metrics schema (paper Table I) both backends produce.

    The KV-cache block (``prefix_hit_rate`` .. ``spilled_blocks``) is filled
    from the serving backend's ``extra_metrics`` when the backend runs the
    shared paged cache (``repro.decode``); backends without one leave the
    zeros.
    """
    completed: int = 0
    violations: int = 0
    per_mode: Dict[str, int] = field(default_factory=dict)
    rewards: List[float] = field(default_factory=list)
    latencies: List[float] = field(default_factory=list)
    queue_waits: List[float] = field(default_factory=list)
    accuracies: List[float] = field(default_factory=list)
    decisions: List[int] = field(default_factory=list)
    # shared paged-KV cache counters (JaxBackend paged decode path)
    prefix_hit_rate: float = 0.0
    cow_copies: int = 0
    preemptions: int = 0
    spilled_blocks: int = 0
    # quantized-serving telemetry (kv_dtype="int8" / weight_quant knobs):
    # effective KV-capacity multiplier vs f32 (1.0 when unquantized) and the
    # max absolute weight dequantization error across quantized projections
    kv_capacity_x: float = 1.0
    kv_block_bytes: int = 0
    weight_quant_max_err: float = 0.0
    # disaggregated-serving telemetry (JaxBackend fleet="disagg"): blocks
    # moved prefill->decode through the cache store, their wire bytes, and
    # the mean admission->first-token latency across completed requests
    blocks_shipped: int = 0
    transfer_bytes: int = 0
    ttft_s: float = 0.0
    # ship latency percentiles (open shipment -> seated on the decode
    # worker), mirrored from the cache store's histogram via extra_metrics
    ship_latency_p50: float = 0.0
    ship_latency_p95: float = 0.0
    ship_latency_p99: float = 0.0
    # fault-injection / recovery telemetry (repro.faults): injected fault
    # count, dispatch retries, full re-executions (blackout spills, dropped
    # shipments, crash-displaced fragments), recovered requests and the
    # fault->re-admission latency percentiles — all mirrored from the
    # backend's extra_metrics.  ``shed``/``failed`` count the engine-side
    # graceful-degradation terminals (never part of ``completed``).
    faults_injected: int = 0
    retries: int = 0
    re_executions: int = 0
    recovered: int = 0
    recovery_latency_p50: float = 0.0
    recovery_latency_p95: float = 0.0
    recovery_latency_p99: float = 0.0
    shed: int = 0
    failed: int = 0
    # fleet-routing telemetry (cache-status sync): requests routed through
    # the placement layer, the mean cached-prefix overlap the router
    # expected at its chosen replicas, and the add/drop delta messages the
    # board consumed (the incremental sync's wire traffic)
    routed: int = 0
    route_expected_overlap: float = 0.0
    sync_deltas: int = 0
    # streaming per-request latency distributions (repro.obs log-bucket
    # histograms): response time, queue wait, TTFT and TPOT (per-output-
    # token latency after the first).  Percentiles come out of these —
    # scalar means alone hide exactly the tail the SLA metric punishes.
    response_hist: Histogram = field(default_factory=Histogram)
    queue_hist: Histogram = field(default_factory=Histogram)
    ttft_hist: Histogram = field(default_factory=Histogram)
    tpot_hist: Histogram = field(default_factory=Histogram)

    def record(self, o: Outcome) -> None:
        if o.shed or o.failed:
            # degradation terminals: counted, never mixed into the
            # completed-request latency/reward/accuracy distributions
            self.shed += int(o.shed)
            self.failed += int(o.failed)
            return
        self.completed += 1
        self.violations += int(o.violated)
        name = MODE_NAMES.get(o.decision, str(o.decision))
        self.per_mode[name] = self.per_mode.get(name, 0) + 1
        self.rewards.append(o.reward)
        self.latencies.append(o.latency_s)
        self.queue_waits.append(o.queue_wait_s)
        self.accuracies.append(o.accuracy)
        self.decisions.append(o.decision)
        self.response_hist.observe(o.latency_s)
        self.queue_hist.observe(o.queue_wait_s)
        req = o.request
        if req.ttft_s > 0:
            self.ttft_hist.observe(req.ttft_s)
            n_out = len(req.output) if req.output is not None else req.max_new
            if n_out > 1:
                # ttft and latency are both admission-based, so the delta
                # is pure decode time for the remaining n_out - 1 tokens
                self.tpot_hist.observe(
                    max(o.latency_s - req.ttft_s, 0.0) / (n_out - 1))

    def percentiles(self) -> dict:
        """p50/p95/p99 over the streaming histograms (keys absent until the
        matching signal has been observed — sim runs carry no TTFT)."""
        out = {}
        for prefix, h in (("response", self.response_hist),
                          ("queue_wait", self.queue_hist),
                          ("ttft", self.ttft_hist),
                          ("tpot", self.tpot_hist)):
            for q in (50, 95, 99):
                if h.n:
                    out[f"{prefix}_p{q}"] = round(h.percentile(q), 6)
        return out

    def summary(self) -> dict:
        n = max(self.completed, 1)
        degraded = {"shed": self.shed, "failed": self.failed} \
            if (self.shed or self.failed) else {}
        return {
            **degraded,
            "completed": self.completed,
            "sla_violation": round(self.violations / n, 4),
            "accuracy": round(float(np.mean(self.accuracies)), 4)
            if self.accuracies else 0.0,
            "reward": round(float(np.mean(self.rewards)), 4)
            if self.rewards else 0.0,
            "mean_response_s": round(float(np.mean(self.latencies)), 4)
            if self.latencies else 0.0,
            "mean_queue_wait_s": round(float(np.mean(self.queue_waits)), 4)
            if self.queue_waits else 0.0,
            "per_mode": dict(self.per_mode),
            "decisions_semantic_frac": round(float(np.mean(
                [d == SEMANTIC for d in self.decisions])), 4)
            if self.decisions else 0.0,
            **self.percentiles(),
        }
