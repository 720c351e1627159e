"""Discrete-interval mobile-edge co-simulator (COSCO-style), the port's copy
of ``repro.sim.simulator``.

Executes split-DNN workloads as container DAGs on the 10-host testbed:
  layer split    : chain of K fragments, activation transfers hop hosts
  semantic split : K parallel branches + a merge transfer (max over branches)
  compression    : single container, lower RAM, lower accuracy (baseline)

All of a workload's containers are placed at arrival (deployment); a
container computes only once its dependencies are done and the activation
transfer has landed.  CPU is shared per host (4 cores, only active containers
consume); network latency/bandwidth is resampled with Gaussian noise every
interval (netlimiter emulation).  Produces the paper's Table-I metrics:
energy, scheduling time, SLA violation rate, accuracy, reward.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from repro_torch.configs.paper_workloads import WORKLOADS
from repro_torch.core.reward import met_reward
from repro_torch.sim.hosts import make_testbed
from repro_torch.sim.network import Network
from repro_torch.sim.workloads import Workload, WorkloadGenerator

LAYER, SEMANTIC, COMPRESSED = 0, 1, 2

RUNTIME_OVERHEAD_MB = 150.0          # container runtime footprint
ACTIVATION_MB = 4.0                  # inter-fragment feature-map size
# SplitNet's block-diagonal weights drop ~(1-1/K) of the MACs in split
# layers -> the semantic model computes ~10% less than the full net.
SEMANTIC_COMPUTE_FRAC = 0.85
# Compression (the baseline) trades accuracy for MEMORY; on RPi-class fp32
# SIMD the low-footprint models gain no wall-clock (Gunasekaran et al.).
COMPRESSED_SPEEDUP = 1.0
COMPRESSED_RAM_FRAC = 0.30


@dataclass
class Container:
    cid: int
    workload: Workload
    frag_index: int
    kind: int                       # LAYER / SEMANTIC / COMPRESSED
    work: float                     # seconds at speed 1.0, exclusive core
    ram_mb: float
    host: Optional[int] = None
    deps: tuple = ()
    progress: float = 0.0
    ready_at: float = 0.0           # dep + transfer gate
    done: bool = False
    done_at: float = 0.0

    def runnable(self, t: float, siblings) -> bool:
        return (not self.done and self.host is not None
                and t >= self.ready_at
                and all(siblings[d].done for d in self.deps))


def fragment_plan(prof, decision: int) -> List[tuple]:
    """Per-decision fragment specs: [(work_s, ram_mb, dep_frag_indices)].

    The single source of the split physics (§III-A), shared by the legacy
    ``Simulator`` and the scaled ``repro_torch.engine.SimBackend``.
    """
    K = prof.n_fragments
    if decision == LAYER:
        work = prof.base_latency_s / K
        ram = prof.params_mb / K + RUNTIME_OVERHEAD_MB
        return [(work, ram, (i - 1,) if i else ()) for i in range(K)]
    if decision == SEMANTIC:
        work = prof.base_latency_s / K * SEMANTIC_COMPUTE_FRAC
        ram = prof.params_mb / K + RUNTIME_OVERHEAD_MB
        return [(work, ram, ()) for _ in range(K)]
    work = prof.base_latency_s * COMPRESSED_SPEEDUP
    ram = prof.params_mb * COMPRESSED_RAM_FRAC + RUNTIME_OVERHEAD_MB
    return [(work, ram, ())]


def build_containers(w: Workload, decision: int, next_cid) -> List[Container]:
    prof = WORKLOADS[w.app]
    if decision == LAYER:
        w.accuracy = prof.accuracy
    elif decision == SEMANTIC:
        w.accuracy = prof.accuracy - prof.sem_accuracy_drop
    else:
        w.accuracy = prof.accuracy - prof.comp_accuracy_drop
    return [Container(next_cid(), w, i, decision, work, ram, deps=deps)
            for i, (work, ram, deps) in enumerate(
                fragment_plan(prof, decision))]


class Simulator:
    def __init__(self, scheduler, *, n_hosts: int = 10, dt: float = 0.1,
                 rate: float = 0.6, seed: int = 0, sla_range=(0.5, 3.0)):
        self.hosts = make_testbed(n_hosts, seed)
        self.network = Network(n_hosts, seed=seed + 1)
        self.gen = WorkloadGenerator(rate=rate, seed=seed + 2,
                                     sla_range=sla_range)
        self.scheduler = scheduler
        self.dt = dt
        self.t = 0.0
        self._cid = 0
        self.unplaced: List[Container] = []
        self.by_workload: Dict[int, List[Container]] = {}
        self.completed: List[Workload] = []
        self.energy_wh = 0.0
        self.sched_time_s = 0.0
        self.n_decisions = 0

    def _next_cid(self):
        c = self._cid
        self._cid += 1
        return c

    # ------------------------------------------------------------- dynamics
    def step(self):
        self.network.resample()
        t0 = time.perf_counter()
        for w in self.gen.arrivals(self.t):
            decision = self.scheduler.decide(w)
            w.decision = decision
            self.n_decisions += 1
            conts = build_containers(w, decision, self._next_cid)
            self.by_workload[w.wid] = conts
            self.unplaced.extend(conts)
        self._try_place()
        self.sched_time_s += time.perf_counter() - t0

        # advance compute: only runnable containers consume CPU
        for h in self.hosts:
            if not h.containers:
                continue
            sib = self.by_workload
            active = [c for c in h.containers
                      if c.runnable(self.t, sib[c.workload.wid])]
            if not active:
                continue
            share = min(1.0, 4.0 / len(active)) * h.speed
            n_run = len(active)
            for c in active:
                c.progress += self.dt * share
                if c.progress >= c.work:
                    # sub-interval completion time
                    overshoot = (c.progress - c.work) / share
                    self._complete(c, self.t + self.dt - overshoot)
            h._n_running = n_run

        for h in self.hosts:
            util = min(1.0, getattr(h, "_n_running", 0) / 4.0)
            h._n_running = 0
            power = h.power_idle_w + (h.power_peak_w - h.power_idle_w) * util
            self.energy_wh += power * self.dt / 3600.0
        self.t += self.dt

    def _try_place(self):
        still = []
        for c in self.unplaced:
            host = self.scheduler.place(c, self.hosts)
            if host is None or not self.hosts[host].fits(c.ram_mb):
                still.append(c)
                continue
            h = self.hosts[host]
            c.host = host
            h.ram_used_mb += c.ram_mb
            h.containers.append(c)
            if c.workload.start is None:
                c.workload.start = self.t
            # transfer gate for dependencies that completed before this
            # container was placed (late placement under RAM pressure)
            sibs = self.by_workload[c.workload.wid]
            for d in c.deps:
                dep = sibs[d]
                if dep.done:
                    c.ready_at = max(c.ready_at, dep.done_at +
                                     self.network.transfer_time(
                                         dep.host, host, ACTIVATION_MB))
        self.unplaced = still

    def _complete(self, c: Container, t_done: float):
        c.done = True
        c.done_at = t_done
        h = self.hosts[c.host]
        h.containers.remove(c)
        h.ram_used_mb -= c.ram_mb
        conts = self.by_workload[c.workload.wid]
        # gate successors with the activation transfer time
        for succ in conts:
            if not succ.done and c.frag_index in succ.deps                     and succ.host is not None:
                succ.ready_at = max(succ.ready_at, t_done +
                                    self.network.transfer_time(
                                        c.host, succ.host, ACTIVATION_MB))
        if all(x.done for x in conts):
            w = c.workload
            finish = t_done
            if c.kind == SEMANTIC and len(conts) > 1:
                finish += max(self.network.transfer_time(
                    x.host, conts[0].host, ACTIVATION_MB / len(conts))
                    for x in conts)
            w.finish = finish
            self.completed.append(w)
            self.scheduler.observe(w)

    # -------------------------------------------------------------- metrics
    def run(self, n_intervals: int):
        for _ in range(n_intervals):
            self.step()
        return self.metrics()

    def metrics(self):
        done = list(self.completed)
        if not done:
            return {}
        rts = np.array([w.response_time for w in done])
        slas = np.array([w.sla for w in done])
        accs = np.array([w.accuracy for w in done])
        # the reference tests each float64 response time against its SLA
        # before its float32 cast (``workload_reward`` on host floats), so
        # a time within a float32 ulp of the SLA keeps its verdict
        reward = float(np.mean(met_reward(rts <= slas, accs)))
        return {
            "completed": len(done),
            "energy_wh": round(self.energy_wh, 2),
            "sched_time_s": round(self.sched_time_s, 4),
            "sched_ms_per_decision": round(
                1e3 * self.sched_time_s / max(self.n_decisions, 1), 3),
            "sla_violation": round(float(np.mean(rts > slas)), 4),
            "accuracy": round(float(np.mean(accs)), 4),
            "reward": round(reward, 4),
            "mean_response_s": round(float(np.mean(rts)), 3),
            "decisions_semantic_frac": round(float(np.mean(
                [w.decision == SEMANTIC for w in done])), 3),
        }
