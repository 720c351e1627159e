"""SimBackend — the discrete-interval edge testbed as an ExecutionBackend, the
port's copy of ``repro.engine.sim_backend`` (host numpy; no device work).

Same physics as ``repro_torch.sim.simulator`` (shared-CPU hosts, activation
transfers, Gaussian network noise, linear power models) but scaled to
thousands of hosts: the per-interval host/CPU-share dynamics are vectorized
numpy over structure-of-arrays fragment state, host state lives in flat
arrays, and the network samples link noise on demand instead of materializing
an n x n matrix every interval.

The activation-transfer gate is applied both when a dependency completes
(successors already placed) and at placement time (successors placed *after*
the dependency finished) — the corrected semantics of
``repro_torch.sim.simulator._try_place``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from repro_torch.configs.paper_workloads import WORKLOADS
from repro_torch.engine.types import (APPS, SEMANTIC, Outcome, Request,
                                      accuracy_for)
from repro_torch.faults import HOST_CRASH, HOST_STALL, FaultInjector
from repro_torch.obs import Histogram, get_tracer
from repro_torch.sim.simulator import ACTIVATION_MB, fragment_plan

CORES = 4.0

#: trace track for the vectorized testbed's per-tick phases
SIM_TRACK = ("sim", "testbed")


class ScaledNetwork:
    """On-demand link model: latency/bandwidth noise is sampled per transfer
    (the netlimiter mobility emulation) — O(1) per query at any host count."""

    def __init__(self, n_hosts: int, *, base_latency_s: float = 0.010,
                 latency_sigma: float = 0.5, bandwidth_mbps: float = 100.0,
                 bandwidth_sigma: float = 0.2, seed: int = 0):
        self.n = n_hosts
        self.base_latency = base_latency_s
        self.latency_sigma = latency_sigma
        self.bandwidth_mbps = bandwidth_mbps
        self.bandwidth_sigma = bandwidth_sigma
        self.rng = np.random.default_rng(seed)

    def transfer_time(self, src: int, dst: int, mb: float) -> float:
        if src == dst:
            return 0.0
        lat = self.base_latency * abs(
            1.0 + self.latency_sigma * self.rng.standard_normal())
        bw = self.bandwidth_mbps * float(np.clip(
            1.0 + self.bandwidth_sigma * self.rng.standard_normal(), 0.3, 2.0))
        return lat + mb * 8.0 / bw


@dataclass
class Fragment:
    """Per-fragment metadata handed to placement policies (the 'container'
    view: ``.work``, ``.ram_mb``, ``.workload.wid``)."""
    fid: int
    request: Request
    frag_index: int
    kind: int
    work: float
    ram_mb: float
    deps: tuple = ()               # fids of dependencies

    @property
    def workload(self) -> Request:
        return self.request


class _HostView:
    """Lightweight live view over the backend's host arrays — satisfies the
    placement-policy host surface (hid / ram / speed / n_active / fits)."""

    __slots__ = ("_b", "hid")

    def __init__(self, backend: "SimBackend", hid: int):
        self._b = backend
        self.hid = hid

    @property
    def ram_mb(self) -> float:
        return float(self._b.host_ram_mb[self.hid])

    @property
    def ram_used_mb(self) -> float:
        return float(self._b.host_ram_used[self.hid])

    @property
    def speed(self) -> float:
        return float(self._b.host_speed[self.hid])

    @property
    def n_active(self) -> int:
        return int(self._b.host_n_placed[self.hid])

    def fits(self, ram_mb: float) -> bool:
        b = self._b
        if b.host_down_until[self.hid] > b.t:
            return False                       # crashed-out host
        return b.host_ram_used[self.hid] + ram_mb <= b.host_ram_mb[self.hid]


class SimBackend:
    """Vectorized discrete-event execution backend over an edge testbed."""

    def __init__(self, *, n_hosts: int = 10, dt: float = 0.1, seed: int = 0,
                 network_kw: Optional[dict] = None, faults=None,
                 host_cache_slots: int = 8):
        rng = np.random.default_rng(seed)
        self.n_hosts = n_hosts
        self.dt = dt
        self.t = 0.0
        # host arrays (the RPi-class testbed scaled out: alternating 4/8 GB,
        # +-20% speed heterogeneity, 2.7-8.0 W linear power)
        self.host_ram_mb = np.where(np.arange(n_hosts) % 2 == 0,
                                    4096.0, 8192.0)
        self.host_speed = rng.uniform(0.8, 1.2, n_hosts)
        self.host_ram_used = np.zeros(n_hosts)
        self.host_n_placed = np.zeros(n_hosts, np.int64)
        self.power_idle_w = 2.7
        self.power_peak_w = 8.0
        self.network = ScaledNetwork(n_hosts, seed=seed + 1,
                                     **(network_kw or {}))
        self.hosts = [_HostView(self, h) for h in range(n_hosts)]
        # fragment structure-of-arrays (capacity-doubling)
        cap = 256
        self._n = 0
        self.f_work = np.zeros(cap)
        self.f_progress = np.zeros(cap)
        self.f_ready_at = np.zeros(cap)
        self.f_ram = np.zeros(cap)
        self.f_host = np.full(cap, -1, np.int64)
        self.f_dep_left = np.zeros(cap, np.int64)
        self.f_done = np.zeros(cap, bool)
        self.f_done_at = np.zeros(cap)
        self.f_prefix_done = np.zeros(cap, bool)   # hit model applied once
        # python-side metadata (in-flight only; completed entries are freed)
        self.fragments: Dict[int, Fragment] = {}
        self._live_fids: Dict[int, None] = {}  # in-flight fids, fid order
        self._succs: Dict[int, List[int]] = {}
        self._frags_of: Dict[int, List[int]] = {}      # rid -> fids
        self._open: Dict[int, int] = {}                # rid -> undone count
        self._requests: Dict[int, Request] = {}
        self._started: set = set()
        self.unplaced: List[int] = []
        # per-host prefix-hit model: each host keeps an MRU cache of the
        # last ``host_cache_slots`` prefix FAMILIES it served (the sim
        # analogue of a decode worker's PrefixIndex).  A request landing on
        # a host that still caches its family saves ``prefix_frac`` of its
        # head fragment's work — so the same prefix-aware routing policy
        # that steers the real fleet pays off here too, at any host count.
        self.host_cache_slots = host_cache_slots
        self.host_family = np.full((n_hosts, host_cache_slots), -1, np.int64)
        self.prefix_hits = 0
        self.prefix_queries = 0
        # metrics
        self.energy_wh = 0.0
        self.place_time_s = 0.0
        # fault plane (repro_torch.faults): host churn + stragglers on the sim
        # clock.  A crashed host displaces its in-flight fragments (progress
        # lost, re-placed on surviving hosts) and is unplaceable until
        # ``host_down_until``; a stalled host's effective speed multiplies
        # by ``host_stall_factor`` until ``host_stall_until``.
        self._injector = FaultInjector(faults) if faults is not None else None
        self.host_down_until = np.zeros(n_hosts)
        self.host_stall_until = np.zeros(n_hosts)
        self.host_stall_factor = np.ones(n_hosts)
        self.re_executions = 0            # crash-displaced fragments
        self.recovered = 0                # fault-stamped requests re-placed
        self.recovery_latency = Histogram()

    # ------------------------------------------------------------- lifecycle
    @property
    def now(self) -> float:
        return self.t

    def pending(self) -> int:
        return len(self._open)

    def _grow(self, need: int):
        cap = len(self.f_work)
        if need <= cap:
            return
        new = max(2 * cap, need)
        for name in ("f_work", "f_progress", "f_ready_at", "f_ram",
                     "f_host", "f_dep_left", "f_done", "f_done_at",
                     "f_prefix_done"):
            old = getattr(self, name)
            arr = np.zeros(new, old.dtype)
            if name == "f_host":
                arr[:] = -1
            arr[:cap] = old
            setattr(self, name, arr)

    def _add_fragment(self, frag: Fragment) -> int:
        fid = frag.fid
        self._grow(fid + 1)
        self._n = fid + 1
        self.f_work[fid] = frag.work
        self.f_ram[fid] = frag.ram_mb
        self.f_dep_left[fid] = len(frag.deps)
        for d in frag.deps:
            self._succs.setdefault(d, []).append(fid)
        self.fragments[fid] = frag
        self._live_fids[fid] = None
        return fid

    def submit(self, req: Request) -> None:
        """Build the fragment DAG for the request's split decision (shared
        split physics: ``repro_torch.sim.simulator.fragment_plan``)."""
        prof = WORKLOADS[APPS[req.app_id]]
        base = self._n
        decision = req.decision
        req.accuracy = accuracy_for(req.app_id, decision)
        frags = [Fragment(base + i, req, i, decision, work, ram,
                          deps=tuple(base + d for d in deps))
                 for i, (work, ram, deps) in enumerate(
                     fragment_plan(prof, decision))]
        fids = [self._add_fragment(f) for f in frags]
        self._frags_of[req.rid] = fids
        self._open[req.rid] = len(fids)
        self._requests[req.rid] = req
        self.unplaced.extend(fids)
        get_tracer().instant("place", track=SIM_TRACK, req=req.rid,
                             frags=len(fids))

    # ----------------------------------------------------------- fault plane
    def _apply_faults(self) -> None:
        """Fire due faults against the sim clock (vectorized displacement:
        one pass over live fragments per crash)."""
        tr = get_tracer()
        for f in self._injector.advance(self.t):
            if f.kind not in (HOST_CRASH, HOST_STALL):
                continue                      # serving-layer kinds: not ours
            h = f.target % self.n_hosts if f.target >= 0 else 0
            if f.kind == HOST_STALL:
                self.host_stall_until[h] = self.t + f.duration
                self.host_stall_factor[h] = f.magnitude
                tr.instant("fault_injected", track=SIM_TRACK,
                           kind=HOST_STALL, host=h, factor=f.magnitude)
                continue
            self.host_down_until[h] = self.t + f.duration
            self._crash_host(h, tr)

    def _crash_host(self, h: int, tr) -> None:
        """Churn host ``h`` out: every in-flight fragment on it loses its
        progress and goes back to the unplaced pool (mobile-edge mobility —
        the work re-executes on surviving hosts)."""
        displaced = 0
        for fid in list(self._live_fids):
            if int(self.f_host[fid]) != h:
                continue
            frag = self.fragments[fid]
            self.f_host[fid] = -1
            self.f_progress[fid] = 0.0
            self.f_ready_at[fid] = 0.0
            self.host_ram_used[h] -= frag.ram_mb
            self.host_n_placed[h] -= 1
            req = frag.request
            if req.fault_t <= 0.0:
                req.fault_t = self.t
            self.unplaced.append(fid)
            displaced += 1
        self.re_executions += displaced
        tr.instant("fault_injected", track=SIM_TRACK, kind=HOST_CRASH,
                   host=h, displaced=displaced)

    # ---------------------------------------------------- prefix-hit model
    def _prefix_touch(self, h: int, fam: int) -> bool:
        """MRU-touch family ``fam`` in host ``h``'s cache; True on hit."""
        row = self.host_family[h]
        pos = np.nonzero(row == fam)[0]
        hit = pos.size > 0
        # move-to-front (evicting the LRU slot on a miss)
        keep = int(pos[0]) if hit else len(row) - 1
        row[1:keep + 1] = row[:keep]
        row[0] = fam
        return hit

    # ------------------------------------------------------------- placement
    def _place(self, policy) -> None:
        # vectorized fast-paths: a routing placement exposing the shared
        # ``route_arrays`` scoring (PrefixAwareRouter — THE same code path
        # the real fleet runs) beats the plain ``place_arrays`` fast path
        # (e.g. LeastLoadedPlacement); either skips the per-host views
        placement = getattr(policy, "placement", None)
        route = getattr(placement, "route_arrays", None)
        fast = getattr(placement, "place_arrays", None)
        tr = get_tracer()
        # crashed hosts advertise no capacity until their window closes
        host_up = self.host_down_until <= self.t
        still = []
        for fid in self.unplaced:
            frag = self.fragments[fid]
            req = frag.request
            if route is not None:
                free = self.host_ram_mb - self.host_ram_used
                fam = req.prefix_family
                overlap = (self.host_family == fam).any(axis=1) \
                    * req.prefix_frac if fam >= 0 \
                    else np.zeros(self.n_hosts)
                arrival = req.arrival_s if req.arrival_s is not None \
                    else self.t
                h = route(overlap_frac=overlap,
                          queue_depth=self.host_n_placed,
                          free_frac=free / self.host_ram_mb,
                          slack_s=req.sla_s - (self.t - arrival),
                          feasible=host_up & (free >= frag.ram_mb),
                          wid=req.rid)
            elif fast is not None:
                free = np.where(host_up,
                                self.host_ram_mb - self.host_ram_used, -1.0)
                h = fast(frag.ram_mb, free, self.host_n_placed,
                         self.host_speed)
            else:
                h = policy.place(frag, self.hosts)
            if h is None or not host_up[h] \
                    or self.host_ram_used[h] + frag.ram_mb \
                    > self.host_ram_mb[h]:
                still.append(fid)
                continue
            self.f_host[fid] = h
            self.host_ram_used[h] += frag.ram_mb
            self.host_n_placed[h] += 1
            if frag.frag_index == 0 and req.prefix_family >= 0 \
                    and not self.f_prefix_done[fid]:
                # the head fragment carries the prompt: a warm host saves
                # prefix_frac of its work.  Applied once per fragment —
                # crash displacement re-places but never re-discounts.
                self.f_prefix_done[fid] = True
                self.prefix_queries += 1
                if self._prefix_touch(h, req.prefix_family):
                    self.prefix_hits += 1
                    self.f_work[fid] *= (1.0 - req.prefix_frac)
            if req.fault_t > 0.0:
                # the crash-displaced request is running again: close the
                # recovery arc at its first post-fault placement
                self.recovery_latency.observe(max(self.t - req.fault_t, 0.0))
                self.recovered += 1
                req.fault_t = 0.0
                tr.instant("recovery", track=SIM_TRACK, req=req.rid)
            if req.rid not in self._started:
                self._started.add(req.rid)
                if req.arrival_s is not None:
                    req.queue_wait_s = self.t - req.arrival_s
            # transfer gate for dependencies that finished before placement
            for d in frag.deps:
                if self.f_done[d]:
                    self.f_ready_at[fid] = max(
                        self.f_ready_at[fid],
                        self.f_done_at[d] + self.network.transfer_time(
                            int(self.f_host[d]), h, ACTIVATION_MB))
        self.unplaced = still

    # -------------------------------------------------------------- dynamics
    def step(self, policy) -> List[Outcome]:
        tr = get_tracer()
        if self._injector is not None:
            self._apply_faults()
        t0 = time.perf_counter()
        n_waiting = len(self.unplaced)
        with tr.span("place_frags", track=SIM_TRACK, waiting=n_waiting) as sp:
            self._place(policy)
            sp.set(placed=n_waiting - len(self.unplaced))
        self.place_time_s += time.perf_counter() - t0

        with tr.span("sim_tick", track=SIM_TRACK, t=round(self.t, 3),
                     live=len(self._live_fids)):
            outcomes = self._tick()
        for o in outcomes:
            tr.instant("retire", track=SIM_TRACK, req=o.request.rid,
                       violated=bool(o.violated))
        return outcomes

    def _tick(self) -> List[Outcome]:
        """One dt of the vectorized host/CPU-share dynamics."""
        outcomes: List[Outcome] = []
        active_counts = np.zeros(self.n_hosts, np.int64)
        if self._live_fids:
            # scan only in-flight fragments (fid order, so completion
            # processing stays deterministic) — step cost tracks live work,
            # not total history
            live = np.fromiter(self._live_fids, np.int64,
                               len(self._live_fids))
            host = self.f_host[live]
            runnable = ((host >= 0) & ~self.f_done[live]
                        & (self.f_dep_left[live] == 0)
                        & (self.f_ready_at[live] <= self.t))
            idx = live[runnable]
            if idx.size:
                hr = self.f_host[idx]
                active_counts = np.bincount(hr, minlength=self.n_hosts)
                share = np.minimum(1.0, CORES / active_counts[hr]) \
                    * self.host_speed[hr]
                # injected stragglers: stalled hosts run at a fraction of
                # their speed until the window closes
                share = share * np.where(
                    self.host_stall_until[hr] > self.t,
                    self.host_stall_factor[hr], 1.0)
                self.f_progress[idx] += self.dt * share
                fin = self.f_progress[idx] >= self.f_work[idx]
                if fin.any():
                    fin_idx = idx[fin]
                    overshoot = (self.f_progress[fin_idx]
                                 - self.f_work[fin_idx]) / share[fin]
                    done_at = self.t + self.dt - overshoot
                    for fid, td in zip(fin_idx.tolist(), done_at.tolist()):
                        out = self._complete(int(fid), float(td))
                        if out is not None:
                            outcomes.append(out)

        util = np.minimum(1.0, active_counts / CORES)
        power = self.power_idle_w \
            + (self.power_peak_w - self.power_idle_w) * util
        self.energy_wh += float(power.sum()) * self.dt / 3600.0
        self.t += self.dt
        return outcomes

    def _complete(self, fid: int, t_done: float) -> Optional[Outcome]:
        self.f_done[fid] = True
        self.f_done_at[fid] = t_done
        del self._live_fids[fid]
        h = int(self.f_host[fid])
        frag = self.fragments.pop(fid)
        self.host_ram_used[h] -= frag.ram_mb
        self.host_n_placed[h] -= 1
        # gate already-placed successors with the activation transfer
        for s in self._succs.pop(fid, ()):
            self.f_dep_left[s] -= 1
            hs = int(self.f_host[s])
            if hs >= 0:
                self.f_ready_at[s] = max(
                    float(self.f_ready_at[s]),
                    t_done + self.network.transfer_time(h, hs, ACTIVATION_MB))
        req = frag.request
        self._open[req.rid] -= 1
        if self._open[req.rid]:
            return None
        del self._open[req.rid]
        fids = self._frags_of.pop(req.rid)
        del self._requests[req.rid]
        self._started.discard(req.rid)
        finish = t_done
        if frag.kind == SEMANTIC and len(fids) > 1:
            first = int(self.f_host[fids[0]])
            finish += max(self.network.transfer_time(
                int(self.f_host[x]), first, ACTIVATION_MB / len(fids))
                for x in fids)
        arrival = req.arrival_s if req.arrival_s is not None else 0.0
        req.latency_s = finish - arrival
        return Outcome(request=req, decision=frag.kind,
                       latency_s=req.latency_s,
                       queue_wait_s=req.queue_wait_s,
                       accuracy=req.accuracy, finish_s=finish)

    # --------------------------------------------------------------- metrics
    def extra_metrics(self) -> dict:
        m = {
            "energy_wh": round(self.energy_wh, 2),
            "n_hosts": self.n_hosts,
            "place_time_s": self.place_time_s,
        }
        if self.prefix_queries:
            m["prefix_hit_tokens"] = self.prefix_hits
            m["prefix_query_tokens"] = self.prefix_queries
            m["prefix_hit_rate"] = round(
                self.prefix_hits / self.prefix_queries, 4)
        if self._injector is not None:
            m.update(self._injector.stats())
            m["re_executions"] = self.re_executions
            m["recovered"] = self.recovered
            m["hosts_down"] = int((self.host_down_until > self.t).sum())
            if self.recovery_latency.n:
                for q in (50, 95, 99):
                    m[f"recovery_latency_p{q}"] = round(
                        self.recovery_latency.percentile(q), 6)
        return m
