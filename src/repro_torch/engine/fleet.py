"""FleetBackend — N TorchBackend replicas behind one ExecutionBackend, the
port of ``repro.engine.fleet``.

The cluster-scale serving shape: every replica runs the full arm stack of a
``TorchBackend`` (colocated paged or disagg prefill/decode), and the fleet
routes each admitted request to ONE replica at step time through the
standard ``Policy.place`` surface.  What makes the routing cache-aware:

  * every replica scheduler's ``PrefixIndex`` streams add/drop deltas into
    a shared :class:`~repro_torch.engine.routing.CacheStatusBoard` (the
    incremental cache-status sync — no index snapshots ever cross);
  * before routing, each replica advertises queue depth and free-block
    headroom onto the same board;
  * ``policy.place(fragment, views)`` sees :class:`ReplicaView` hosts, so
    a :class:`~repro_torch.engine.routing.PrefixAwareRouter` scores
    cached-prefix overlap x load x SLA slack while the cache-blind
    baselines (random / least-loaded / round-robin) route the identical
    fragment stream.

The replicas sit on the backend's one device (``mesh`` shapes their arms'
runners, as ``TorchBackend``'s does).  They share one built-call
cache per arm and, with it, that arm's model (same seed, same weights, held
once; each bucket is built once fleet-wide), and one clock, so outcome
latencies are comparable across replicas.  Each replica keeps its own pools,
queues and fault injector.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List

import numpy as np

from repro_torch.engine.routing import CacheStatusBoard, RequestFragment
from repro_torch.engine.torch_backend import TorchBackend
from repro_torch.engine.types import Outcome, Request
from repro_torch.obs import Histogram, get_tracer, merge_stat_dicts


@dataclass
class ReplicaView:
    """One replica's routing-visible state (a ``place`` host)."""
    hid: int                 # host id returned by place()
    rid: int                 # board replica id (same numbering)
    n_active: int            # queue depth: queued + in-flight requests
    free_frac: float         # free-block headroom across the replica's pools
    ram_mb: float            # total KV blocks (baseline-placement surface)
    ram_used_mb: float       # occupied KV blocks

    def fits(self, ram_mb: float) -> bool:
        return True          # per-request capacity is validated at submit


class FleetBackend:
    """N-replica ``TorchBackend`` fleet with cache-status-synced routing."""

    def __init__(self, cfg, *, mesh=(1, 1), n_replicas: int = 4,
                 device="cuda", **backend_kw):
        if n_replicas < 1:
            raise ValueError("n_replicas must be >= 1")
        self.n_replicas = n_replicas
        self._t0 = time.perf_counter()
        self.board = CacheStatusBoard(n_replicas)
        self.jit_cache: Dict[int, dict] = {}
        self.replicas: List[TorchBackend] = []
        for i in range(n_replicas):
            rep = TorchBackend(cfg, mesh=mesh, jit_cache=self.jit_cache,
                               device=device, **backend_kw)
            rep._t0 = self._t0          # one fleet clock
            self.replicas.append(rep)
        self.block_size = self.replicas[0].block_size
        self._inbox: List[Request] = []
        self._wired: set = set()        # id(index) already on the board
        self._wire()
        self._last_placement = None
        # instrumentation
        self.place_time_s = 0.0
        self.routed_per_replica = np.zeros(n_replicas, np.int64)
        self.route_fallbacks = 0        # place() returned None

    # ------------------------------------------------------------ lifecycle
    @property
    def now(self) -> float:
        return time.perf_counter() - self._t0

    def submit(self, req: Request) -> None:
        """Buffer for step-time routing — the board is synced (loads
        refreshed, deltas drained) right before ``place`` runs."""
        self._inbox.append(req)

    def pending(self) -> int:
        return len(self._inbox) + sum(r.pending() for r in self.replicas)

    # ------------------------------------------------------------- sync
    def _wire(self) -> None:
        """Subscribe any newly built scheduler's PrefixIndex to the board
        (arms build lazily on first submit of their decision)."""
        for i, rep in enumerate(self.replicas):
            for s in rep._all_scheds():
                if id(s.index) not in self._wired:
                    self.board.attach(i, s.index)
                    self._wired.add(id(s.index))

    def _update_loads(self) -> None:
        for i, rep in enumerate(self.replicas):
            free = total = 0
            for s in rep._all_scheds():
                free += s.alloc.available_blocks
                total += s.alloc.num_blocks - 1
            self.board.update_load(i, rep.pending(), free, max(total, 1))

    def views(self) -> List[ReplicaView]:
        b = self.board
        return [ReplicaView(
            hid=i, rid=i,
            n_active=int(b.queue_depth[i]),
            free_frac=float(b.free_frac[i]),
            ram_mb=float(b.total_blocks[i]),
            ram_used_mb=float(b.total_blocks[i] - b.free_blocks[i]),
        ) for i in range(self.n_replicas)]

    # ------------------------------------------------------------- serving
    def _route(self, policy) -> None:
        if not self._inbox:
            return
        self._update_loads()
        views = self.views()
        tr = get_tracer()
        t0 = time.perf_counter()
        inbox, self._inbox = self._inbox, []
        for req in inbox:
            frag = RequestFragment.of(req, self.block_size, self.now)
            hid = policy.place(frag, views)
            if hid is None:
                hid = int(np.argmin([v.n_active for v in views]))
                self.route_fallbacks += 1
            self.replicas[hid].submit(req)
            self.routed_per_replica[hid] += 1
            # keep intra-wave routing load-aware: the chosen replica's
            # queue deepens before the next fragment scores it
            views[hid].n_active += 1
            self.board.queue_depth[hid] += 1
            tr.instant("route", req=req.rid, replica=hid)
        self.place_time_s += time.perf_counter() - t0

    def step(self, policy=None) -> List[Outcome]:
        if policy is not None:
            self._route(policy)
            self._last_placement = getattr(policy, "placement", None)
        # wire AFTER routing: submits build arms lazily, and a new arm's
        # index must be on the board before its first insert (in rep.step)
        self._wire()
        outs: List[Outcome] = []
        for rep in self.replicas:
            outs.extend(rep.step(policy))
        return outs

    # ------------------------------------------------------------- metrics
    def extra_metrics(self) -> dict:
        m: dict = {
            "n_replicas": self.n_replicas,
            "place_time_s": round(self.place_time_s, 6),
            "routed_per_replica": [int(n) for n in self.routed_per_replica],
        }
        if self.route_fallbacks:
            m["route_fallbacks"] = self.route_fallbacks
        m["batches"] = sum(r.batches for r in self.replicas)
        m["prefill_calls"] = sum(r.prefill_calls for r in self.replicas)
        m["decode_steps"] = sum(r.decode_steps for r in self.replicas)
        # one merged registry across every replica's schedulers: counters
        # sum fleet-wide and prefix_hit_rate recomputes token-weighted from
        # the merged counters — THE fleet hit-rate the router is chasing
        scheds = [s for r in self.replicas for s in r._all_scheds()]
        if scheds:
            m.update(merge_stat_dicts((s.stats() for s in scheds),
                                      kinds=type(scheds[0]).STAT_KINDS))
        stores = [st for r in self.replicas
                  for _, _, st in r._disagg.values()]
        if stores:
            m.update(merge_stat_dicts(s.stats() for s in stores))
            hid = m.get("overlap_hidden_s", 0.0)
            exp = m.get("overlap_exposed_s", 0.0)
            if hid + exp > 0:
                m["ship_overlap_frac"] = round(hid / (hid + exp), 4)
            ship = Histogram()
            for s in stores:
                ship.merge(s.ship_latency)
            if ship.n:
                for q in (50, 95, 99):
                    m[f"ship_latency_p{q}"] = round(ship.percentile(q), 6)
        ttfts = [t for r in self.replicas for t in r._ttfts]
        if ttfts:
            m["ttft_s"] = round(float(np.mean(ttfts)), 6)
        m.update(self.board.stats())
        if self._last_placement is not None and \
                hasattr(self._last_placement, "stats"):
            m.update(self._last_placement.stats())
        return m
