"""Cache- and load-aware fleet routing for the placement layer, the port's
copy of ``repro.engine.routing`` (pure numpy, its results equal the
reference's bit for bit).

The flexlb-style cache-status sync, in three pieces:

``CacheStatusBoard``
    The placement layer's view of every decode worker's cache.  Each
    replica's ``PrefixIndex`` streams *delta* updates — ``("add", h)`` when a
    block chain-hash is registered, ``("drop", h)`` when it is reclaimed
    (retire / preempt / evict all funnel through the same two hooks) — so
    the board maintains a global ``block-hash -> {replica: refcount}`` index
    without ever snapshotting an index.  Replicas also advertise scalar load
    (queue depth, free-block headroom) on the same board.

``PrefixAwareRouter``
    A placement policy (the ``place(fragment, hosts)`` surface every
    ``Policy`` delegates to) that scores each replica by

        score = w_ovl * overlap_frac + w_free * free_frac
                - w_load * load_norm * urgency

    where ``overlap_frac`` is the cached-prefix overlap (longest contiguous
    head of the request's block-hash chain held by the replica, as a
    fraction of its full chain), ``load_norm`` is queue depth normalized to
    the fleet max, and ``urgency = 1/(1+slack)`` makes SLA-tight requests
    weigh load over cache affinity.  The weight vector can be fixed or
    learned online by a UCB1 bandit over a candidate grid (the same
    equations as ``repro_torch.core.mab``), fed by ``Outcome.reward`` through the
    standard placement feedback path.

``RequestFragment``
    The fragment view handed to ``place`` — carries the request plus its
    precomputed block-hash chain and SLA slack.  Satisfies the same surface
    (``ram_mb``) the baseline placements expect, so random / least-loaded /
    prefix-aware all route the identical fragment stream.

The scoring path is ``route_arrays`` — pure numpy over per-replica arrays —
so ``SimBackend`` can call it vectorized at million-request scale while
``FleetBackend`` calls it through ``place`` over live replica views: one
routing code path, both backends.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np

from repro_torch.decode.paged_cache import chain_hashes
from repro_torch.engine.types import Request

#: default weight grid the UCB learner explores: (w_ovl, w_free, w_load)
#: spanning cache-affinity-heavy through load-balance-heavy tradeoffs
WEIGHT_GRID = (
    (1.0, 0.1, 0.2),   # affinity-first
    (1.0, 0.3, 0.6),   # balanced (default fixed weights)
    (0.6, 0.3, 1.0),   # load-first
    (1.0, 0.0, 0.0),   # pure cache affinity
    (0.0, 0.5, 1.0),   # cache-blind least-loaded
)


@dataclass
class RequestFragment:
    """One request as the routing layer sees it."""
    request: Request
    hashes: tuple = ()          # block-hash chain of the prompt
    slack_s: float = 1.0        # sla - time already waited
    ram_mb: float = 0.0         # baseline-placement surface (always fits)

    @property
    def wid(self) -> int:
        return self.request.rid

    @classmethod
    def of(cls, request: Request, block_size: int, now: float
           ) -> "RequestFragment":
        toks = request.tokens if request.tokens is not None else ()
        waited = now - (request.arrival_s or now)
        return cls(request=request,
                   hashes=tuple(chain_hashes(toks, block_size)),
                   slack_s=request.sla_s - waited)


class CacheStatusBoard:
    """Global block-hash -> replica index fed by incremental deltas."""

    def __init__(self, n_replicas: int):
        self.n_replicas = n_replicas
        # chain hash -> {replica id -> refcount}.  Refcounted because one
        # replica can hold the same hash in several indexes (its prefill
        # and decode schedulers each run a PrefixIndex under disagg).
        self._owners: Dict[int, Dict[int, int]] = {}
        self.queue_depth = np.zeros(n_replicas, np.int64)
        self.free_blocks = np.zeros(n_replicas, np.int64)
        self.total_blocks = np.ones(n_replicas, np.int64)
        self.deltas = 0          # add/drop events consumed (sync traffic)

    # ------------------------------------------------------------- sync in
    def attach(self, replica: int, index) -> None:
        """Subscribe to one ``PrefixIndex``'s delta stream."""
        index.on_delta = lambda op, h, _r=replica: self.apply(_r, op, h)

    def apply(self, replica: int, op: str, h: int) -> None:
        self.deltas += 1
        owners = self._owners.setdefault(h, {})
        if op == "add":
            owners[replica] = owners.get(replica, 0) + 1
        else:
            n = owners.get(replica, 0) - 1
            if n > 0:
                owners[replica] = n
            else:
                owners.pop(replica, None)
                if not owners:
                    del self._owners[h]

    def update_load(self, replica: int, queue_depth: int,
                    free_blocks: int, total_blocks: int) -> None:
        self.queue_depth[replica] = queue_depth
        self.free_blocks[replica] = free_blocks
        self.total_blocks[replica] = max(total_blocks, 1)

    # ------------------------------------------------------------ sync out
    def match_hashes(self, hashes: Sequence[int]) -> np.ndarray:
        """Per-replica cached-prefix overlap: length of the longest
        *contiguous head* of ``hashes`` each replica holds (a replica that
        evicted block j cannot serve block j+1 from cache even if the hash
        survives elsewhere in its index)."""
        counts = np.zeros(self.n_replicas, np.int64)
        for j, h in enumerate(hashes):
            owners = self._owners.get(h)
            if not owners:
                if not (counts == j).any():
                    break
                continue
            for r in owners:
                if counts[r] == j:
                    counts[r] = j + 1
        return counts

    @property
    def free_frac(self) -> np.ndarray:
        return self.free_blocks / self.total_blocks

    def holders(self, h: int) -> Dict[int, int]:
        return dict(self._owners.get(h, {}))

    def __len__(self) -> int:
        return len(self._owners)

    def stats(self) -> dict:
        return {"sync_deltas": self.deltas, "tracked_hashes": len(self)}


class PrefixAwareRouter:
    """Prefix- and load-aware placement over a replica fleet.

    ``place(fragment, hosts)`` is the standard placement surface (hosts are
    ``ReplicaView``s); ``route_arrays`` is the identical scoring math over
    raw numpy arrays for the vectorized sim path.  With ``learn=True`` a
    UCB1 bandit picks the weight vector per placement from ``grid`` and is
    rewarded through ``on_complete`` (the engine's placement feedback path).
    """

    def __init__(self, board: Optional[CacheStatusBoard] = None, *,
                 weights=(1.0, 0.3, 0.6), learn: bool = False,
                 grid=WEIGHT_GRID, ucb_c: float = 0.3):
        self.board = board
        self.weights = tuple(weights)
        self.learn = learn
        self.grid = [tuple(w) for w in grid]
        self.ucb_c = ucb_c
        self._counts = np.zeros(len(self.grid), np.int64)
        self._values = np.zeros(len(self.grid), np.float64)
        self._t = 0
        self._pending_arm: Dict[int, int] = {}   # wid -> grid arm
        # telemetry
        self.routed = 0
        self.overlap_sum = 0.0       # expected overlap_frac of chosen hosts

    # -------------------------------------------------------- weight bandit
    def _select_weights(self, wid: Optional[int]):
        if not self.learn:
            return self.weights
        # UCB1 (same form as core.mab.ucb_select, host-side numpy):
        # untried arms first, then value + c*sqrt(ln t / n)
        untried = np.nonzero(self._counts == 0)[0]
        if untried.size:
            arm = int(untried[0])
        else:
            bonus = self.ucb_c * np.sqrt(
                math.log(max(self._t, 1)) / self._counts)
            arm = int(np.argmax(self._values + bonus))
        self._t += 1
        if wid is not None:
            self._pending_arm[wid] = arm
        return self.grid[arm]

    def on_complete(self, outcome) -> None:
        arm = self._pending_arm.pop(outcome.wid, None)
        if arm is None:
            return
        # incremental mean (core.mab.ucb_update)
        self._counts[arm] += 1
        self._values[arm] += (outcome.reward - self._values[arm]) \
            / self._counts[arm]

    # --------------------------------------------------------- scoring path
    def route_arrays(self, *, overlap_frac, queue_depth, free_frac,
                     slack_s: float, feasible=None,
                     wid: Optional[int] = None) -> Optional[int]:
        """THE routing code path — shared verbatim by both backends.

        All array args are per-replica; ``slack_s`` is the request's scalar
        SLA slack.  Returns the chosen replica index (lowest index wins
        ties, so routing is deterministic for a fixed fleet state)."""
        w_ovl, w_free, w_load = self._select_weights(wid)
        overlap_frac = np.asarray(overlap_frac, np.float64)
        queue_depth = np.asarray(queue_depth, np.float64)
        free_frac = np.asarray(free_frac, np.float64)
        load_norm = queue_depth / max(float(queue_depth.max()), 1.0)
        urgency = 1.0 / (1.0 + max(float(slack_s), 0.0))
        score = (w_ovl * overlap_frac + w_free * free_frac
                 - w_load * load_norm * urgency)
        if feasible is not None:
            feasible = np.asarray(feasible, bool)
            if not feasible.any():
                if wid is not None:
                    self._pending_arm.pop(wid, None)
                return None
            score = np.where(feasible, score, -np.inf)
        idx = int(np.argmax(score))          # first max -> deterministic
        self.routed += 1
        self.overlap_sum += float(overlap_frac[idx])
        return idx

    def place(self, fragment, hosts) -> Optional[int]:
        """Standard placement surface over live ``ReplicaView`` hosts."""
        board = self.board
        hashes = getattr(fragment, "hashes", ())
        if board is not None and hashes:
            counts = board.match_hashes(hashes)
            overlap = np.array([counts[h.rid] for h in hosts], np.float64) \
                / len(hashes)
        else:
            overlap = np.zeros(len(hosts))
        ram = getattr(fragment, "ram_mb", 0.0)
        idx = self.route_arrays(
            overlap_frac=overlap,
            queue_depth=np.array([h.n_active for h in hosts], np.float64),
            free_frac=np.array([h.free_frac for h in hosts], np.float64),
            slack_s=getattr(fragment, "slack_s", 1.0),
            feasible=np.array([h.fits(ram) for h in hosts], bool),
            wid=getattr(fragment, "wid", None))
        return None if idx is None else hosts[idx].hid

    def stats(self) -> dict:
        out = {
            "routed": self.routed,
            "route_expected_overlap": round(
                self.overlap_sum / max(self.routed, 1), 4),
        }
        if self.learn and self._counts.sum():
            best = int(np.argmax(self._values))
            out["route_weights"] = list(self.grid[best])
        if self.board is not None:
            out.update(self.board.stats())
        return out
