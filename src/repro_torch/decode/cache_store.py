"""Block-granular KV cache store: ship finished prefill blocks to decoders.

The disaggregated serving mode splits one arm into a *prefill* worker and a
*decode* worker (``role=`` on :class:`PagedArmScheduler`), so chunked
prefill waves never stall the decode loop.  A finished prompt's KV blocks
live in the prefill worker's pool and must be copied into the decode
worker's pool before its lane can join.  The ledger semantics are those of
``repro.decode.cache_store``:

  * :meth:`CacheStore.ship` drains the prefill worker's ship-ready lanes,
    allocates receiver blocks (receiver-side prefix hits map onto blocks
    that are already there and are **not** moved) and moves every block of
    the wave in ONE ``gather_blocks`` -> ``scatter_blocks`` pair, the wave
    width padded to a power of two with null-block entries.
  * :class:`RequestBlockBuffer` is the in-flight ledger: request id ->
    expected / arrived receiver blocks, a deadline and an attempt stamp.  A
    shipment whose blocks never all arrive times out, and the request
    requeues for a fresh prefill (which hits the prefill worker's prefix
    cache), backing off ``timeout_s * 2^attempt``.
  * :meth:`CacheStore.poll` seats completed arrivals into free decode
    lanes via ``admit_shipped``: the lane's block table now names the
    receiver's blocks.

Transfers are bit-exact: block payloads are gathered and scattered
verbatim, so an int8 pool ships its codes and per-slot scales untouched.

On one device the gather and the scatter are enqueued on the current CUDA
stream, after the decode call that ``dispatch_async`` enqueued: stream
order makes a scatter into blocks that a mid-flight evicted lane still
wrote safe.  When the two workers' pools live on different devices
(``fleet`` true: the reference's two-device ``fleet`` mesh) a wave is
:func:`ship_blocks` between them: the gather on the source, one copy a
pool leaf to the destination's device, and the scatter there, enqueued
after the decode worker's call in flight as on one device.
``ship_xdev_copies`` counts those copies (one a leaf a wave), where the
reference checks for a ``collective-permute`` in the ship's compiled
program.

On a process-group mesh each rank's two pools are its slices of the two
workers' pools, of one layout, and the block dim is split by no axis.
Rank 0 keeps the ledger and hands each wave's padded (source,
destination) block ids to ``relay`` before it ships; every other rank
ships the same ids between its own slices (:meth:`CacheStore.replay_ship`),
so a wave moves no pool bytes between ranks.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Set

import numpy as np
import torch

from repro_torch.decode.paged_cache import (NULL_BLOCK, _leaves,
                                            gather_blocks, scatter_blocks)
from repro_torch.decode.scheduler import Lane, PagedArmScheduler
from repro_torch.engine.types import next_pow2
from repro_torch.obs import Histogram, annotation, get_tracer


@dataclass
class Shipment:
    """One request's in-flight block transfer (ledger entry)."""
    lane: Lane
    dst_blocks: List[int]        # full receiver-side logical block table
    n_shared: int                # leading entries satisfied by a prefix hit
    expected: Set[int]           # destination ids awaiting arrival
    arrived: Set[int] = field(default_factory=set)
    deadline: float = 0.0
    opened: float = 0.0          # ship-wave clock stamp (latency origin)
    attempt: int = 0             # 0 = first ship, k = k-th retry

    @property
    def complete(self) -> bool:
        return self.expected <= self.arrived


class RequestBlockBuffer:
    """rid -> :class:`Shipment` ledger of in-flight block transfers.

    Host-side bookkeeping only.  ``mark`` records arrivals (a block outside
    the expected set is a protocol error), ``pop_ready`` drains complete
    shipments, ``pop_expired`` those whose deadline passed with blocks
    missing.  Shipments are attempt-stamped: re-opening a request after an
    expiry bumps ``attempt``, and a mark carrying a stale attempt is
    ignored (its receiver blocks were freed and may back the retry).  The
    attempt counter survives ``pop_expired`` (it drives the backoff) and
    clears on ``pop_ready``.
    """

    def __init__(self):
        self._pending: Dict[int, Shipment] = {}
        self._attempts: Dict[int, int] = {}   # rid -> last opened attempt
        self.stale_marks = 0

    def __len__(self) -> int:
        return len(self._pending)

    def peek_attempt(self, rid: int) -> int:
        """The attempt number the NEXT ``open`` for ``rid`` would get."""
        return self._attempts.get(rid, -1) + 1

    def clear_attempt(self, rid: int) -> None:
        self._attempts.pop(rid, None)

    def open(self, lane: Lane, dst_blocks: Sequence[int], n_shared: int,
             expected: Set[int], deadline: float,
             opened: float = 0.0) -> Shipment:
        rid = lane.req.rid
        if rid in self._pending:
            raise ValueError(f"shipment already open for request {rid}")
        if NULL_BLOCK in expected:
            raise ValueError("null block can never be a shipment target")
        att = self.peek_attempt(rid)
        self._attempts[rid] = att
        shp = Shipment(lane=lane, dst_blocks=list(dst_blocks),
                       n_shared=n_shared, expected=set(expected),
                       deadline=deadline, opened=opened, attempt=att)
        self._pending[rid] = shp
        return shp

    def mark(self, rid: int, block_ids: Sequence[int],
             attempt: Optional[int] = None) -> bool:
        """Record arrivals for ``rid``; False for marks that no longer
        apply (shipment gone, or ``attempt`` stale).  ``attempt`` None
        trusts the caller."""
        shp = self._pending.get(rid)
        if shp is None:
            return False                 # already expired and requeued
        if attempt is not None and attempt != shp.attempt:
            self.stale_marks += 1        # late arrival from a dead attempt
            return False
        extra = set(block_ids) - shp.expected
        if extra:
            raise ValueError(
                f"request {rid}: arrival of unexpected blocks {sorted(extra)}")
        shp.arrived.update(block_ids)
        return True

    def pop_ready(self) -> List[Shipment]:
        done = [rid for rid, s in self._pending.items() if s.complete]
        for rid in done:
            self._attempts.pop(rid, None)
        return [self._pending.pop(rid) for rid in done]

    def pop_expired(self, now: float) -> List[Shipment]:
        late = [rid for rid, s in self._pending.items()
                if not s.complete and now >= s.deadline]
        return [self._pending.pop(rid) for rid in late]

    def pop_all(self) -> List[Shipment]:
        """Drain every in-flight shipment (arm blackout: nothing can
        complete).  Attempt counters survive."""
        out = list(self._pending.values())
        self._pending.clear()
        return out

    def earliest_deadline(self) -> Optional[float]:
        live = [s.lane.deadline for s in self._pending.values()]
        return min(live) if live else None


def _pool_device(pool: Dict) -> torch.device:
    return next(iter(next(iter(pool.values())).values())).device


def ship_blocks(src_pool: Dict, dst_pool: Dict, src_ids: np.ndarray,
                dst_ids: np.ndarray) -> None:
    """Copy physical blocks ``src_ids`` of ``src_pool`` into blocks
    ``dst_ids`` of ``dst_pool`` (in place), the pools on any devices:
    ``gather_blocks`` on the source, the payload moved to the destination's
    device (a no-op on one device), ``scatter_blocks`` there.  Null-block
    pairs pad a wave: the source's null block is gathered and lands in the
    destination's null block.

    A copy to a card is enqueued without a host wait (PyTorch orders a
    copy between two cards against both devices' current streams); a copy
    to the CPU waits for the gather, so the scatter reads whole blocks."""
    dst_dev = _pool_device(dst_pool)
    payload = gather_blocks(src_pool,
                            _index(src_ids, _pool_device(src_pool)))
    moved = _map(lambda t: t.to(dst_dev,
                                non_blocking=dst_dev.type == "cuda"),
                 payload)
    scatter_blocks(dst_pool, moved, _index(dst_ids, dst_dev))


def _map(fn, tree: Dict) -> Dict:
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _index(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Block ids on ``device`` without a host wait: from pinned memory with
    a non-blocking copy on the card (a pageable copy would wait for the
    decode call in flight), as they are on the CPU."""
    t = torch.from_numpy(a)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


class CacheStore:
    """Block shipping pipe between one prefill and one decode scheduler.

    ``src`` must be a ``role="prefill"`` scheduler and ``dst`` a
    ``role="decode"`` one with the same pool layout, on one device or on
    two (``fleet``).
    ``on_requeue(lane)`` fires when a shipment times out (the backend
    pushes the reset request back onto the arm queue); after
    ``max_ship_retries`` attempts the request goes to ``on_fail`` instead
    (None retries forever).  ``injector`` (a ``repro_torch.faults``
    ``FaultInjector``) lets a seeded plan drop, duplicate or delay whole
    ship waves.  Under receiver pressure the store preempts: a more urgent
    arrival spills the latest-deadline seated decode lane
    (``dst.evict_latest``) for full re-execution.
    """

    def __init__(self, src: PagedArmScheduler, dst: PagedArmScheduler, *,
                 timeout_s: float = 30.0,
                 on_requeue: Optional[Callable[[Lane], None]] = None,
                 max_ship_retries: Optional[int] = None,
                 on_fail: Optional[Callable[[Lane], None]] = None,
                 injector=None):
        if src.role != "prefill" or dst.role != "decode":
            raise ValueError("CacheStore wants a prefill src and decode dst")
        if src.block_size != dst.block_size:
            raise ValueError("src/dst block sizes differ")
        if src.kv_dtype != dst.kv_dtype:
            raise ValueError("src/dst pool layouts differ")
        self.src = src
        self.dst = dst
        self.timeout_s = timeout_s
        self.on_requeue = on_requeue
        self.max_ship_retries = max_ship_retries
        self.on_fail = on_fail
        self.injector = injector
        self.ledger = RequestBlockBuffer()
        self.fleet = src.device != dst.device
        # injected-delay staging: (release_t, rid, dst_ids, attempt) marks
        # applied once the owner clock passes release_t, racing the
        # (backed-off) ledger deadline
        self._delayed: List[tuple] = []
        self._waiting: List[Lane] = []     # deferred on receiver pressure
        self._arrived: list = []           # (deadline, seq, lane) seat heap
        self._seq = 0

        # test fault injection: rid -> True drops the wave's arrival marks
        self.drop_filter: Optional[Callable[[int], bool]] = None
        #: rank 0 of a process-group mesh: ``relay(wire)`` before each
        #: wave's transfer, ``wire`` the [n_pad, 2] int32 (source,
        #: destination) block ids :meth:`replay_ship` takes
        self.relay = None

        # instrumentation
        self.blocks_shipped = 0
        self.transfer_bytes = 0
        self.ship_waves = 0
        self.ship_skipped_blocks = 0       # receiver prefix hits, not moved
        self.ship_deferred = 0
        self.ship_requeues = 0
        self.ship_dropped_waves = 0
        self.ship_retries = 0              # re-opened (attempt > 0) shipments
        self.ship_failed = 0               # retry budget exhausted
        self.decode_spills = 0             # backpressure lane evictions
        self.delayed_marks = 0             # injected-delay marks staged
        self.xdev_copies = 0               # cross-device leaf copies
        # ship/decode overlap (async dispatch): host seconds of ship + poll
        # work done while the decode call was in flight (hidden) vs
        # seconds blocked reading its results (exposed)
        self.overlap_hidden_s = 0.0
        self.overlap_exposed_s = 0.0
        self.overlap_steps = 0
        # open-shipment -> seated-arrival latency (merged up by the backend)
        self.ship_latency = Histogram()
        self.track = ("store", "ship")     # backend relabels per arm

    # ------------------------------------------------------------- status
    @property
    def backlog(self) -> int:
        return len(self.ledger) + len(self._waiting) + len(self._arrived)

    def earliest_deadline(self) -> Optional[float]:
        live = [l.deadline for l in self._waiting]
        live += [d for d, _, _ in self._arrived[:1]]
        led = self.ledger.earliest_deadline()
        if led is not None:
            live.append(led)
        return min(live) if live else None

    # --------------------------------------------------------------- ship
    def ship(self, lanes: Sequence[Lane], now: float) -> None:
        """Open shipments for the wave's lanes and move every outstanding
        block in one transfer.  Per lane: match the committed history
        against the *receiver's* prefix index (local blocks are shared, not
        shipped), then allocate the shipped + decode-growth blocks on the
        receiver.  A lane the receiver cannot host yet is deferred to the
        next wave, never dropped."""
        lanes = self._waiting + list(lanes)
        self._waiting = []
        if not lanes:
            return
        tr = get_tracer()
        with tr.span("ship_wave", track=self.track, lanes=len(lanes)) as sp:
            self._ship_wave(lanes, now, tr, sp)

    def _ship_wave(self, lanes: List[Lane], now: float, tr, sp) -> None:
        wave: List[tuple] = []
        for lane in lanes:
            c = lane.committed
            hist = lane.history()[:c]
            n_written = self.dst.alloc.blocks_for(c)
            total = self.dst.alloc.blocks_for(
                c + max(int(lane.req.max_new), 1) - 1)
            shared: List[int] = []
            if self.dst.prefix_sharing:
                # match_full: the first generated token is already in
                # lane.out, so no token need stay uncovered
                shared = self.dst.index.match_full(hist)
            if shared:
                self.dst.alloc.share(shared)
            ids = self.dst.alloc.alloc(total - len(shared))
            while ids is None:
                # receiver backpressure: spill the latest-deadline strictly
                # less urgent seated decode lane and retry; defer only when
                # every seated lane is at least as urgent
                victim = self.dst.evict_latest(lane.deadline, now)
                if victim is None:
                    break
                self.decode_spills += 1
                if self.on_requeue is not None:
                    self.on_requeue(victim)
                ids = self.dst.alloc.alloc(total - len(shared))
            if ids is None:
                if shared:
                    self.dst.alloc.free(shared)
                self._waiting.append(lane)
                self.ship_deferred += 1
                continue
            n_ship = n_written - len(shared)
            src_ids = lane.blocks[len(shared):n_written]
            dst_blocks = shared + ids
            # retry deadlines back off exponentially with the attempt count
            att = self.ledger.peek_attempt(lane.req.rid)
            self.ship_retries += int(att > 0)
            shp = self.ledger.open(lane, dst_blocks, len(shared),
                                   set(ids[:n_ship]),
                                   now + self.timeout_s * (2 ** min(att, 6)),
                                   opened=now)
            wave.append((lane, src_ids, ids[:n_ship], shp.attempt))
            self.ship_skipped_blocks += len(shared)
            tr.instant("ship", track=self.track, req=lane.req.rid,
                       blocks=n_ship, shared=len(shared), attempt=att)

        flat_src = [b for _, s, _, _ in wave for b in s]
        flat_dst = [b for _, _, d, _ in wave for b in d]
        sp.set(shipped=len(wave), blocks=len(flat_src))
        fault = None
        if flat_src:
            with annotation(f"ship:{next_pow2(len(flat_src))}"):
                self._transfer(flat_src, flat_dst)
            self.blocks_shipped += len(flat_src)
            self.transfer_bytes += len(flat_src) * self.src.kv_block_bytes
            self.ship_waves += 1
            # one injected fault charge applies to the WHOLE wave's marks
            if self.injector is not None:
                fault = self.injector.take_ship_fault()
                if fault is not None:
                    tr.instant("fault_injected", track=self.track,
                               kind=fault[0])
        if fault is not None and fault[0] == "ship_drop":
            self.ship_dropped_waves += 1
        for lane, _, dst_ids, att in wave:
            # source epilogue first: the prefill worker registers the
            # prompt in ITS index and frees its refs whether or not the
            # transfer is acknowledged (a lost wave re-prefills from cache)
            self.src.finish_shipped(lane)
            rid = lane.req.rid
            if self.drop_filter is not None and self.drop_filter(rid):
                self.ship_dropped_waves += 1
            elif fault is not None and fault[0] == "ship_drop":
                # arrival marks lost: the entry expires and the request
                # retries with a backed-off deadline
                lane.req.fault_t = now
            elif fault is not None and fault[0] == "ship_delay":
                # marks arrive late, possibly after the deadline: the stale
                # attempt race the ledger must absorb
                self._delayed.append((now + fault[1], rid, dst_ids, att))
                self.delayed_marks += 1
            else:
                self.ledger.mark(rid, dst_ids, attempt=att)
                if fault is not None and fault[0] == "ship_dup":
                    # duplicated arrival marks: idempotent by construction
                    self.ledger.mark(rid, dst_ids, attempt=att)

    def poll(self, now: float) -> int:
        """Apply due delayed marks, expire overdue shipments (free receiver
        refs, requeue, or fail past the retry budget), and seat completed
        arrivals into free decode lanes, spilling a strictly-later-deadline
        seated lane when an arrival is more urgent and no lane is free.
        Returns the number of lanes seated."""
        tr = get_tracer()
        if self._delayed:
            due = [e for e in self._delayed if e[0] <= now]
            self._delayed = [e for e in self._delayed if e[0] > now]
            for _, rid, dst_ids, att in due:
                # a mark landing after its attempt expired is stale and
                # ignored by the attempt-stamped ledger
                self.ledger.mark(rid, dst_ids, attempt=att)
        for shp in self.ledger.pop_expired(now):
            # tail-first, as _release parks blocks
            self.dst.alloc.free(shp.dst_blocks[::-1])
            lane = shp.lane
            rid = lane.req.rid
            tr.instant("ship_timeout", track=self.track, req=rid,
                       missing=len(shp.expected - shp.arrived),
                       attempt=shp.attempt)
            PagedArmScheduler.reset_for_reexec(lane)
            lane.req.fault_t = lane.req.fault_t or now
            if self.max_ship_retries is not None and self.on_fail is not None \
                    and self.ledger.peek_attempt(rid) > self.max_ship_retries:
                self.ship_failed += 1
                self.ledger.clear_attempt(rid)
                tr.instant("ship_failed", track=self.track, req=rid)
                self.on_fail(lane)
                continue
            self.ship_requeues += 1
            if self.on_requeue is not None:
                self.on_requeue(lane)
        for shp in self.ledger.pop_ready():
            lane = shp.lane
            self.ship_latency.observe(max(now - shp.opened, 0.0))
            lane.blocks = list(shp.dst_blocks)    # block-table rewrite
            lane.n_shared = shp.n_shared
            heapq.heappush(self._arrived, (lane.deadline, self._seq, lane))
            self._seq += 1
        seated = 0
        while self._arrived:
            if not self.dst.has_free_lane():
                # seat-level backpressure: an arrival more urgent than the
                # latest-deadline seated lane takes its seat
                victim = self.dst.evict_latest(self._arrived[0][0], now)
                if victim is None:
                    break
                self.decode_spills += 1
                if self.on_requeue is not None:
                    self.on_requeue(victim)
            _, _, lane = heapq.heappop(self._arrived)
            self.dst.admit_shipped(lane, now)
            seated += 1
        return seated

    # ------------------------------------------------------------- faults
    def abort_inflight(self, now: float) -> int:
        """Arm-blackout response: every in-flight shipment, deferred lane
        and unseated arrival fails NOW — receiver blocks free, lanes reset
        for re-execution, requests requeue (stamped for recovery).  Attempt
        counters survive, so the retries still back off."""
        tr = get_tracer()
        aborted: List[Lane] = []
        for shp in self.ledger.pop_all():
            self.dst.alloc.free(shp.dst_blocks[::-1])
            aborted.append(shp.lane)
        for _, _, lane in self._arrived:
            self.dst.alloc.free(lane.blocks[::-1])
            aborted.append(lane)
        self._arrived = []
        for lane in self._waiting:
            # deferred lanes still hold their SOURCE refs: release through
            # the ship epilogue so the re-prefill hits the source index
            self.src.finish_shipped(lane)
            aborted.append(lane)
        self._waiting = []
        self._delayed = []
        for lane in aborted:
            PagedArmScheduler.reset_for_reexec(lane)
            lane.req.fault_t = now
            self.ship_requeues += 1
            tr.instant("ship_aborted", track=self.track, req=lane.req.rid)
            if self.on_requeue is not None:
                self.on_requeue(lane)
        return len(aborted)

    # ---------------------------------------------------------- transfer
    def _transfer(self, src_ids: List[int], dst_ids: List[int]) -> None:
        """One gather from the prefill pool and one scatter into the decode
        pool (:func:`ship_blocks`), the wave padded to a power of two with
        null-block pairs; ``relay`` gets the pairs first."""
        wire = np.full((next_pow2(len(src_ids)), 2), NULL_BLOCK, np.int32)
        wire[:len(src_ids), 0] = src_ids
        wire[:len(dst_ids), 1] = dst_ids
        if self.relay is not None:
            self.relay(wire)
        self._ship(wire)

    def _ship(self, wire: np.ndarray) -> None:
        ship_blocks(self.src.pool, self.dst.pool, wire[:, 0].astype(np.int64),
                    wire[:, 1].astype(np.int64))
        if self.fleet:
            self.xdev_copies += len(list(_leaves(self.src.pool)))

    def replay_ship(self, wire: np.ndarray) -> None:
        """Another rank's side of ``relay``: the wave rank 0 shipped, from
        its [n_pad, 2] pairs, between this rank's two pool slices; counts
        the wave and its blocks (the non-null pairs)."""
        if wire.ndim != 2 or wire.shape[1] != 2:
            raise ValueError(f"a ship wave of shape {wire.shape}, expected "
                             "[n_pad, 2] (source, destination) pairs")
        self._ship(wire)
        self.ship_waves += 1
        self.blocks_shipped += int(np.count_nonzero(wire[:, 0] != NULL_BLOCK))

    def note_overlap(self, hidden_s: float, exposed_s: float) -> None:
        """Record one disagg step's ship/decode overlap split (the backend
        calls this after finishing an async decode dispatch)."""
        self.overlap_hidden_s += hidden_s
        self.overlap_exposed_s += exposed_s
        self.overlap_steps += 1

    # ------------------------------------------------------------ metrics
    def stats(self) -> dict:
        return {
            "blocks_shipped": self.blocks_shipped,
            "transfer_bytes": self.transfer_bytes,
            "ship_waves": self.ship_waves,
            "ship_skipped_blocks": self.ship_skipped_blocks,
            "ship_deferred": self.ship_deferred,
            "ship_requeues": self.ship_requeues,
            "ship_dropped_waves": self.ship_dropped_waves,
            "ship_retries": self.ship_retries,
            "ship_failed": self.ship_failed,
            "ship_stale_marks": self.ledger.stale_marks,
            "ship_delayed_marks": self.delayed_marks,
            "ship_xdev_copies": self.xdev_copies,
            "decode_spills": self.decode_spills,
            "ship_in_flight": len(self.ledger),
            "overlap_hidden_s": round(self.overlap_hidden_s, 6),
            "overlap_exposed_s": round(self.overlap_exposed_s, 6),
            "overlap_steps": self.overlap_steps,
        }
