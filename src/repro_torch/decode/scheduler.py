"""Continuous-batching scheduler over the shared paged KV pool of one arm.

The host logic is the JAX package's ``repro.decode.scheduler`` as it is:

  * ``try_join``     admits queued requests into free lanes at a dispatch
    boundary (EDF order).  The cached head of each prompt maps onto
    existing physical blocks (refcount shares; a partially matching block
    is resolved with one copy-on-write block copy), so only the uncached
    tail needs prefill.  Under allocator pressure latest-deadline lanes
    spill their blocks (tokens stay host-side, full blocks stay matchable)
    instead of the join rejecting.
  * ``prefill_step`` commits ONE chunk of uncached prompt tokens per
    prefilling lane — one call across the wave.
  * ``dispatch``     runs one K-token decode call across the decoding lanes
    and retires lanes whose budget is spent.  It is ``dispatch_async``
    (enqueue the call, no host read) followed by ``finish_dispatch`` (one
    read of the results), so a disaggregated backend can ship blocks while
    the decode call runs on the card.

Spilled lanes re-enter through ``try_join``; their re-prefill hits the
prefix cache.  Calls are built once per bucket — prefill on (pow2 wave
width, chunk), decode on (pow2 lane width, pow2 loop length), COW on the
pow2 pair count — and ``compile_stats`` / ``buckets`` count hits and misses
per bucket under the same names as the JAX scheduler.

``role=`` splits the step loop for a disaggregated fleet: a ``"prefill"``
worker detaches lanes that have their first token for the cache store to
ship (``take_ready`` / ``finish_shipped``), a ``"decode"`` worker seats the
shipped lanes (``admit_shipped``).  The fault responses (``spill_all``,
``evacuate``, ``evict_latest``, ``reset_for_reexec``) and the recovery
counters are the reference's.  Tensors live on the model's device, and
every call is enqueued on its current CUDA stream; block tables, lengths
and budgets stay host-side numpy and cross to the device once per call.
``weight_quant`` ("int8" / "int4") serves from a private blockwise-quantized
copy of the attention projections, made at construction; the model's float
parameters stay untouched.  Without it the built calls read the model's
params at every call (``model.grouped_views()``).  ``jit_cache`` is a
built-call dict shared by schedulers of one model (a fleet's replicas of an
arm): each bucket is built once across them, and they share the quantized
copy the calls close over.

The model may be a runner's view on a process-group mesh
(``dist.api.PagedView``): its pool is this rank's slice and its forwards
meet the other ranks' slices.  The three device calls (the COW copy, the
prefill chunk, the decode call) all go through :meth:`call`, which counts
them.  Its ``relay`` hook (rank 0's backend) gets each call's kind, bucket
and host arrays packed side by side into one int32 matrix before it runs;
on another rank :meth:`replay` unpacks that matrix and makes the same call
on its slices.  A worker pinned whole to one rank has the whole model
there and a ``dist.api.RemoteView`` elsewhere: rank 0's calls through the
view receive the outputs the pinned rank sends back (its ``answer`` hook,
after each replayed call), and another rank drops the call but counts
it.  Every rank keeps a CRC-32 of the tokens of its prefill and decode
calls (``token_digest``), read where the tokens reach the host.
"""
from __future__ import annotations

import heapq
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.decode.paged_cache import (NULL_BLOCK, BlockAllocator,
                                            PrefixIndex, copy_blocks,
                                            meta_like, pool_block_bytes,
                                            quantize_pool)
from repro_torch.decode.paged_model import (join_of, make_decode_fn,
                                            make_prefill_fn,
                                            quantize_attn_params,
                                            supports_paged_decode)
from repro_torch.engine.types import next_pow2
from repro_torch.obs import Histogram, annotation, get_tracer


@dataclass
class Lane:
    """Host-side record of one in-flight (or spilled) sequence."""
    req: object
    enq: float
    join_t: float
    blocks: List[int]
    out: List[int] = field(default_factory=list)
    n_shared: int = 0            # leading block-table entries from the index
    preemptions: int = 0
    committed: int = 0           # cache slots filled when detached for ship
    first_tok_t: float = 0.0     # wall-clock of the first generated token

    @property
    def deadline(self) -> float:
        base = self.req.arrival_s if self.req.arrival_s is not None \
            else self.enq
        return base + self.req.sla_s

    def history(self) -> np.ndarray:
        """prompt + generated tokens — position p of the sequence holds
        ``history()[p]`` (the resume-prefill input after a preemption)."""
        out = np.asarray(self.out, np.int32)
        return np.concatenate([np.asarray(self.req.tokens, np.int32), out])


class PagedArmScheduler:
    """Paged continuous-batching state for one split arm's model."""

    #: metric kinds for ``stats()`` keys (``repro_torch.obs.metrics``):
    #: undeclared keys are flow counters that SUM across schedulers; gauges
    #: MAX; ratios recompute from the merged counters.
    STAT_KINDS = {
        "batch_occupancy": ("ratio", "decoded_tokens", "lane_steps"),
        "mean_active_lanes": ("ratio", "active_lane_frac_sum",
                              "decode_dispatches"),
        "prefix_hit_rate": ("ratio", "prefix_hit_tokens",
                            "prefix_query_tokens"),
        "kv_block_bytes": "gauge",
        "kv_block_bytes_f32": "gauge",
        "kv_capacity_x": "gauge",
        "weight_quant_bits": "gauge",
        "weight_quant_max_err": "gauge",
        "weight_quant_mean_err": "gauge",
    }

    def __init__(self, model, *, n_lanes: int, cache_len: int,
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 scan_tokens: int = 8, util_floor: float = 0.5,
                 prefill_chunk: int = 32, prefix_sharing: bool = True,
                 watermark: float = 0.0, kv_dtype: str = "f32",
                 weight_quant: Optional[str] = None,
                 role: str = "colocated", clock=None,
                 jit_cache: Optional[dict] = None):
        if not supports_paged_decode(model):
            raise ValueError("model does not support paged decode "
                             "(needs pure global-attention mixers)")
        if role not in ("colocated", "prefill", "decode"):
            raise ValueError(f"role must be 'colocated', 'prefill' or "
                             f"'decode', got {role!r}")
        if kv_dtype not in ("f32", "int8"):
            raise ValueError(f"kv_dtype must be 'f32' or 'int8', "
                             f"got {kv_dtype!r}")
        if weight_quant not in (None, "int8", "int4"):
            raise ValueError(f"weight_quant must be None, 'int8' or 'int4', "
                             f"got {weight_quant!r}")
        self.model = model
        self.role = role
        self.device = model.device
        self.clock = clock
        self.track = ("paged", f"{role}@{self.device}")
        self.kv_dtype = kv_dtype
        self.weight_quant = weight_quant
        self.quant_telemetry: Dict[str, float] = {}
        # built-call cache, keyed (kind,) + shape bucket; a shared one
        # holds calls that close over another scheduler's params, so the
        # sharers must serve one model
        self._built: Dict[tuple, object] = \
            jit_cache if jit_cache is not None else {}
        params = None              # the model's own, read at each call
        if weight_quant is not None:
            # a PRIVATE quantized copy of the attention projections: the
            # model's float parameters stay untouched (other arms and the
            # caller may share them); one copy per built-call cache
            key = ("quant_params", weight_quant)
            if key not in self._built:
                self._built[key] = quantize_attn_params(
                    model.grouped_views(), int(weight_quant[3:]),
                    reduce=join_of(model).reduce_stats)
            params, telemetry = self._built[key]
            self.quant_telemetry = dict(telemetry)
        self.params = params
        #: rank 0 of a process-group mesh: ``relay(kind, key, wire)`` before
        #: each device call, ``wire`` the call's host arrays as
        #: :meth:`replay` takes them
        self.relay = None
        #: a worker pinned to a rank other than 0, on that rank:
        #: ``answer(outputs)`` after each replayed call sends rank 0 the
        #: outputs it reads
        self.answer = None
        #: CRC-32 of the tokens of every prefill and decode call, in call
        #: order
        self.token_digest = 0
        self.n_lanes = n_lanes
        self.block_size = block_size
        self.scan_tokens = scan_tokens
        self.util_floor = util_floor
        self.prefill_chunk = prefill_chunk
        self.prefix_sharing = prefix_sharing
        self.watermark = watermark
        self.max_blocks = -(-cache_len // block_size)
        if num_blocks is None:
            # full capacity: every lane can hold cache_len tokens, + null
            num_blocks = 1 + n_lanes * self.max_blocks
        self.index = PrefixIndex(block_size)
        self.alloc = BlockAllocator(
            num_blocks, block_size,
            on_evict=lambda blk, key: self.index.drop(key))
        self.pool = model.init_pool(num_blocks, block_size)
        # the byte gauges count a block of the WHOLE pool, as the
        # reference's global arrays do: a mesh view's pool is this rank's
        # slice of it (``PagedView.whole_pool``)
        whole = model.whole_pool(num_blocks, block_size) \
            if hasattr(model, "whole_pool") else meta_like(self.pool)
        self.kv_block_bytes_f32 = pool_block_bytes(whole)
        if kv_dtype == "int8":
            # int8 codes + one f32 scale per (token slot, kv head)
            self.pool = quantize_pool(self.pool)
            whole = quantize_pool(whole)
        self.kv_block_bytes = pool_block_bytes(whole)

        self.block_tables = np.full((n_lanes, self.max_blocks), NULL_BLOCK,
                                    np.int32)
        self.lengths = np.zeros(n_lanes, np.int32)      # committed tokens
        self.prefill_left = np.zeros(n_lanes, np.int32)
        self.remaining = np.zeros(n_lanes, np.int32)    # decode budget
        self.last_tok = np.zeros(n_lanes, np.int32)
        self.lanes: List[Optional[Lane]] = [None] * n_lanes
        self._resume: list = []       # (deadline, seq, lane) heap of spills
        self._rseq = 0
        self._ready: List[Lane] = []  # prefill role: detached, ship-ready

        # instrumentation
        self.join_waves = 0
        self.joined = 0
        self.prefill_chunks = 0
        self.decode_dispatches = 0
        self.decoded_tokens = 0
        self.lane_steps = 0            # lanes x loop length, all dispatches
        self._active_frac_sum = 0.0
        self.prefix_hit_tokens = 0
        self.prefix_query_tokens = 0
        self.cow_copies = 0
        self.preemptions = 0
        self.spilled_blocks = 0
        # fault recovery: full re-executions forced on this scheduler's
        # lanes (blackout evacuations, backpressure evictions), disrupted
        # requests re-admitted here, and the fault -> re-admission latency
        self.re_executions = 0
        self.recovered = 0
        self.recovery_latency = Histogram()
        self.compile_stats: Dict[str, int] = {}
        self.buckets: Dict[str, int] = {}

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # ----------------------------------------------------------- capacity
    def max_tokens_per_seq(self) -> int:
        return self.max_blocks * self.block_size

    def validate(self, req) -> None:
        # a prefill worker holds the prompt (and ships it before the first
        # decode write); the decode side needs the full final length
        if self.role == "prefill":
            need = len(req.tokens)
        else:
            need = len(req.tokens) + max(int(req.max_new), 1) - 1
        if need > self.max_tokens_per_seq():
            raise ValueError(
                f"request {req.rid}: {need} cache slots exceed the per-lane "
                f"paged capacity {self.max_tokens_per_seq()}")
        if self.alloc.blocks_for(need) > self.alloc.num_blocks - 1:
            raise ValueError(
                f"request {req.rid}: needs {self.alloc.blocks_for(need)} "
                f"blocks but the arm pool has {self.alloc.num_blocks - 1} "
                "allocatable blocks — it could never be admitted")

    @property
    def n_active(self) -> int:
        return sum(l is not None for l in self.lanes)

    @property
    def backlog(self) -> int:
        """Seated lanes + spilled lanes awaiting resume + ship-ready."""
        return self.n_active + len(self._resume) + len(self._ready)

    def has_free_lane(self) -> bool:
        return any(l is None for l in self.lanes)

    def earliest_deadline(self) -> Optional[float]:
        live = [l.deadline for l in self.lanes if l is not None]
        live += [l.deadline for l in self._ready]
        if self._resume:
            live.append(self._resume[0][0])
        return min(live) if live else None

    def has_work(self) -> bool:
        return self.backlog > 0

    def _scan_bucket(self, rems: np.ndarray) -> int:
        """Loop length for this dispatch: the largest pow2 <= scan_tokens
        whose slot utilization (sum min(rem, k) / (n_act * k)) stays above
        ``util_floor``, capped at the pow2 of the largest budget."""
        best = 1
        k = 1
        n = len(rems)
        while k <= self.scan_tokens:
            if float(np.minimum(rems, k).sum()) >= self.util_floor * n * k:
                best = k
            k *= 2
        return min(best, next_pow2(int(rems.max())))

    # -------------------------------------------------------------- build
    def _build(self, kind: str, key: tuple):
        """The device call of ``kind`` at bucket ``key``: (pool, *host
        arrays on the device) -> (pool, *outputs)."""
        if kind == "cow":
            return lambda pool, src, dst: (copy_blocks(pool, src, dst),)
        remote = getattr(self.model, "remote_call", None)
        if remote is not None:
            return remote(kind, key)
        if kind == "prefill":
            return make_prefill_fn(self.model, self.params)
        decode = make_decode_fn(self.model, scan_tokens=key[1],
                                params=self.params)

        def packed(pool, *host):
            # the outputs the host reads, in one [W, K + 3] int32 matrix
            pool, tok, lengths, remaining, toks = decode(pool, *host)
            return pool, torch.cat([toks, tok, lengths[:, None],
                                    remaining[:, None]], dim=1)
        return packed

    def _columns(self, kind: str, key: tuple) -> tuple:
        """The columns each host array of a call takes in its wire matrix
        (a row a lane, or a COW pair); 0 for a vector."""
        nb = self.max_blocks
        if kind == "cow":
            return 0, 0
        return (key[1], 0, 0, nb) if kind == "prefill" else (1, nb, 0, 0)

    def call(self, kind: str, key: tuple, host: tuple) -> list:
        """One device call: ``kind`` ("cow", "prefill" or "decode") at
        bucket ``key`` on the pool, its host arrays moved to the device.
        The pool rebinds to the call's output; returns the other outputs.
        ``relay`` gets the call first, its host arrays as one int32
        matrix."""
        if self.relay is not None:
            self.relay(kind, key, np.concatenate(
                [np.asarray(a, np.int32).reshape(key[0], -1) for a in host],
                axis=1))
        fn = self._get_built(kind, key, lambda: self._build(kind, key))
        self.pool, *out = fn(self.pool, *(self._dev(a) for a in host))
        self._count(kind, host)
        return out

    def _count(self, kind: str, host: tuple) -> None:
        if kind == "cow":
            self.cow_copies += int(np.count_nonzero(host[0] != NULL_BLOCK))
        elif kind == "prefill":
            self.prefill_chunks += 1
        else:
            self.decode_dispatches += 1

    def replay(self, kind: str, key: tuple, wire: np.ndarray) -> None:
        """Another rank's side of ``relay``: the call rank 0 made, from its
        wire matrix, on this rank's pool (a worker held elsewhere only
        counts it); then ``answer`` gets the outputs rank 0 reads."""
        host, at = [], 0
        for cols in self._columns(kind, key):
            host.append(wire[:, at:at + cols] if cols else wire[:, at])
            at += max(cols, 1)
        if at != wire.shape[1]:
            raise ValueError(f"{kind} call {key}: a wire matrix of "
                             f"{wire.shape[1]} columns, expected {at}")
        if hasattr(self.model, "remote_call"):     # held on another rank
            self._count(kind, tuple(host))
            return
        out = self.call(kind, key, tuple(host))
        if kind == "cow":
            return
        read = out[0].cpu()
        # a prefill's pad rows (no tokens) attend the null block, whose
        # contents are garbage by design: only its lanes' tokens count
        self._note_tokens(read.numpy()[host[2] > 0] if kind == "prefill"
                          else read.numpy()[:, :key[1]])
        if self.answer is not None:
            self.answer(read)

    def _note_tokens(self, toks: np.ndarray) -> None:
        """Add a call's tokens (a prefill's lanes', a decode call's [W, K])
        to ``token_digest``."""
        self.token_digest = zlib.crc32(
            np.ascontiguousarray(toks, np.int32).tobytes(), self.token_digest)

    def _get_built(self, kind: str, key: tuple, build):
        full = (kind,) + key
        stat = f"{kind}_hits" if full in self._built else f"{kind}_misses"
        self.compile_stats[stat] = self.compile_stats.get(stat, 0) + 1
        name = f"{kind}:{'x'.join(map(str, key))}"
        if full not in self._built:
            self._built[full] = build()
            get_tracer().instant("compile_miss", track=self.track,
                                 bucket=name)
        self.buckets[name] = self.buckets.get(name, 0) + 1
        return self._built[full]

    # ------------------------------------------------------- release/spill
    def _release(self, li: int, *, register: bool) -> int:
        """Retire or spill the lane in slot ``li``: register the full blocks
        of its committed history in the prefix index, then drop all block
        references.  Returns the number of references released."""
        lane = self.lanes[li]
        written = int(self.lengths[li])
        if register and self.prefix_sharing and written >= self.block_size:
            self.index.insert(lane.history()[:written], lane.blocks,
                              self.alloc)
        n = len(lane.blocks)
        if lane.blocks:
            # park tail-first: LRU eviction then reclaims chain TAILS before
            # their parents, so the surviving shorter prefix stays matchable
            self.alloc.free(lane.blocks[::-1])
        lane.blocks = []
        lane.n_shared = 0
        self.lanes[li] = None
        self.block_tables[li] = NULL_BLOCK
        self.lengths[li] = 0
        self.prefill_left[li] = 0
        self.remaining[li] = 0
        return n

    def _preempt(self, li: int, now: float) -> None:
        """Spill the lane: blocks go back to the pool (full ones stay
        matchable), tokens stay host-side, and the lane queues for resume."""
        lane = self.lanes[li]
        released = self._release(li, register=True)
        lane.preemptions += 1
        self.preemptions += 1
        self.spilled_blocks += released
        get_tracer().instant("preempt", track=self.track, req=lane.req.rid,
                             spilled=released)
        heapq.heappush(self._resume, (lane.deadline, self._rseq, lane))
        self._rseq += 1

    def _spill_until(self, n_needed: int, deadline: float, now: float) -> None:
        """Preempt latest-deadline victims until ``n_needed`` blocks (plus
        the watermark headroom) are available or no strictly-later-deadline
        victim remains."""
        reserve = int(self.watermark * (self.alloc.num_blocks - 1))
        while self.alloc.available_blocks < n_needed + reserve:
            victims = [(l.deadline, li) for li, l in enumerate(self.lanes)
                       if l is not None and l.deadline > deadline]
            if not victims:
                return
            self._preempt(max(victims)[1], now)

    # ---------------------------------------------------- fault recovery
    def _observe_recovery(self, lane: Lane, now: float) -> None:
        """A fault-disrupted request just re-seated: close its recovery arc
        (fault stamp -> re-admission) and clear the stamp."""
        req = lane.req
        if req.fault_t <= 0.0:
            return
        self.recovery_latency.observe(max(now - req.fault_t, 0.0))
        self.recovered += 1
        req.fault_t = 0.0
        get_tracer().instant("recovery", track=self.track, req=req.rid)

    @staticmethod
    def reset_for_reexec(lane: Lane) -> None:
        """Host-side reset to pre-prefill state: the request re-executes
        from scratch (deterministic argmax decode -> the same tokens)."""
        lane.out = []
        lane.blocks = []
        lane.n_shared = 0
        lane.committed = 0
        lane.first_tok_t = 0.0

    def spill_all(self, now: float, fault_t: Optional[float] = None) -> int:
        """Blackout response for a colocated/prefill scheduler: preempt every
        seated lane through the ordinary spill path (blocks park in the
        prefix cache, lanes queue for resume).  Returns the number
        spilled."""
        seated = [li for li, l in enumerate(self.lanes) if l is not None]
        for li in seated:
            if fault_t is not None:
                self.lanes[li].req.fault_t = fault_t
            self._preempt(li, now)
        return len(seated)

    def evacuate(self, now: float,
                 fault_t: Optional[float] = None) -> List[Lane]:
        """Blackout response for a decode scheduler: seated lanes cannot
        resume here (they seat via ``admit_shipped``), so each is fully
        reset for re-execution — full blocks stay matchable, making the
        re-ship a receiver-side prefix hit — and the caller requeues them."""
        out: List[Lane] = []
        for li, lane in enumerate(self.lanes):
            if lane is None:
                continue
            self._release(li, register=True)
            self.reset_for_reexec(lane)
            if fault_t is not None:
                lane.req.fault_t = fault_t
            self.re_executions += 1
            out.append(lane)
        return out

    def evict_latest(self, deadline: float, now: float) -> Optional[Lane]:
        """Ship-backpressure preemption: reset the seated lane with the
        LATEST deadline strictly later than ``deadline`` so a more urgent
        shipment can seat or allocate.  The victim re-executes from prefill
        (its blocks stay matchable).  Returns it for requeue, or None if
        every seated lane is at least as urgent."""
        victims = [(l.deadline, li) for li, l in enumerate(self.lanes)
                   if l is not None and l.deadline > deadline]
        if not victims:
            return None
        li = max(victims)[1]
        lane = self.lanes[li]
        self._release(li, register=True)
        self.reset_for_reexec(lane)
        self.preemptions += 1
        self.re_executions += 1
        get_tracer().instant("decode_spill", track=self.track,
                             req=lane.req.rid)
        return lane

    # -------------------------------------------------------------- joins
    def try_join(self, queue: list, now: float) -> None:
        """Admit the most urgent queued/spilled candidates into free lanes:
        shared cached heads, at most one copy-on-write block each, private
        blocks for the rest, spilling later-deadline lanes under pressure.
        No model call happens here."""
        if self.role == "decode":
            raise RuntimeError("decode-role scheduler seats lanes via "
                               "admit_shipped, not try_join")
        if not (queue or self._resume):
            return
        free = [i for i, l in enumerate(self.lanes) if l is None]
        with get_tracer().span("join_wave", track=self.track,
                               free=len(free)) as sp:
            admitted = self._join_wave(queue, now, free)
            sp.set(admitted=admitted)

    def _join_wave(self, queue: list, now: float, free: List[int]) -> int:
        tr = get_tracer()
        seat = iter(free)
        cow_pairs: List[tuple] = []
        admitted = 0
        while admitted < len(free) and (queue or self._resume):
            use_resume = bool(self._resume) and (
                not queue or self._resume[0][0] <= queue[0][0])
            if use_resume:
                _, _, lane = heapq.heappop(self._resume)
            else:
                item = heapq.heappop(queue)
                _, _, enq, req = item
                # an impossible request must raise, not wedge — but earlier
                # admissions of this wave may have COW copies pending:
                # flush before propagating
                try:
                    self.validate(req)
                except ValueError:
                    self._flush_cow(cow_pairs)
                    raise
                lane = Lane(req=req, enq=enq, join_t=now, blocks=[])
            req = lane.req
            seq_toks = lane.history()
            if self.role == "prefill":
                # prompt slots only: the first decode write happens on the
                # receiver, after the blocks ship
                total_need = self.alloc.blocks_for(len(seq_toks))
            else:
                total_need = self.alloc.blocks_for(
                    len(req.tokens) + max(int(req.max_new), 1) - 1)
            shared: List[int] = []
            cow = None
            if self.prefix_sharing:
                shared, cow = self.index.match(seq_toks)
            if shared:
                self.alloc.share(shared)
            if cow is not None:
                # pin the COW source so allocating this lane's private
                # blocks cannot evict it before the copy runs
                self.alloc.share([cow[0]])
            n_alloc = total_need - len(shared)
            reserve = int(self.watermark * (self.alloc.num_blocks - 1))
            if self.alloc.available_blocks < n_alloc + reserve:
                self._spill_until(n_alloc, lane.deadline, now)
            ids = self.alloc.alloc(n_alloc)
            if ids is None and cow is not None:
                # borderline pool: drop the COW pin and retry without it
                self.alloc.free([cow[0]])
                cow = None
                self._spill_until(n_alloc, lane.deadline, now)
                ids = self.alloc.alloc(n_alloc)
            if ids is None:
                # every seated lane is more urgent: the candidate waits
                if shared:
                    self.alloc.free(shared)
                if use_resume:
                    heapq.heappush(self._resume,
                                   (lane.deadline, self._rseq, lane))
                    self._rseq += 1
                else:
                    heapq.heappush(queue, item)
                break
            covered = len(shared) * self.block_size
            if cow is not None:
                src, keep = cow
                cow_pairs.append((src, ids[0]))
                covered += keep
            lane.blocks = shared + ids
            lane.n_shared = len(shared)
            li = next(seat)
            self.lanes[li] = lane
            row = np.full(self.max_blocks, NULL_BLOCK, np.int32)
            row[:len(lane.blocks)] = lane.blocks
            self.block_tables[li] = row
            self.lengths[li] = covered
            self.prefill_left[li] = len(seq_toks) - covered
            self.remaining[li] = 0
            self.prefix_hit_tokens += covered
            self.prefix_query_tokens += len(seq_toks)
            tr.instant("seat", req=req.rid, cached=covered,
                       resumed=use_resume)
            self._observe_recovery(lane, now)
            admitted += 1

        self._flush_cow(cow_pairs)
        if admitted:
            self.join_waves += 1
            self.joined += admitted
        return admitted

    def _flush_cow(self, cow_pairs: List[tuple]) -> None:
        """Run the wave's pending copy-on-write block copies (one call,
        pow2 pair count) and release the pinned source references."""
        if not cow_pairs:
            return
        n_pad = next_pow2(len(cow_pairs))
        src = np.full(n_pad, NULL_BLOCK, np.int32)
        dst = np.full(n_pad, NULL_BLOCK, np.int32)
        for i, (s, d) in enumerate(cow_pairs):
            src[i], dst[i] = s, d
        with get_tracer().span("cow_copy", track=self.track,
                               pairs=len(cow_pairs)), \
                annotation(f"cow:{n_pad}"):
            self.call("cow", (n_pad,), (src, dst))
        self.alloc.free([s for s, _ in cow_pairs])
        cow_pairs.clear()

    # ------------------------------------------------------------ prefill
    def prefill_step(self, now: float) -> List[Lane]:
        """Commit ONE chunk of uncached prompt tokens for every prefilling
        lane (one call, pow2 wave width).  Lanes whose tail completes read
        their first generated token from the chunk logits; a lane whose
        budget is already spent retires here.  Returns the retired lanes."""
        pf = [i for i, l in enumerate(self.lanes)
              if l is not None and self.prefill_left[i] > 0]
        if not pf:
            return []
        w = next_pow2(len(pf))
        # chunk length buckets to the widest lane's need (pow2, capped)
        c = min(self.prefill_chunk,
                next_pow2(int(min(np.max(self.prefill_left[pf]),
                                  self.prefill_chunk))))
        toks = np.zeros((w, c), np.int32)
        starts = np.zeros(w, np.int32)
        n_tok = np.zeros(w, np.int32)
        bt = np.full((w, self.max_blocks), NULL_BLOCK, np.int32)
        for row, li in enumerate(pf):
            lane = self.lanes[li]
            s0 = int(self.lengths[li])
            k = min(int(self.prefill_left[li]), c)
            toks[row, :k] = lane.history()[s0:s0 + k]
            starts[row] = s0
            n_tok[row] = k
            bt[row] = self.block_tables[li]
        tr = get_tracer()
        with tr.span("prefill_chunk", track=self.track, wave=len(pf),
                     chunk=c), annotation(f"prefill:{w}x{c}"):
            first, = self.call("prefill", (w, c), (toks, starts, n_tok, bt))
            first = first.cpu().numpy()
        self._note_tokens(first[n_tok > 0])

        retired: List[Lane] = []
        t_first = self.clock() if self.clock is not None else now
        for row, li in enumerate(pf):
            lane = self.lanes[li]
            k = min(int(self.prefill_left[li]), c)
            self.lengths[li] += k
            self.prefill_left[li] -= k
            if self.prefill_left[li] > 0:
                continue
            lane.out.append(int(first[row]))
            lane.first_tok_t = t_first
            tr.instant("first_token", track=self.track, req=lane.req.rid)
            budget = int(lane.req.max_new) - len(lane.out)
            if budget <= 0:
                self._release(li, register=True)
                retired.append(lane)
                tr.instant("retire", track=self.track, req=lane.req.rid)
            elif self.role == "prefill":
                # detach for shipping: the lane keeps its block references,
                # the seat frees for the next prefill wave; the cache store
                # ships the blocks and calls ``finish_shipped``
                lane.committed = int(self.lengths[li])
                self._detach(li)
                self._ready.append(lane)
            else:
                self.remaining[li] = budget
                self.last_tok[li] = first[row]
        return retired

    # ----------------------------------------------------- ship / receive
    def _detach(self, li: int) -> None:
        """Clear seat ``li`` WITHOUT dropping the lane's block references
        (contrast ``_release``)."""
        self.lanes[li] = None
        self.block_tables[li] = NULL_BLOCK
        self.lengths[li] = 0
        self.prefill_left[li] = 0
        self.remaining[li] = 0

    def take_ready(self) -> List[Lane]:
        """Drain the ship-ready lanes a prefill worker has detached."""
        out, self._ready = self._ready, []
        return out

    def finish_shipped(self, lane: Lane) -> None:
        """Source-side epilogue of a shipment: register the lane's full
        blocks in this worker's prefix index (later same-head prompts skip
        their re-prefill), then drop the block references."""
        if self.prefix_sharing and lane.committed >= self.block_size:
            self.index.insert(lane.history()[:lane.committed], lane.blocks,
                              self.alloc)
        if lane.blocks:
            self.alloc.free(lane.blocks[::-1])
        lane.blocks = []
        lane.n_shared = 0

    def admit_shipped(self, lane: Lane, now: float) -> None:
        """Seat an arrived shipment in a free decode lane.  ``lane.blocks``
        already names local blocks (the cache store rewrote the table on
        receive), so decoding resumes from the first generated token at
        position ``committed``, as the colocated path would."""
        if self.role != "decode":
            raise RuntimeError("admit_shipped on a non-decode scheduler")
        li = next(i for i, l in enumerate(self.lanes) if l is None)
        if self.prefix_sharing and lane.committed >= self.block_size:
            # shipped blocks become cached prefix HERE: the next same-head
            # request hits the receiver's index and skips the transfer
            self.index.insert(lane.history()[:lane.committed], lane.blocks,
                              self.alloc)
        self.lanes[li] = lane
        row = np.full(self.max_blocks, NULL_BLOCK, np.int32)
        row[:len(lane.blocks)] = lane.blocks
        self.block_tables[li] = row
        self.lengths[li] = lane.committed
        self.prefill_left[li] = 0
        self.remaining[li] = int(lane.req.max_new) - len(lane.out)
        self.last_tok[li] = lane.out[-1]
        self.joined += 1
        get_tracer().instant("admit_shipped", track=self.track,
                             req=lane.req.rid, blocks=len(lane.blocks))
        self._observe_recovery(lane, now)

    # ------------------------------------------------------------ dispatch
    def dispatch(self, now: float) -> List[Lane]:
        """One K-token decode call across the decoding lanes; retire
        finished lanes.  Returns the retired lanes."""
        return self.finish_dispatch(self.dispatch_async(now), now)

    def dispatch_async(self, now: float) -> Optional[dict]:
        """Enqueue one K-token decode call and return WITHOUT reading its
        results: the pending record holds the output tensors and the host
        state ``finish_dispatch`` needs.  None when no lane is decoding.

        Active lanes compact into a pow2-width call and the loop length
        buckets to the budgets (``_scan_bucket``).  ``self.pool`` is rebound
        to the call's output at once, so work enqueued before
        ``finish_dispatch`` (a cache-store ship wave) runs after the decode
        writes: one stream orders them."""
        act = np.nonzero(self.remaining > 0)[0]
        n_act = len(act)
        if n_act == 0:
            return None
        w = next_pow2(n_act)
        k_eff = self._scan_bucket(self.remaining[act])
        # pad rows are inactive: null tables, zero budget, length 0
        bt = np.full((w, self.max_blocks), NULL_BLOCK, np.int32)
        lengths = np.zeros(w, np.int32)
        remaining = np.zeros(w, np.int32)
        tok = np.zeros(w, np.int32)
        bt[:n_act] = self.block_tables[act]
        lengths[:n_act] = self.lengths[act]
        remaining[:n_act] = self.remaining[act]
        tok[:n_act] = self.last_tok[act]
        old_remaining = remaining.copy()

        with get_tracer().span("decode_scan", track=self.track, lanes=n_act,
                               scan=k_eff), annotation(f"decode:{w}x{k_eff}"):
            # [W, K + 3]: the K tokens, then tok', lengths', remaining'
            out, = self.call("decode", (w, k_eff),
                             (tok[:, None], bt, lengths, remaining))
        self.lane_steps += w * k_eff
        self._active_frac_sum += n_act / w
        return {
            "act": act, "k_eff": k_eff, "old_remaining": old_remaining,
            # lane identity per active row: a row writes back only if its
            # slot still holds the SAME lane (evict_latest can free a slot,
            # and admit_shipped re-seat it, while the call runs)
            "lanes": [self.lanes[i] for i in act],
            "out": out,
        }

    def finish_dispatch(self, pending: Optional[dict],
                        now: float) -> List[Lane]:
        """Read a ``dispatch_async`` record's results in one host copy,
        write back lane state and retire finished lanes."""
        if pending is None:
            return []
        act, k_eff = pending["act"], pending["k_eff"]
        old_remaining = pending["old_remaining"]
        # the host waits here for the decode call: its own span, so a
        # decode step's time is the enqueue (``decode_scan``) plus this
        with get_tracer().span("decode_read", track=self.track):
            host = pending["out"].cpu().numpy()
        toks = host[:, :k_eff]
        self._note_tokens(toks)
        tok_o = host[:, k_eff]
        lengths_o = host[:, k_eff + 1]
        remaining_o = host[:, k_eff + 2]

        tr = get_tracer()
        retired: List[Lane] = []
        for row, i in enumerate(act):
            lane = pending["lanes"][row]
            if self.lanes[i] is not lane:
                # evicted mid-flight (ship backpressure): its tokens are
                # discarded — the lane re-executes from prefill, and its
                # stale writes to reallocated blocks were overwritten by
                # the later-enqueued ship scatter
                continue
            self.last_tok[i] = tok_o[row]
            self.lengths[i] = lengths_o[row]
            self.remaining[i] = remaining_o[row]
            n_take = min(int(old_remaining[row]), k_eff)
            lane.out.extend(int(t) for t in toks[row, :n_take])
            self.decoded_tokens += n_take
            if self.remaining[i] == 0:
                self._release(i, register=True)
                retired.append(lane)
                tr.instant("retire", track=self.track, req=lane.req.rid)
        return retired

    # ------------------------------------------------------------- metrics
    def stats(self) -> dict:
        occ = self.decoded_tokens / max(self.lane_steps, 1)
        act = self._active_frac_sum / max(self.decode_dispatches, 1)
        return {
            "join_waves": self.join_waves,
            "joined": self.joined,
            "prefill_chunks": self.prefill_chunks,
            "decode_dispatches": self.decode_dispatches,
            "decoded_tokens": self.decoded_tokens,
            "lane_steps": self.lane_steps,
            "active_lane_frac_sum": round(self._active_frac_sum, 6),
            "batch_occupancy": round(occ, 4),
            "mean_active_lanes": round(act, 4),
            "free_blocks": self.alloc.free_blocks,
            "used_blocks": self.alloc.used_blocks,
            "evictable_blocks": self.alloc.evictable_blocks,
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "prefix_query_tokens": self.prefix_query_tokens,
            "prefix_hit_rate": round(
                self.prefix_hit_tokens / max(self.prefix_query_tokens, 1), 4),
            "cow_copies": self.cow_copies,
            "preemptions": self.preemptions,
            "spilled_blocks": self.spilled_blocks,
            "re_executions": self.re_executions,
            "recovered": self.recovered,
            "kv_block_bytes": self.kv_block_bytes,
            "kv_block_bytes_f32": self.kv_block_bytes_f32,
            # effective-capacity multiplier: KV blocks per byte vs f32
            "kv_capacity_x": round(
                self.kv_block_bytes_f32 / max(self.kv_block_bytes, 1), 4),
            **self.quant_telemetry,
            **{f"compile_{k}": v for k, v in self.compile_stats.items()},
        }
