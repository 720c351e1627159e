"""TorchBackend — the paged serving path of ``repro.engine.jax_backend`` on
PyTorch, as an ExecutionBackend.

One ``PagedArmScheduler`` per split arm, each over its own model and paged
KV pool on one device: LAYER -> ``Model(cfg)``, SEMANTIC ->
``SemanticModel(cfg.semantic(2))`` (what the JAX ``SemanticRunner`` builds
on a 1x1 mesh), COMPRESSED -> ``Model(cfg)``.  Each step picks the arm that
owes the earliest deadline and runs one scheduler step on it: EDF joins
with prefix-cache hits and copy-on-write, one chunked-prefill call, one
K-token decode call, immediate retirement.  Latency is queue wait +
execution; ``extra_metrics`` merges the schedulers' counters under their
declared kinds.

``kv_dtype="f32"`` keeps the pool in ``cfg.dtype`` (bf16 at full width);
``"int8"`` stores codes with one f32 scale per token slot and kv head.
``weight_quant="int8"|"int4"`` has each arm's scheduler serve from a
blockwise-quantized copy of its attention projections (``quant_matmul``).
Runs on ``cuda`` unless the caller passes ``device="cpu"``; asking for the
card where there is none raises.  Knobs of later slices raise
``NotImplementedError``.
"""
from __future__ import annotations

import heapq
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.decode.scheduler import PagedArmScheduler
from repro_torch.engine.types import (COMPRESSED, LAYER, SEMANTIC, Outcome,
                                      Request, accuracy_for)
from repro_torch.models.model import Model, SemanticModel
from repro_torch.obs import get_tracer, merge_stat_dicts

ARM_MODES = {LAYER: "pipeline", SEMANTIC: "semantic", COMPRESSED: "fsdp"}
SEMANTIC_BRANCHES = 2


def resolve_device(device) -> torch.device:
    """The serving device; raises when CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is "
                           "available; pass device='cpu' to run the plain "
                           "PyTorch path")
    return dev


def _not_ported(name: str, value, later: str) -> None:
    raise NotImplementedError(f"{name}={value!r} is ported in {later}")


class TorchBackend:
    def __init__(self, cfg: ArchConfig, *, cache_len: int = 128,
                 max_batch: int = 8, seed: int = 0,
                 arms=(LAYER, SEMANTIC), decode: str = "auto",
                 scan_tokens: int = 8, block_size: int = 16,
                 num_blocks: Optional[int] = None,
                 prefill_chunk: int = 32, prefix_sharing: bool = True,
                 watermark: float = 0.0, kv_dtype: str = "f32",
                 weight_quant: Optional[str] = None,
                 fleet: Optional[str] = None, faults=None,
                 load_shed: bool = False, jit_cache: Optional[dict] = None,
                 device="cuda"):
        if decode not in ("auto", "paged", "legacy"):
            raise ValueError(f"decode={decode!r}; expected auto|paged|legacy")
        if kv_dtype not in ("f32", "int8"):
            raise ValueError(f"kv_dtype={kv_dtype!r}; expected f32|int8")
        if weight_quant not in (None, "int8", "int4"):
            raise ValueError(f"weight_quant={weight_quant!r}; "
                             "expected None|int8|int4")
        if decode == "legacy":
            _not_ported("decode", decode, "the legacy gang-path slice")
        if fleet is not None:
            _not_ported("fleet", fleet, "the disaggregation slice")
        if faults is not None:
            _not_ported("faults", "<plan>", "the faults/routing slice")
        if load_shed:
            _not_ported("load_shed", load_shed, "the faults/routing slice")
        if jit_cache is not None:
            _not_ported("jit_cache", "<dict>", "the fleet slice")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.cache_len = cache_len
        self.max_batch = max_batch
        self.seed = seed
        self.scan_tokens = scan_tokens
        self.block_size = min(block_size, cache_len)
        self.num_blocks = num_blocks
        self.prefill_chunk = prefill_chunk
        self.prefix_sharing = prefix_sharing
        self.watermark = watermark
        self.kv_dtype = kv_dtype
        self.weight_quant = weight_quant
        self.models: Dict[int, object] = {}
        self._paged: Dict[int, PagedArmScheduler] = {}
        self._ttfts: List[float] = []
        # (abs_deadline, seq, enqueue_t, request) heaps per arm
        self._queues: Dict[int, list] = {}
        self._seq = 0
        self._t0 = time.perf_counter()
        for arm in arms:
            self._ensure_arm(arm)

    def _ensure_arm(self, arm: int) -> None:
        """Build the model, weights and scheduler of a split arm on first
        use — any policy decision (incl. COMPRESSED) is servable."""
        if arm in self.models:
            return
        if arm not in ARM_MODES:
            raise ValueError(f"unknown split decision {arm!r}; expected one "
                             f"of {sorted(ARM_MODES)}")
        model = SemanticModel(self.cfg.semantic(SEMANTIC_BRANCHES),
                              device=self.device) if arm == SEMANTIC \
            else Model(self.cfg, device=self.device)
        # every arm draws from the same seed, as JaxBackend's init key
        gen = torch.Generator(device=self.device).manual_seed(self.seed + 1)
        model.reset_parameters(gen)
        sched = PagedArmScheduler(
            model, n_lanes=self.max_batch, cache_len=self.cache_len,
            block_size=self.block_size, num_blocks=self.num_blocks,
            scan_tokens=self.scan_tokens, prefill_chunk=self.prefill_chunk,
            prefix_sharing=self.prefix_sharing, watermark=self.watermark,
            kv_dtype=self.kv_dtype, weight_quant=self.weight_quant,
            clock=lambda: self.now)
        sched.track = (f"arm{arm}:{ARM_MODES[arm]}", sched.track[1])
        self.models[arm] = model
        self._paged[arm] = sched
        self._queues[arm] = []

    # ------------------------------------------------------------- lifecycle
    @property
    def now(self) -> float:
        return time.perf_counter() - self._t0

    def pending(self) -> int:
        queued = sum(len(q) for q in self._queues.values())
        return queued + sum(s.backlog for s in self._paged.values())

    def submit(self, req: Request) -> None:
        self._ensure_arm(req.decision)
        self._paged[req.decision].validate(req)
        enq = self.now
        deadline = (req.arrival_s if req.arrival_s is not None else enq) \
            + req.sla_s
        heapq.heappush(self._queues[req.decision],
                       (deadline, self._seq, enq, req))
        self._seq += 1
        get_tracer().instant("place", req=req.rid, arm=req.decision,
                             mode=ARM_MODES[req.decision])

    # --------------------------------------------------------------- serving
    def _arm_urgency(self, arm: int) -> Optional[float]:
        """Earliest deadline this arm owes: queue head or in-flight lane."""
        cand = []
        if self._queues[arm]:
            cand.append(self._queues[arm][0][0])
        d = self._paged[arm].earliest_deadline()
        if d is not None:
            cand.append(d)
        return min(cand) if cand else None

    def _pick_arm(self) -> Optional[int]:
        live = [(u, arm) for arm in self._queues
                if (u := self._arm_urgency(arm)) is not None]
        return min(live)[1] if live else None

    def _outcome(self, req: Request, arm: int, enq: float, exec_start: float,
                 out: np.ndarray, finish: float) -> Outcome:
        req.queue_wait_s = exec_start - enq
        req.latency_s = finish - enq        # queue wait + execution
        req.output = out
        req.accuracy = accuracy_for(req.app_id, arm)
        return Outcome(request=req, decision=arm, latency_s=req.latency_s,
                       queue_wait_s=req.queue_wait_s, accuracy=req.accuracy,
                       finish_s=finish)

    @property
    def prefill_calls(self) -> int:
        """Chunked-prefill calls across the arms."""
        return sum(s.prefill_chunks for s in self._paged.values())

    def _lane_outcome(self, lane, arm: int, finish: float) -> Outcome:
        """Stamp a retired lane's Outcome, including time-to-first-token
        (admission -> the prefill chunk that produced ``out[0]``)."""
        req = lane.req
        if lane.first_tok_t:
            req.ttft_s = lane.first_tok_t - lane.enq
            self._ttfts.append(req.ttft_s)
        out = np.asarray(lane.out[:req.max_new], np.int32)
        return self._outcome(req, arm, lane.enq, lane.join_t, out, finish)

    def _step_paged(self, arm: int) -> List[Outcome]:
        """One dispatch boundary: seat queued/resumed requests, commit one
        prefill chunk, run one K-token decode call, retire finished lanes.
        Lanes retired at prefill completion are stamped before the decode
        call, so their response time does not absorb it."""
        sched = self._paged[arm]
        sched.try_join(self._queues[arm], self.now)
        done = sched.prefill_step(self.now)
        prefill_finish = self.now
        outcomes = [self._lane_outcome(lane, arm, prefill_finish)
                    for lane in done]
        retired = sched.dispatch(self.now)
        finish = self.now
        outcomes += [self._lane_outcome(lane, arm, finish)
                     for lane in retired]
        return outcomes

    def step(self, policy=None) -> List[Outcome]:
        arm = self._pick_arm()
        if arm is None:
            return []
        with get_tracer().span("step", arm=arm) as sp:
            out = self._step_paged(arm)
            sp.set(retired=len(out))
        return out

    # --------------------------------------------------------------- metrics
    def extra_metrics(self) -> dict:
        m = {"prefill_calls": self.prefill_calls}
        scheds = list(self._paged.values())
        if scheds:
            # counters sum across arms, per-pool gauges take the max, and
            # ratios recompute from the merged counters
            m.update(merge_stat_dicts((s.stats() for s in scheds),
                                      kinds=PagedArmScheduler.STAT_KINDS))
        if self._ttfts:
            m["ttft_s"] = round(float(np.mean(self._ttfts)), 6)
        return m
