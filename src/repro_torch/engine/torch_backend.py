"""TorchBackend — ``repro.engine.jax_backend`` on PyTorch, as an
ExecutionBackend.

Each split arm has its own model on one device: LAYER -> ``Model(cfg)``,
SEMANTIC -> ``SemanticModel(cfg.semantic(max(2, M)))`` (what the JAX
``SemanticRunner`` builds on a mesh of 'model' size M), COMPRESSED ->
``Model(cfg)``.  ``mesh`` is a (data, model) shape (a tuple, a ``"D,M"``
string or a ``launch.mesh.MeshShape``): as ``JaxBackend``'s mesh, it only
shapes the arms' runners (the semantic branch count; the pipeline's stage
count is the reference's, and no serving step reads it), and nothing is
placed on other devices.

A process-group ``launch.mesh.Mesh`` of several ranks serves the paged and
the gang path across them, single-controller as the reference's one JAX
program is.  Every rank constructs the same backend; each arm is a
``dist.api`` runner on the mesh (LAYER the pipeline runner in the stage
graph's layout, a stage a 'model' rank; SEMANTIC its branches on 'model';
COMPRESSED fsdp; none splits its weights over 'data'), holding its slice of
the weights every rank draws from the same seed.  Rank 0 alone runs the
engine, the policy, the queues, the clock and the fault plane, and on the
paged path the joins, the allocators, the prefix indexes, copy-on-write,
preemption and, for a disaggregated arm, the ship ledger, its timeouts,
receiver backpressure and the fault responses.  Before each device call
it broadcasts a header of seven int64s, (op, arm, a, b, c, worker,
replica), over the world, and the other ranks, in :meth:`follow`, make
the same call (``replica`` names the backend among a fleet's replicas, 0
for a backend alone):

- a gang batch (``OP_GANG``: rows, prompt length, new tokens; then the
  tokens): ``init_cache``, ``prefill_into_cache`` or a teacher-forced
  ``serve_step`` loop, then ``serve_step`` a token, through the runners,
  which give every rank the global logits;
- a paged call (``OP_COW``, ``OP_PREFILL``, ``OP_DECODE``; a, b the
  bucket, c the width of the call's host arrays as the scheduler packs
  them, one [a, c] int32 matrix that follows): ``worker`` names the
  ``PagedArmScheduler`` of the arm (``COLOCATED``, or a disaggregated
  arm's ``PREFILL`` or ``DECODE`` worker), which on every rank holds that
  rank's slice of its paged pool (``dist.api``'s paged surface) and
  replays the call there, its forward passing only tokens (and a stage's
  activation) between ranks;
- a ship wave of a disaggregated arm (``OP_SHIP``; a the wave's padded
  width, c = 2; then the [a, 2] int32 matrix of (source, destination)
  block ids, null pairs padding it): every rank's ``CacheStore`` copies
  those blocks from its prefill worker's pool slice into its decode
  worker's.  Both slices have one layout and the block dim is split by
  no axis, so the ship moves no pool bytes between ranks;
- a lazily built arm (``OP_ARM``: a policy's first request to an arm not
  in ``arms``), so that ranks build arms, and run the collectives of a
  build, in one order.

On a mesh the entries of ``fleet_devices`` are ranks of the world, each
standing for that rank's device (as a JAX device of a multi-process run
belongs to one process); anything else raises.  A disaggregated arm that
takes a (prefill rank, decode rank) pair pins each worker whole to its
rank: that rank holds the arm's whole model (drawn from the one-process
seed) and the worker's whole pool, the others a ``dist.api.RemoteView``
of it (no weights, the pool's shapes on the meta device).  Rank 0 still
keeps both workers' host state and relays their calls: only the pinned
rank replays one, and a pinned rank other than 0 sends back the outputs
rank 0 reads (the chunk's tokens; the decode call's tokens, lengths and
budgets), which rank 0's remote view receives, the decode call's posted
at dispatch and waited for at the read, so the ship's host work runs
while it is in flight.  A wave between two ranks goes point to point
from the prefill rank to the decode rank (``CacheStore``).  Once fewer
than two ranks are left in the pool, an arm's workers serve on the
runner's view as above.

Headers and host arrays travel as host tensors under gloo and on the
card under NCCL (``launch.mesh.wire_device``).  Every rank makes a
disaggregated step's device calls in one order: the prefill worker's COW
copy and chunk, the decode worker's call, the ship, then the read of the
decode call's tokens; fault responses, timeouts and evictions are host
work on rank 0 and send nothing.

:meth:`close` on rank 0 stops the followers.  ``decode="auto"`` takes the
gang path on recurrent and local-window configs, as in one process.  An
enc-dec config builds both arms on a mesh as in one process (the LAYER
stages run whisper's encoder as a chain of stages of their own); as in
the reference, a request carries no audio, so its first gang step raises
``KeyError: 'audio_embeds'``, on every rank alike.

Each step picks the arm that owes the earliest deadline and runs one step
of one of two decode paths on it:

  * **paged** (``decode="auto"`` on pure global-attention models, or
    ``"paged"``): a ``PagedArmScheduler`` over a paged KV pool — EDF joins
    with prefix-cache hits and copy-on-write, one chunked-prefill call, one
    K-token decode call, immediate retirement.
  * **legacy** (``decode="legacy"``, and ``"auto"`` on recurrent mixers
    and local-window ring buffers; enc-dec and VLM models land here too,
    but, as in the reference, the backend passes them ``{"tokens": ...}``
    only, no frame or patch inputs, so they serve at the model level only:
    an enc-dec step raises ``KeyError: 'audio_embeds'``): rigid EDF gang
    batches — up to ``max_batch`` requests, prompts right-padded to the
    batch's longest, the batch padded to a power of two, one dense cache of
    ``cache_len``; one whole-prompt prefill (token by token for models
    without single-step prefill), then one decode step per token until the
    batch's longest request is done (the reference's teacher-forced-pad
    semantics: a shorter prompt's first token comes from the padded last
    column).  Each decode step runs the ``decode_attention`` kernel per
    attention layer and, in mLSTM layers, ``block_diag_matmul`` per
    projection.

Latency is queue wait + execution; ``extra_metrics`` merges the
schedulers' counters under their declared kinds, and reports the gang
path's ``batches``, ``decode_steps``, prefill bucket hits and misses and
occupancy as the reference does.

``kv_dtype="f32"`` keeps the pool in ``cfg.dtype`` (bf16 at full width);
``"int8"`` stores codes with one f32 scale per token slot and kv head.
``weight_quant="int8"|"int4"`` has each arm's scheduler serve from a
blockwise-quantized copy of its attention projections (``quant_matmul``).

``fleet="disagg"`` gives each arm a prefill worker and a decode worker,
each with its own pool, joined by a ``CacheStore`` that ships finished
prompts' KV blocks.  ``fleet_devices`` is a pool of devices (ranks, on a
process-group mesh) from which each arm, in the order the arms are built,
takes a (prefill, decode) pair; once fewer than two are left an arm's
workers share the backend's device, as in the reference.  A worker on
another device than the backend's holds a copy of the arm's model, made
once, and the store ships between the two devices.  On a process-group
mesh an arm without a pair serves both workers on the arm's runner, each
holding this rank's slice of its own pool, and rank 0 relays every worker
call and ship wave.  ``faults=`` takes a
``repro_torch.faults.FaultPlan`` fired on the step counter: arm blackouts,
dropped / duplicated / delayed ship waves and transient dispatch errors
(retried with backoff under a per-arm circuit breaker).  ``load_shed``
drops queued requests whose deadline has passed.  ``jit_cache`` is the
built-call cache a fleet's replicas share (``{arm: dict}``): the replicas
of one arm keep in its dict that arm's model (on a mesh its runner and
paged view), its pinned workers' models and its built calls, so every
bucket is built once fleet-wide and the weights are held once (every
replica draws the same seed, as ``JaxBackend``'s do); on a mesh its
``"params"`` entry is the replicas' one ``params`` dict.  Each replica
keeps its own pools.  Runs on ``cuda`` unless the caller passes
``device="cpu"``; asking for the card where there is none raises (a fleet
device too).
"""
from __future__ import annotations

import functools
import heapq
import time
import zlib
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.decode.cache_store import CacheStore
from repro_torch.decode.scheduler import PagedArmScheduler
from repro_torch.engine.types import (COMPRESSED, LAYER, SEMANTIC, Outcome,
                                      Request, accuracy_for, next_pow2)
from repro_torch.faults import (ARM_BLACKOUT, FaultInjector,
                                TransientDispatchError)
from repro_torch.dist import api as A
from repro_torch.dist import comm
from repro_torch.launch.mesh import MeshShape, wire_device
from repro_torch.models.model import (Model, SemanticModel,
                                      supports_single_step_prefill)
from repro_torch.obs import Histogram, get_tracer, merge_stat_dicts

ARM_MODES = {LAYER: "pipeline", SEMANTIC: "semantic", COMPRESSED: "fsdp"}
#: runner options of an arm on a process-group mesh: no arm splits its
#: weights over 'data' (serving replicas hold them whole there; ZeRO's
#: split would gather every leaf on every call), and the LAYER arm serves
#: a stage a 'model' rank (the stage graph's layout, whole embed and norms
#: on each stage), not the gspmd layout, which gathers embed and head over
#: 'model' on every call
MESH_ARM_KW = {LAYER: dict(schedule="1f1b", zero_data=False),
               SEMANTIC: dict(zero_data=False),
               COMPRESSED: dict(zero_data=False)}
#: the header's ops (rank 0 -> the followers)
OP_STOP, OP_GANG, OP_ARM, OP_COW, OP_PREFILL, OP_DECODE, OP_SHIP = range(7)
#: the header's int64s: (op, arm, a, b, c, worker, replica)
HEADER_LEN = 7
#: the header's worker field: an arm's colocated scheduler, or its
#: disaggregated fleet's prefill or decode worker
COLOCATED, PREFILL, DECODE = range(3)
#: a paged device call's op by the scheduler's kind of call
PAGED_OPS = {"cow": OP_COW, "prefill": OP_PREFILL, "decode": OP_DECODE}
_PAGED_KINDS = {op: kind for kind, op in PAGED_OPS.items()}


def resolve_device(device) -> torch.device:
    """The serving device; raises when CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is "
                           "available; pass device='cpu' to run the plain "
                           "PyTorch path")
    return dev


def recv_header(mesh, group) -> list:
    """Another rank: the next header rank 0 broadcasts."""
    return comm.broadcast_from(
        torch.zeros(HEADER_LEN, dtype=torch.long, device=wire_device(mesh)),
        0, group).tolist()


def _same_device(a: torch.device, b: torch.device) -> bool:
    return a.type == b.type and (a.index or 0) == (b.index or 0)


def mesh_shape(mesh) -> MeshShape:
    """The backend's mesh argument: a ``MeshShape`` (a process-group
    ``Mesh`` too) as it is, a tuple or ``"D,M"`` string as a shape."""
    if isinstance(mesh, MeshShape):
        return mesh
    dims = tuple(int(x) for x in mesh.split(",")) if isinstance(mesh, str) \
        else tuple(int(x) for x in mesh)
    return MeshShape(dims, ("data", "model") if len(dims) == 2
                     else ("pod", "data", "model"))


class TorchBackend:
    def __init__(self, cfg: ArchConfig, *, mesh=(1, 1), cache_len: int = 128,
                 max_batch: int = 8, seed: int = 0,
                 arms=(LAYER, SEMANTIC), decode: str = "auto",
                 scan_tokens: int = 8, block_size: int = 16,
                 num_blocks: Optional[int] = None,
                 prefill_chunk: int = 32, prefix_sharing: bool = True,
                 watermark: float = 0.0, kv_dtype: str = "f32",
                 weight_quant: Optional[str] = None,
                 fleet: Optional[str] = None, fleet_devices=None,
                 ship_timeout_s: float = 30.0, faults=None,
                 max_retries: int = 3, breaker_cooldown: int = 8,
                 max_ship_retries: Optional[int] = None,
                 load_shed: bool = False, jit_cache: Optional[dict] = None,
                 replica: int = 0, device="cuda"):
        if decode not in ("auto", "paged", "legacy"):
            raise ValueError(f"decode={decode!r}; expected auto|paged|legacy")
        if fleet not in (None, "disagg"):
            raise ValueError(f"fleet={fleet!r}; expected None|'disagg'")
        self.mesh = mesh_shape(mesh)
        #: the process-group mesh the arms' runners serve on, or None
        self.ranks = self.mesh if self.mesh.distributed else None
        if self.ranks is not None and fleet_devices and not all(
                isinstance(r, (int, np.integer)) and not isinstance(r, bool)
                and 0 <= r < self.ranks.size for r in fleet_devices):
            raise ValueError(
                f"fleet_devices={tuple(fleet_devices)!r} on a process-group "
                "mesh: each entry is a rank of the world, an int in [0, "
                f"{self.ranks.size})")
        if fleet is not None and decode == "legacy":
            raise ValueError("fleet='disagg' needs the paged decode path")
        if kv_dtype not in ("f32", "int8"):
            raise ValueError(f"kv_dtype={kv_dtype!r}; expected f32|int8")
        if weight_quant not in (None, "int8", "int4"):
            raise ValueError(f"weight_quant={weight_quant!r}; "
                             "expected None|int8|int4")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.runners: Dict[int, object] = {}
        # on a mesh a fleet's replicas share one params dict (the views
        # read it), so weights loaded through one replica load them all
        self.params: Dict[int, object] = jit_cache.setdefault("params", {}) \
            if jit_cache is not None and self.ranks is not None else {}
        #: this backend's index among a fleet's replicas (the header's
        #: replica field)
        self.replica = replica
        self.headers_sent = 0
        self._digest = 0          # CRC-32 of the gang batches' tokens
        self._built_all = False   # past __init__: later arms are announced
        # fleet device pool (ranks on a mesh), taken (prefill, decode) per
        # arm in _ensure_arm order; an exhausted pool colocates on the
        # backend's device (on a mesh, on the runner's view)
        self._fleet_pool = [int(r) for r in fleet_devices or ()] \
            if self.ranks is not None else \
            [resolve_device(d) for d in fleet_devices or ()]
        self._pins: Dict[int, tuple] = {}   # arm -> (prefill, decode) rank
        self._copies: Dict[tuple, object] = {}    # (arm, device) -> model
        self.cache_len = cache_len
        self.max_batch = max_batch
        self.decode = decode
        self.seed = seed
        self.scan_tokens = scan_tokens
        self.block_size = min(block_size, cache_len)
        self.num_blocks = num_blocks
        self.prefill_chunk = prefill_chunk
        self.prefix_sharing = prefix_sharing
        self.watermark = watermark
        self.kv_dtype = kv_dtype
        self.weight_quant = weight_quant
        self.fleet = fleet
        self.ship_timeout_s = ship_timeout_s
        self._jit_cache = jit_cache
        # --- fault plane -------------------------------------------------
        # the fault clock is the STEP COUNTER, not wall time: a seeded plan
        # fires at the same points of the request stream on every run
        self._injector = FaultInjector(faults) if faults is not None else None
        self._fault_step = 0
        self.max_retries = max_retries
        self.breaker_cooldown = breaker_cooldown
        self.max_ship_retries = max_ship_retries
        self.load_shed = load_shed
        self._blackout: Dict[int, int] = {}       # arm -> step it re-opens
        self._breaker: Dict[int, int] = {}        # arm -> step it re-closes
        self._backoff: Dict[tuple, int] = {}      # (arm, site) -> retry step
        self._consec_err: Dict[tuple, int] = {}
        self.dispatch_retries = 0
        self.breaker_trips = 0
        self.shed_count = 0
        self._failures: List[Outcome] = []        # retry budget exhausted
        self.models: Dict[int, object] = {}
        self._paged: Dict[int, PagedArmScheduler] = {}
        self._disagg: Dict[int, tuple] = {}   # arm -> (pf, dc, CacheStore)
        self._ttfts: List[float] = []
        # (abs_deadline, seq, enqueue_t, request) heaps per arm
        self._queues: Dict[int, list] = {}
        self._seq = 0
        self._t0 = time.perf_counter()
        # the gang path's instrumentation
        self._legacy_prefills = 0
        self.decode_steps = 0                 # gang-path decode calls
        self.batches = 0                      # gang batches
        self._legacy_buckets: Dict[tuple, int] = {}   # (arm, b, plen) -> n
        # gang occupancy: useful decode tokens / (padded lanes x steps)
        self._legacy_useful = 0
        self._legacy_lane_steps = 0
        for arm in arms:
            self._ensure_arm(arm)
        self._built_all = True

    def _ensure_arm(self, arm: int) -> None:
        """Build the model, weights and scheduler of a split arm on first
        use — any policy decision (incl. COMPRESSED) is servable."""
        if arm in self.models:
            return
        if arm not in ARM_MODES:
            raise ValueError(f"unknown split decision {arm!r}; expected one "
                             f"of {sorted(ARM_MODES)}")
        paged_ok = supports_single_step_prefill(self.cfg)
        # reject before registering: a half-registered arm would let a
        # retried submit fall through to the gang path silently
        if self.decode == "paged" and not paged_ok:
            raise ValueError(
                f"decode='paged' but arm {arm} (mode {ARM_MODES[arm]}) has "
                "recurrent mixers; use decode='auto' for a legacy fallback")
        if self.fleet is not None and not paged_ok:
            raise ValueError(
                f"fleet='disagg' but arm {arm} (mode {ARM_MODES[arm]}) has "
                "recurrent mixers — block shipping needs the paged path")
        shared = self._jit_cache.setdefault(arm, {}) \
            if self._jit_cache is not None else None
        pins = None
        if self.fleet == "disagg" and len(self._fleet_pool) >= 2:
            pins = tuple(self._fleet_pool[:2])
            del self._fleet_pool[:2]
        if self.ranks is not None:
            if self.ranks.rank == 0 and self._built_all:
                # the followers build it with this rank, in the same order
                self._send_header(OP_ARM, arm, 0, 0, 0)
            # an arm pinned to ranks serves on no runner
            model = None if pins is not None else \
                self._ensure_runner(arm, shared)
        else:
            model = shared.get("model") if shared is not None else None
            if model is None:
                model = self._draw_model(arm, self.device)
                if shared is not None:
                    shared["model"] = model
            self.models[arm] = model
        self._queues[arm] = []
        if self.decode == "legacy" or not paged_ok:
            return                            # the gang path: no scheduler
        kw = dict(n_lanes=self.max_batch, cache_len=self.cache_len,
                  block_size=self.block_size, num_blocks=self.num_blocks,
                  scan_tokens=self.scan_tokens,
                  prefill_chunk=self.prefill_chunk,
                  prefix_sharing=self.prefix_sharing,
                  watermark=self.watermark, kv_dtype=self.kv_dtype,
                  weight_quant=self.weight_quant, clock=lambda: self.now,
                  jit_cache=shared)
        label = f"arm{arm}:{ARM_MODES[arm]}"
        lead = self.ranks is not None and self.ranks.rank == 0
        if self.fleet == "disagg":
            pinned = None
            if self.ranks is None:
                pf_dev, dc_dev = pins or (self.device, self.device)
                pf = PagedArmScheduler(self._model_on(arm, model, pf_dev),
                                       role="prefill", **self._worker_kw(
                                           kw, shared, pf_dev))
                dc = PagedArmScheduler(self._model_on(arm, model, dc_dev),
                                       role="decode", **self._worker_kw(
                                           kw, shared, dc_dev))
            elif pins is None:
                # both workers over the runner's view, each holding this
                # rank's slice of its own pool
                pf = PagedArmScheduler(model, role="prefill", **kw)
                dc = PagedArmScheduler(model, role="decode", **kw)
            else:
                # each worker pinned whole to its rank
                pinned = self._pins[arm] = pins
                pf, dc = (PagedArmScheduler(
                    self._pinned(arm, r, shared), role=role,
                    **dict(kw, jit_cache=None if shared is None else
                           shared.setdefault(("calls", f"rank{r}"), {})))
                    for role, r in zip(("prefill", "decode"), pins))
                self.models[arm] = pf.model
                for w, r in zip((pf, dc), pins):
                    if r == self.ranks.rank != 0:
                        w.answer = self._answer
            store = CacheStore(
                pf, dc, timeout_s=self.ship_timeout_s,
                on_requeue=lambda lane, a=arm: self._requeue(a, lane),
                max_ship_retries=self.max_ship_retries,
                on_fail=lambda lane, a=arm: self._fail(a, lane),
                injector=self._injector, pinned=pinned, mesh=self.ranks,
                group=None if pinned is None else self._world)
            # trace tracks: one process row per arm, the prefill / ship /
            # decode workers as its threads
            pf.track = (label, pf.track[1])
            dc.track = (label, dc.track[1])
            store.track = (label, "ship")
            if lead:
                pf.relay = functools.partial(self._relay, arm,
                                             worker=PREFILL)
                dc.relay = functools.partial(self._relay, arm, worker=DECODE)
                store.relay = functools.partial(self._relay_ship, arm)
            self._disagg[arm] = (pf, dc, store)
        else:
            sched = PagedArmScheduler(model, **kw)
            sched.track = (label, sched.track[1])
            if lead:
                sched.relay = functools.partial(self._relay, arm)
            self._paged[arm] = sched

    def _draw_model(self, arm: int, device):
        """The arm's whole model on ``device``: LAYER and COMPRESSED
        ``Model(cfg)``, SEMANTIC ``SemanticModel(cfg.semantic(n))`` with
        the mesh's branch count, drawn from the seed every arm draws (as
        ``JaxBackend``'s init); on the meta device, shapes only."""
        n_b = max(2, self.mesh.axis_size("model"))
        model = SemanticModel(self.cfg.semantic(n_b), device=device) \
            if arm == SEMANTIC else Model(self.cfg, device=device)
        if torch.device(device).type != "meta":
            gen = torch.Generator(device=device).manual_seed(self.seed + 1)
            model.reset_parameters(gen)
        return model

    def _pinned(self, arm: int, rank: int, shared):
        """A disaggregated worker's model pinned to ``rank``: on that rank
        the arm's whole model, elsewhere a ``RemoteView`` of it; made once
        per arm and rank (fleet-wide, in ``shared``)."""
        cache = shared if shared is not None else self._copies
        key = (arm, "rank", rank)
        if key not in cache:
            if rank == self.ranks.rank:
                model = self._draw_model(arm, self.device)
                model.join = A.PinnedJoin(rank, self.ranks, self._world)
            else:
                model = A.RemoteView(self._draw_model(arm, "meta"), rank,
                                     self.ranks, self._world)
            cache[key] = model
        return cache[key]

    def _ensure_runner(self, arm: int, shared):
        """An arm on the process-group mesh: its runner and this rank's
        slice of the weights (every rank draws the one-process backend's
        seed; ``runner.init`` keeps the slice ``param_specs`` assigns), made
        once fleet-wide (in ``shared``).  Returns the runner's paged view,
        which reads ``params[arm]`` at every call (a caller may load other
        weights into it)."""
        if shared is not None and "runner" in shared:
            runner, view = shared["runner"], shared["view"]
        else:
            runner = A.build_runner(self.cfg, ARM_MODES[arm], self.ranks,
                                    device=self.device, **MESH_ARM_KW[arm])
            self.params[arm] = runner.init(seed=self.seed + 1)
            view = runner.paged_model(lambda: self.params[arm])
            if shared is not None:
                shared.update(runner=runner, view=view)
        self.runners[arm] = runner
        self.models[arm] = runner.model
        return view

    def _model_on(self, arm: int, model, dev: torch.device):
        """The arm's model on ``dev``: itself on the backend's device, else
        a copy of it and its weights, made once per (arm, device)."""
        if _same_device(dev, self.device):
            return model
        key = (arm, str(dev))
        if key not in self._copies:
            copy = type(model)(model.cfg, device=dev)
            copy.load_state_dict(model.state_dict())
            self._copies[key] = copy
        return self._copies[key]

    def _worker_kw(self, kw: dict, shared, dev: torch.device) -> dict:
        """Scheduler kwargs for a worker on ``dev``: built calls close over
        their model's weights, so a worker on another device keeps its own
        built-call cache (in the fleet's shared dict under the device)."""
        if _same_device(dev, self.device):
            return kw
        calls = None if shared is None else \
            shared.setdefault(("calls", str(dev)), {})
        return dict(kw, jit_cache=calls)

    # ------------------------------------------------------------- lifecycle
    @property
    def now(self) -> float:
        return time.perf_counter() - self._t0

    def _all_scheds(self):
        yield from self._paged.values()
        for pf, dc, _ in self._disagg.values():
            yield pf
            yield dc

    def pending(self) -> int:
        queued = sum(len(q) for q in self._queues.values())
        in_flight = sum(s.backlog for s in self._all_scheds())
        in_flight += sum(st.backlog for _, _, st in self._disagg.values())
        return queued + in_flight

    def submit(self, req: Request) -> None:
        self._ensure_arm(req.decision)
        if req.decision in self._paged:
            self._paged[req.decision].validate(req)
        elif req.decision in self._disagg:
            pf, dc, _ = self._disagg[req.decision]
            pf.validate(req)      # the prompt must fit the prefill worker
            dc.validate(req)      # ... and prompt + decode the decode worker
        enq = self.now
        deadline = (req.arrival_s if req.arrival_s is not None else enq) \
            + req.sla_s
        heapq.heappush(self._queues[req.decision],
                       (deadline, self._seq, enq, req))
        self._seq += 1
        get_tracer().instant("place", req=req.rid, arm=req.decision,
                             mode=ARM_MODES[req.decision])

    def _requeue(self, arm: int, lane) -> None:
        """A timed-out, aborted or evicted shipment's request goes back onto
        the arm queue for a fresh prefill (which hits the prefill worker's
        prefix cache)."""
        heapq.heappush(self._queues[arm],
                       (lane.deadline, self._seq, lane.enq, lane.req))
        self._seq += 1

    def _fail(self, arm: int, lane) -> None:
        """Terminal failure (ship retry budget exhausted): the request
        leaves with a failed Outcome, never a silent hang."""
        req = lane.req
        now = self.now
        self._failures.append(Outcome(
            request=req, decision=arm, latency_s=now - lane.enq,
            queue_wait_s=now - lane.enq, accuracy=0.0, finish_s=now,
            failed=True))
        get_tracer().instant("request_failed", req=req.rid, arm=arm)

    def _take_failures(self) -> List[Outcome]:
        out, self._failures = self._failures, []
        return out

    # ----------------------------------------------------------- fault plane
    def _arm_available(self, arm: int) -> bool:
        return self._blackout.get(arm, 0) <= self._fault_step \
            and self._breaker.get(arm, 0) <= self._fault_step

    def _apply_faults(self) -> None:
        """Fire the plan's due faults on the step-counter clock.  Only arm
        blackouts act here (ship and dispatch faults are charge pools the
        hot paths drain; host faults belong to a simulator)."""
        tr = get_tracer()
        for f in self._injector.advance(self._fault_step):
            if f.kind != ARM_BLACKOUT:
                continue
            targets = [f.target] if f.target >= 0 else list(self.models)
            for arm in targets:
                if arm not in self.models:
                    continue
                self._blackout[arm] = self._fault_step \
                    + max(int(f.duration), 1)
                tr.instant("fault_injected", kind=ARM_BLACKOUT, arm=arm,
                           until_step=self._blackout[arm])
                self._black_out_arm(arm)

    def _black_out_arm(self, arm: int) -> None:
        """The arm's pool is gone for the window: colocated lanes spill
        through the preempt/resume path; a disagg fleet spills its prefill
        lanes, fails every in-flight shipment and resets seated decode
        lanes for re-execution."""
        now = self.now
        if arm in self._paged:
            self._paged[arm].spill_all(now, fault_t=now)
        elif arm in self._disagg:
            pf, dc, store = self._disagg[arm]
            pf.spill_all(now, fault_t=now)
            store.abort_inflight(now)
            for lane in dc.evacuate(now, fault_t=now):
                self._requeue(arm, lane)

    def _dispatch_ok(self, arm: int, site: str) -> bool:
        """Gate one prefill/decode dispatch.  An injected transient error
        is raised before any pool state changes and absorbed here: the
        retry is the next step's attempt, backed off exponentially; more
        than ``max_retries`` consecutive errors trip the arm's circuit
        breaker for ``breaker_cooldown`` steps."""
        key = (arm, site)
        if self._backoff.get(key, 0) > self._fault_step:
            return False
        try:
            if self._injector is not None and \
                    self._injector.take_dispatch_error(arm, site):
                raise TransientDispatchError(f"arm {arm} {site} dispatch")
        except TransientDispatchError:
            tr = get_tracer()
            tr.instant("fault_injected", kind="dispatch_error", arm=arm,
                       site=site)
            n = self._consec_err.get(key, 0) + 1
            self._consec_err[key] = n
            if n > self.max_retries:
                self._breaker[arm] = self._fault_step + self.breaker_cooldown
                self._consec_err[key] = 0
                self.breaker_trips += 1
                tr.instant("breaker_open", arm=arm,
                           until_step=self._breaker[arm])
            else:
                self.dispatch_retries += 1
                self._backoff[key] = self._fault_step + 2 ** (n - 1)
            return False
        self._consec_err[key] = 0
        return True

    def _shed_expired(self) -> List[Outcome]:
        """Deadline-aware load shedding: queued requests whose deadline
        has passed leave with a ``shed`` Outcome.  Only queued (never
        in-flight) work sheds, and only past-deadline work."""
        now = self.now
        tr = get_tracer()
        outs: List[Outcome] = []
        for arm, q in self._queues.items():
            while q and q[0][0] <= now:
                _, _, enq, req = heapq.heappop(q)
                base = req.arrival_s if req.arrival_s is not None else enq
                outs.append(Outcome(
                    request=req, decision=arm, latency_s=now - base,
                    queue_wait_s=now - base, accuracy=0.0, finish_s=now,
                    shed=True))
                self.shed_count += 1
                tr.instant("shed", req=req.rid, arm=arm)
        return outs

    # --------------------------------------------------------------- serving
    def _arm_urgency(self, arm: int) -> Optional[float]:
        """Earliest deadline this arm owes: queue head, in-flight lane or
        shipment."""
        cand = []
        if self._queues[arm]:
            cand.append(self._queues[arm][0][0])
        owing = (self._paged[arm],) if arm in self._paged \
            else self._disagg.get(arm, ())
        for d in (o.earliest_deadline() for o in owing):
            if d is not None:
                cand.append(d)
        return min(cand) if cand else None

    def _pick_arm(self) -> Optional[int]:
        live = [(u, arm) for arm in self._queues
                if self._arm_available(arm)
                and (u := self._arm_urgency(arm)) is not None]
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
        """Batched prefill calls: gang-path prefills + chunked-prefill calls
        across the arms and workers."""
        return self._legacy_prefills + sum(s.prefill_chunks
                                           for s in self._all_scheds())

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
        done = sched.prefill_step(self.now) \
            if self._dispatch_ok(arm, "prefill") else []
        prefill_finish = self.now
        outcomes = [self._lane_outcome(lane, arm, prefill_finish)
                    for lane in done]
        retired = sched.dispatch(self.now) \
            if self._dispatch_ok(arm, "decode") else []
        finish = self.now
        outcomes += [self._lane_outcome(lane, arm, finish)
                     for lane in retired]
        return outcomes

    def _step_disagg(self, arm: int) -> List[Outcome]:
        """One step of the arm's prefill -> decode fleet: the prefill worker
        seats queued requests and commits one chunk wave; the decode call
        is enqueued; the ship-ready lanes go through the cache store
        (receiver blocks, one gather/scatter, the ledger) and completed
        arrivals seat into free decode lanes while that call runs; then
        its results are read.  The ship's scatter is enqueued after the
        decode call on the same stream, so a lane evicted by backpressure
        mid-call has its reused blocks rewritten after its last write, and
        ``finish_dispatch`` skips its row."""
        pf, dc, store = self._disagg[arm]
        pf.try_join(self._queues[arm], self.now)
        done = pf.prefill_step(self.now) \
            if self._dispatch_ok(arm, "prefill") else []
        prefill_finish = self.now
        # max_new == 1 retires at the prefill worker: nothing to ship
        outcomes = [self._lane_outcome(lane, arm, prefill_finish)
                    for lane in done]
        pending = dc.dispatch_async(self.now) \
            if self._dispatch_ok(arm, "decode") else None
        t0 = self.now
        store.ship(pf.take_ready(), self.now)
        store.poll(self.now)
        t1 = self.now
        retired = dc.finish_dispatch(pending, self.now)
        finish = self.now
        if pending is not None:
            # hidden: ship/poll host work done while the decode call was in
            # flight; exposed: the blocking read of its results
            store.note_overlap(t1 - t0, finish - t1)
        outcomes += [self._lane_outcome(lane, arm, finish)
                     for lane in retired]
        return outcomes

    # ---------------------------------------------------- legacy gang path
    def _form_batch(self, arm: int) -> list:
        """Pop up to max_batch most urgent requests from the arm's heap."""
        q = self._queues[arm]
        return [heapq.heappop(q) for _ in range(min(self.max_batch, len(q)))]

    def _generate(self, arm: int, batch_tokens: np.ndarray,
                  max_new: int) -> np.ndarray:
        """One gang batch on the arm: on a process-group mesh, the header
        and the tokens broadcast to the followers first."""
        b, plen = batch_tokens.shape
        key = (arm, b, plen)
        self._legacy_buckets[key] = self._legacy_buckets.get(key, 0) + 1
        toks = torch.from_numpy(batch_tokens).to(self.device)
        if self.ranks is not None:
            self._send_header(OP_GANG, arm, b, plen, max_new)
            toks = comm.broadcast_from(toks, 0, self._world)
        return self._run_gang(arm, toks, max_new)

    def _gang_calls(self, arm: int):
        """(batch-prefill support, init_cache(b), prefill(cache, tokens),
        step(cache, tok [B, 1], i)) of an arm: its model's calls on one
        device, its runner's serving surface on a mesh; both calls return
        ([B, vocab] logits, cache)."""
        if self.ranks is None:
            m = self.models[arm]

            def step(cache, tok, i):
                logits, cache = m.decode_step(None, cache, tok, i,
                                              batch={"tokens": tok})
                return logits[:, -1], cache
            return (m.supports_single_step_prefill,
                    lambda b: m.init_cache(b, self.cache_len),
                    lambda cache, toks: m.prefill_cache(None, cache, toks),
                    step)
        r, p = self.runners[arm], self.params[arm]
        return (r.supports_batched_prefill,
                lambda b: r.init_cache(b, self.cache_len),
                lambda cache, toks: r.prefill_into_cache(p, cache, toks),
                lambda cache, tok, i: r.serve_step(p, cache, {"tokens": tok},
                                                   i))

    def _run_gang(self, arm: int, toks: torch.Tensor,
                  max_new: int) -> np.ndarray:
        """One prefill (a whole-prompt call, or a per-token decode loop for
        models without single-step prefill) and ``max_new - 1`` decode
        steps on a fresh dense cache; greedy tokens stay on the device
        until the batch's one read."""
        batched, init_cache, prefill, step = self._gang_calls(arm)
        b, plen = toks.shape
        tr = get_tracer()
        cache = init_cache(b)
        with tr.span("legacy_prefill", arm=arm, b=b, plen=plen):
            if batched:
                logits, cache = prefill(cache, toks)
                self._legacy_prefills += 1
            else:
                for i in range(plen):
                    logits, cache = step(cache, toks[:, i:i + 1], i)
                    self.decode_steps += 1
        tok = logits.argmax(-1)[:, None].int()
        out = [tok]
        with tr.span("legacy_decode", arm=arm, b=b, steps=max_new - 1):
            for i in range(plen, plen + max_new - 1):
                logits, cache = step(cache, tok, i)
                self.decode_steps += 1
                tok = logits.argmax(-1)[:, None].int()
                out.append(tok)
            out = torch.cat(out, dim=1).cpu().numpy().astype(np.int32)
        if self.ranks is not None:
            self._digest = zlib.crc32(out.tobytes(), self._digest)
        return out

    # -------------------------------------------- the followers (a mesh)
    @property
    def _world(self):
        import torch.distributed as dist
        return dist.group.WORLD

    @property
    def _wire(self) -> torch.device:
        """The device of the headers and host arrays rank 0 sends."""
        return wire_device(self.ranks)

    def _send_header(self, op: int, arm: int, a: int, b: int, c: int,
                     worker: int = COLOCATED) -> None:
        """Seven int64s (op, arm, three numbers, the worker, this
        replica) to the followers."""
        comm.broadcast_from(torch.tensor(
            (op, arm, a, b, c, worker, self.replica), dtype=torch.long,
            device=self._wire), 0, self._world)
        self.headers_sent += 1

    def _answer(self, out: torch.Tensor) -> None:
        """A worker pinned to this rank (not 0) has replayed a call: the
        outputs rank 0 reads go back to it."""
        comm.send_to(out.to(self._wire), 0, self._world)

    def _relay(self, arm: int, kind: str, key: tuple, wire: np.ndarray,
               worker: int = COLOCATED) -> None:
        """Rank 0's scheduler (the arm's ``worker``) is about to make a
        paged device call: the header (op, arm, the bucket, the wire
        matrix's width, the worker) and the matrix go to the followers."""
        self._send_header(PAGED_OPS[kind], arm, key[0],
                          key[1] if len(key) > 1 else 0, wire.shape[1],
                          worker)
        comm.broadcast_from(torch.from_numpy(wire).to(self._wire), 0,
                            self._world)

    def _relay_ship(self, arm: int, wire: np.ndarray) -> None:
        """Rank 0's cache store is about to ship a wave: the header and the
        wave's [n_pad, 2] (source, destination) block ids go to the
        followers."""
        self._send_header(OP_SHIP, arm, wire.shape[0], 0, wire.shape[1])
        comm.broadcast_from(torch.from_numpy(wire).to(self._wire), 0,
                            self._world)

    def _worker_of(self, arm: int, worker: int) -> PagedArmScheduler:
        """The scheduler a header addresses; raises for one this rank does
        not hold."""
        if worker == COLOCATED and arm in self._paged:
            return self._paged[arm]
        if worker in (PREFILL, DECODE) and arm in self._disagg:
            return self._disagg[arm][worker - PREFILL]
        raise ValueError(f"a header addresses worker {worker} of arm {arm}, "
                         "which this rank does not hold")

    def stream_digest_for(self, rank: int) -> int:
        """CRC-32 of the gang batches' tokens, then of the ``token_digest``
        (prefill and decode tokens) of each colocated paged arm in arm
        order, then of each disaggregated arm's prefill and decode worker,
        in arm order: the workers whose tokens ``rank`` reads (rank 0
        every worker's; another rank those it holds a slice of or is
        pinned to).  Equal on rank 0 and on ``rank``."""
        d = self._digest
        digests = [self._paged[a].token_digest for a in sorted(self._paged)]
        for a in sorted(self._disagg):
            pins = self._pins.get(a)
            digests += [w.token_digest for i, w in
                        enumerate(self._disagg[a][:2])
                        if rank == 0 or pins is None or pins[i] == rank]
        for t in digests:
            d = zlib.crc32(t.to_bytes(4, "little"), d)
        return d

    @property
    def stream_digest(self) -> int:
        """:meth:`stream_digest_for` this rank (every worker's tokens in
        one process and on rank 0)."""
        return self.stream_digest_for(
            self.ranks.rank if self.ranks is not None else 0)

    def follow(self) -> dict:
        """A rank other than 0 of a process-group mesh: make every call
        rank 0 announces (gang batches through the runners, paged calls on
        this rank's pools, ship waves, arms built), until rank 0's
        :meth:`close`.  Returns :meth:`follow_counts`, which equal rank
        0's ``extra_metrics()`` (the stream CRC its
        ``stream_digest_for(rank)``)."""
        if self.ranks is None or self.ranks.rank == 0:
            raise ValueError("follow() runs on the ranks other than 0 of a "
                             "process-group mesh")
        while True:
            op, arm, a, b, c, worker, replica = recv_header(self.ranks,
                                                            self._world)
            if op == OP_STOP:
                break
            if replica != self.replica:
                raise ValueError(f"a header addresses replica {replica}; "
                                 f"this backend is replica {self.replica}")
            self.replay(op, arm, a, b, c, worker)
        return self.follow_counts()

    def replay(self, op: int, arm: int, a: int, b: int, c: int,
               worker: int) -> None:
        """One header rank 0 sent this backend, and what follows it: an
        arm built, or the announced call made on this rank's pools (a
        worker pinned to another rank drops it).  A header naming an arm,
        a worker or an op this rank does not hold raises."""
        if op == OP_ARM:
            self._ensure_arm(arm)
            return
        if arm not in self.models:
            raise ValueError(f"a header addresses arm {arm}, which this "
                             "rank has not built")
        if op in _PAGED_KINDS:
            sched = self._worker_of(arm, worker)
            wire = comm.broadcast_from(
                torch.zeros((a, c), dtype=torch.int32, device=self._wire),
                0, self._world)
            sched.replay(_PAGED_KINDS[op], (a,) if op == OP_COW else (a, b),
                         wire.cpu().numpy())
        elif op == OP_SHIP:
            if arm not in self._disagg:
                raise ValueError(f"a ship wave of arm {arm}, which this "
                                 "rank holds no cache store of")
            wire = comm.broadcast_from(
                torch.zeros((a, c), dtype=torch.int32, device=self._wire), 0,
                self._world)
            self._disagg[arm][2].replay_ship(wire.cpu().numpy())
        elif op == OP_GANG:
            if arm not in self.runners:
                raise ValueError(f"a gang batch of arm {arm}, which this "
                                 "rank holds no runner of")
            toks = comm.broadcast_from(
                torch.zeros((a, b), dtype=torch.int32, device=self.device),
                0, self._world)
            self._run_gang(arm, toks, c)
            self.batches += 1
        else:
            raise ValueError(f"a header of unknown op {op}")

    def follow_counts(self) -> dict:
        """This rank's counts (batches, prefill calls, decode steps; paged
        prefill chunks, decode dispatches and COW copies over every
        scheduler, disaggregated and pinned workers included, a worker
        held elsewhere counting the calls it dropped; with a disaggregated
        arm, ship waves and blocks shipped) and its ``stream_digest``."""
        scheds = list(self._all_scheds())
        out = {"batches": self.batches, "prefill_calls": self.prefill_calls,
               "decode_steps": self.decode_steps,
               **{k: sum(getattr(s, k) for s in scheds)
                  for k in ("prefill_chunks", "decode_dispatches",
                            "cow_copies")}}
        if self._disagg:
            out.update({k: sum(getattr(st, k) for _, _, st in
                               self._disagg.values())
                        for k in ("ship_waves", "blocks_shipped")})
        return dict(out, stream_digest=self.stream_digest)

    def close(self) -> None:
        """Rank 0 of a process-group mesh: send the followers the stop
        header (call it in a ``finally``, so a failure on rank 0 never
        leaves them waiting out the group's timeout).  Elsewhere a
        no-op."""
        if self.ranks is not None and self.ranks.rank == 0:
            self._send_header(OP_STOP, 0, 0, 0, 0)

    def _step_legacy(self, arm: int) -> List[Outcome]:
        picked = self._form_batch(arm)
        if not picked:
            return []
        exec_start = self.now
        reqs = [p[3] for p in picked]
        enqs = [p[2] for p in picked]
        max_new = max(r.max_new for r in reqs)
        # the sequence pads only to the batch's longest prompt, whose last
        # token the prefill's last position is (shorter requests keep the
        # teacher-forced-pad semantics of a shared cache index); the batch
        # pads to a power of two to bound the buckets
        plen = max(len(r.tokens) for r in reqs)
        b = next_pow2(len(reqs))
        toks = np.zeros((b, plen), np.int32)
        for i, r in enumerate(reqs):
            toks[i, :len(r.tokens)] = r.tokens
        out = self._generate(arm, toks, max_new)
        finish = self.now
        self.batches += 1
        # gang occupancy: every lane decodes to the batch's longest request
        self._legacy_useful += sum(r.max_new - 1 for r in reqs)
        self._legacy_lane_steps += b * (max_new - 1)
        return [self._outcome(r, arm, enq, exec_start, out[i, :r.max_new],
                              finish)
                for i, (r, enq) in enumerate(zip(reqs, enqs))]

    def step(self, policy=None) -> List[Outcome]:
        # the fault clock ticks on every step, idle ones included, so
        # blackout windows and breaker cooldowns close under drain
        self._fault_step += 1
        pre: List[Outcome] = []
        if self._injector is not None:
            self._apply_faults()
        if self.load_shed:
            pre = self._shed_expired()
        arm = self._pick_arm()
        if arm is None:
            return pre + self._take_failures()
        with get_tracer().span("step", arm=arm) as sp:
            if arm in self._disagg:
                out = self._step_disagg(arm)
            elif arm in self._paged:
                out = self._step_paged(arm)
            else:
                out = self._step_legacy(arm)
            sp.set(retired=len(out))
        return pre + out + self._take_failures()

    # --------------------------------------------------------------- metrics
    def extra_metrics(self) -> dict:
        m = {"batches": self.batches, "prefill_calls": self.prefill_calls,
             "decode_steps": self.decode_steps}
        if self.ranks is not None:
            m.update(mesh=list(self.ranks.dims), rank=self.ranks.rank,
                     headers_sent=self.headers_sent,
                     stream_digest=self.stream_digest)
        if self._legacy_buckets:
            calls = sum(self._legacy_buckets.values())
            m["prefill_bucket_misses"] = len(self._legacy_buckets)
            m["prefill_bucket_hits"] = calls - len(self._legacy_buckets)
            m["prefill_buckets"] = {
                f"arm{a}:b{b}xs{s}": n
                for (a, b, s), n in sorted(self._legacy_buckets.items())}
        scheds = list(self._all_scheds())
        if scheds:
            # counters sum across arms and workers, per-pool gauges take
            # the max, and ratios recompute from the merged counters (a
            # disagg fleet's batch_occupancy is its decode lanes')
            m.update(merge_stat_dicts((s.stats() for s in scheds),
                                      kinds=PagedArmScheduler.STAT_KINDS))
        elif self._legacy_lane_steps:
            m["batch_occupancy"] = round(
                self._legacy_useful / self._legacy_lane_steps, 4)
        if self._disagg:
            stores = [st for _, _, st in self._disagg.values()]
            m.update(merge_stat_dicts(s.stats() for s in stores))
            hid = m.get("overlap_hidden_s", 0.0)
            exp = m.get("overlap_exposed_s", 0.0)
            if hid + exp > 0:
                # share of ship + read host time hidden behind the
                # in-flight decode call
                m["ship_overlap_frac"] = round(hid / (hid + exp), 4)
            ship = Histogram()
            for s in stores:
                ship.merge(s.ship_latency)
            if ship.n:
                for q in (50, 95, 99):
                    m[f"ship_latency_p{q}"] = round(ship.percentile(q), 6)
        if self._ttfts:
            m["ttft_s"] = round(float(np.mean(self._ttfts)), 6)
        # fault / recovery plane: injected counts, retries (dispatch
        # backoffs + re-opened shipments), full re-executions (evacuations,
        # evictions + expired-shipment requeues), fault -> re-admission
        # latency across all schedulers
        if self._injector is not None:
            m.update(self._injector.stats())
        m["retries"] = self.dispatch_retries + m.get("ship_retries", 0)
        m["re_executions"] = m.get("re_executions", 0) \
            + m.get("ship_requeues", 0)
        if self.dispatch_retries:
            m["dispatch_retries"] = self.dispatch_retries
        if self.breaker_trips:
            m["breaker_trips"] = self.breaker_trips
        if self.shed_count:
            m["shed"] = self.shed_count
        rec = Histogram()
        for s in scheds:
            rec.merge(s.recovery_latency)
        if rec.n:
            for q in (50, 95, 99):
                m[f"recovery_latency_p{q}"] = round(rec.percentile(q), 6)
        return m
