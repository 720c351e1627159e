"""Pipeline execution for the paper's LAYER split (``repro.dist.pipeline``),
on one device or one stage a rank.

1. **Microbatch streaming** (``schedule="gspmd"``): the batch is cut into M
   microbatches whose mean loss is the step's loss, and whose gradients
   accumulate one microbatch at a time, so only one microbatch's
   activations are alive.

2. **The explicit stage graph** (``schedule="gpipe" | "1f1b"``): a static
   tick table (:class:`Schedule`, built by the reference's list scheduler)
   says which microbatch each stage runs forward (F) or backward (B) at
   each tick and which ring-buffer slot each payload is read from and
   written to.  The executor walks the table's rows in Python.  A stage
   owns a contiguous span of the superblock stack; an F op runs the span
   without autograd and saves the stage's received payload, a B op re-runs
   the span from that saved payload with autograd on (remat-style) and
   pulls the arriving cotangent, or at the last stage the loss's ``1/M``,
   back through it.  Idle cells are skipped.  On one device (a 1 x 1
   mesh, or a ``(data, S)`` shape given to the executor) one process runs
   every stage, and a payload moves by a write into the receiving stage's
   buffers after the tick's reads.  On a mesh each 'model' rank runs its
   stage: the F payload goes downstream and the B cotangent upstream by
   point-to-point sends, where the reference uses ``lax.ppermute``.  Every
   rank derives its sends and receives from the same table, only scheduled
   transfers move (the reference's masked SPMD sends do not), and a tick's
   transfers go in one ``batch_isend_irecv``.  Microbatches split over
   'data'; gradients are averaged over 'data', and the leaves every stage
   holds (embed, final norm, head) summed over 'model'.

3. **Expert parallelism** (``ep_loss``, ``ep_value_and_grad``): the model
   is built with ``expert_parallel_axis="model"``; expert weights are split
   over 'model' and ``models.moe._moe_apply_ep`` exchanges token buffers
   with all-to-alls; everything else is replicated over 'model' and the
   batch splits over 'data'.

Numerics: the dense-model loss is invariant to M and to the schedule up to
float summation order (``tests/test_torch_train.py``,
``tests/test_torch_pipeline.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.dist import comm
from repro_torch.launch import mesh as M
from repro_torch.models.layers import torch_dtype
from repro_torch.models.transformer import tree_map
from repro_torch.optim.adamw import tree_leaves

SCHEDULES = ("gspmd", "gpipe", "1f1b")


def resolve_microbatches(batch_size: int, requested, n_stages: int) -> int:
    """Pick the microbatch count.  An explicit request must divide the batch;
    the default is the stage count clamped to a divisor of the batch."""
    if requested is not None:
        if batch_size % requested:
            raise ValueError(
                f"n_microbatches={requested} does not divide batch "
                f"size {batch_size}")
        return requested
    return math.gcd(batch_size, max(n_stages, 1)) or 1


def split_microbatches(batch, n_micro: int):
    """{name: [B, ...]} -> a list of M batches of [B/M, ...] (views)."""
    out = [dict() for _ in range(n_micro)]
    for k, x in batch.items():
        b = x.shape[0]
        parts = x.reshape((n_micro, b // n_micro) + tuple(x.shape[1:]))
        for i in range(n_micro):
            out[i][k] = parts[i]
    return out


def microbatch_loss(model, params, batch, n_micro: int, *,
                    remat: bool = False, chunk: int = 512, rows=None):
    """Mean per-microbatch loss over M microbatches.  M = 1 is the plain
    full-batch loss.  ``rows``: the split of each microbatch's rows over
    ranks (``models.moe.RowSplit``)."""
    if n_micro <= 1:
        return model.loss_chunked(params, batch, chunk=chunk, remat=remat,
                                  rows=rows)
    total = 0.0
    for mb in split_microbatches(batch, n_micro):
        total = total + model.loss_chunked(params, mb, chunk=chunk,
                                           remat=remat, rows=rows)
    return total / n_micro


def microbatch_value_and_grad(model, params, leaves, batch, n_micro: int, *,
                              remat: bool = False, chunk: int = 512,
                              loss_fn=None):
    """(loss, [grad per leaf]) of :func:`microbatch_loss` (or of
    ``loss_fn(params, microbatch)``) by gradient accumulation: each
    microbatch's backward runs before the next microbatch's forward, and
    adds into the leaves' ``.grad`` in place, so no second tree of
    gradients stands beside the sum.  Each leaf's ``.grad`` is as it was
    on return."""
    if loss_fn is None:
        loss_fn = lambda p, mb: model.loss_chunked(p, mb, chunk=chunk,  # noqa: E731
                                                   remat=remat)
    saved = [p.grad for p in leaves]
    for p in leaves:
        p.grad = None
    total = None
    try:
        for mb in split_microbatches(batch, n_micro):
            loss = loss_fn(params, mb) / n_micro
            torch.autograd.backward(loss, inputs=leaves)
            loss = loss.detach()
            total = loss if total is None else total + loss
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in leaves]
    finally:
        for p, g in zip(leaves, saved):
            p.grad = g
    return total, grads


def mesh_dims(mesh) -> Tuple[int, int]:
    """(data, model) sizes of a mesh or of a ``(data, model)`` shape."""
    if isinstance(mesh, M.MeshShape):
        return mesh.axis_size("data"), mesh.axis_size("model")
    return tuple(int(x) for x in mesh)


def _distributed(mesh) -> bool:
    return isinstance(mesh, M.MeshShape) and mesh.distributed


def split_data(batch, n_micro: int, mesh):
    """This rank's rows of a global batch, microbatch-major: each of the
    ``n_micro`` microbatches' rows split over 'data' (the reference's
    ``P(None, "data")`` on the [M, B/M, ...] reshape)."""
    n_data = mesh.axis_size("data")
    if n_data == 1:
        return batch
    r = mesh.coords["data"]
    out = {}
    for k, x in batch.items():
        B = x.shape[0]
        if B % n_micro or (B // n_micro) % n_data:
            raise ValueError(f"batch {B} must split into n_microbatches="
                             f"{n_micro} x data axis {n_data}")
        bl = B // n_micro // n_data
        parts = x.reshape((n_micro, B // n_micro) + tuple(x.shape[1:]))
        out[k] = parts[:, r * bl:(r + 1) * bl].reshape(
            (n_micro * bl,) + tuple(x.shape[1:]))
    return out


# =========================================================== schedule tables
@dataclasses.dataclass(frozen=True)
class Schedule:
    """Static tick table driving the stage-graph executor.

    All tables are [ticks, n_stages] int32.  ``*_mb`` holds the microbatch
    index whose forward/backward stage ``s`` runs at tick ``t`` (-1: idle);
    the slot tables index the executor's fwd-arrival / saved-input /
    bwd-arrival ring buffers (the last slot of each buffer is a trash slot,
    which the reference's SPMD program writes for idle ops).
    """
    kind: str
    n_stages: int
    n_micro: int
    ticks: int
    f_mb: np.ndarray
    f_read: np.ndarray
    f_save: np.ndarray
    f_wslot: np.ndarray
    b_mb: np.ndarray
    b_slot: np.ndarray
    b_read: np.ndarray
    b_wslot: np.ndarray
    n_fwd_slots: int       # incl. trash
    n_saved_slots: int     # incl. trash
    n_bwd_slots: int       # incl. trash

    @property
    def n_ops(self) -> int:
        return int((self.f_mb >= 0).sum() + (self.b_mb >= 0).sum())

    @property
    def bubble_fraction(self) -> float:
        """Idle fraction of the tick grid: 1 - busy_slots / (ticks * stages)."""
        return 1.0 - self.n_ops / float(self.ticks * self.n_stages)

    @property
    def peak_saved_microbatches(self) -> int:
        """Max in-flight saved stage inputs (the schedule's activation-memory
        knob: M for gpipe, O(S) for 1f1b)."""
        return self.n_saved_slots - 1

    @property
    def n_transfers(self) -> int:
        """Scheduled stage-to-stage payload sends per step."""
        fwd = int((self.f_mb[:, : self.n_stages - 1] >= 0).sum())
        bwd = int((self.b_mb[:, 1:] >= 0).sum())
        return fwd + bwd


def _op_queues(kind: str, S: int, M: int, forward_only: bool,
               memory_budget: Optional[int]):
    if forward_only:
        return [[("F", m) for m in range(M)] for _ in range(S)]
    if kind == "gpipe":
        # Fill-drain.  A memory budget of K < M saved microbatches forces
        # GPipe into ceil(M/K) sequential fill-drain rounds (it must flush
        # before admitting more microbatches than it can save).
        K = M if memory_budget is None else max(1, min(memory_budget, M))
        q = []
        for lo in range(0, M, K):
            mbs = range(lo, min(lo + K, M))
            q += [("F", m) for m in mbs] + [("B", m) for m in reversed(mbs)]
        return [list(q) for _ in range(S)]
    if kind == "1f1b":
        queues = []
        for i in range(S):
            warm = min(M, S - i)
            q = [("F", m) for m in range(warm)]
            nf, nb = warm, 0
            while nb < M:
                q.append(("B", nb))
                nb += 1
                if nf < M:
                    q.append(("F", nf))
                    nf += 1
            queues.append(q)
        return queues
    raise ValueError(f"unknown schedule {kind!r}; expected one of {SCHEDULES}")


def _simulate(queues, S: int):
    """Greedy list-scheduling of the per-stage op queues under the transfer
    constraints (an activation/cotangent sent at the end of tick t is
    consumable from tick t+1).  Returns (events, t_F, t_B) where events[t][s]
    is ('F'|'B', mb) or None."""
    t_F: Dict[Tuple[int, int], int] = {}
    t_B: Dict[Tuple[int, int], int] = {}
    ptr = [0] * S
    total = sum(len(q) for q in queues)
    done, t, events = 0, 0, []
    INF = 1 << 30
    while done < total:
        if t > 16 * (total + S):
            raise RuntimeError(f"schedule deadlock: {queues}")
        row = [None] * S
        for i in range(S):
            if ptr[i] >= len(queues[i]):
                continue
            op, m = queues[i][ptr[i]]
            if op == "F":
                ready = i == 0 or t_F.get((i - 1, m), INF) < t
            else:
                ready = t_F.get((i, m), INF) < t and (
                    i == S - 1 or t_B.get((i + 1, m), INF) < t)
            if ready:
                row[i] = (op, m)
        for i, r in enumerate(row):
            if r is None:
                continue
            op, m = r
            (t_F if op == "F" else t_B)[(i, m)] = t
            ptr[i] += 1
            done += 1
        events.append(row)
        t += 1
    return events, t_F, t_B


def _alloc_slots(intervals):
    """Greedy interval-partitioning.  ``intervals``: [(write_tick, last_read
    _tick, key)]; a slot written at tick w is reusable once its last read
    tick r satisfies w_new >= r (the executor reads all buffers before it
    writes).  Returns ({key: slot}, n_slots)."""
    assign, slot_free_at = {}, []
    for w, r, key in sorted(intervals):
        for j, free_at in enumerate(slot_free_at):
            if free_at <= w:
                assign[key] = j
                slot_free_at[j] = r
                break
        else:
            assign[key] = len(slot_free_at)
            slot_free_at.append(r)
    return assign, len(slot_free_at)


def build_schedule(kind: str, n_stages: int, n_micro: int, *,
                   forward_only: bool = False,
                   memory_budget: Optional[int] = None) -> Schedule:
    """Build the static tick table for one (schedule, S, M) triple.

    ``memory_budget`` (gpipe only) caps the saved in-flight microbatches,
    splitting the flush into fill-drain rounds.  1f1b's peak is structurally
    ~S and ignores the knob.  With both schedules at the same budget K=S,
    1f1b's bubble fraction (S-1)/(M+S-1) beats gpipe's round-multiplied
    (M/K)(S-1) / ((M/K)(S-1) + M); unbounded gpipe matches 1f1b's bubble but
    holds M saved microbatches instead of ~S.
    """
    S, M = n_stages, n_micro
    events, t_F, t_B = _simulate(
        _op_queues(kind, S, M, forward_only, memory_budget), S)
    T = len(events)

    # ---- slot allocation (per stage; buffers are uniform across stages, so
    # they are sized at the max over stages, plus one trash slot).
    fwd_iv = [[] for _ in range(S)]    # (i, m): sent end of t_F(i-1,m), read at t_F(i,m)
    sav_iv = [[] for _ in range(S)]    # (i, m): saved at t_F(i,m), read at t_B(i,m)
    bwd_iv = [[] for _ in range(S)]    # (i, m): sent end of t_B(i+1,m), read at t_B(i,m)
    for (i, m), t in t_F.items():
        if i > 0:
            fwd_iv[i].append((t_F[(i - 1, m)], t, (i, m)))
        if not forward_only:
            sav_iv[i].append((t, t_B[(i, m)], (i, m)))
    for (i, m), t in t_B.items():
        if i < S - 1:
            bwd_iv[i].append((t_B[(i + 1, m)], t, (i, m)))
    fwd_slot, sav_slot, bwd_slot = {}, {}, {}
    n_fwd = n_sav = n_bwd = 0
    for i in range(S):
        a, n = _alloc_slots(fwd_iv[i])
        fwd_slot.update(a)
        n_fwd = max(n_fwd, n)
        a, n = _alloc_slots(sav_iv[i])
        sav_slot.update(a)
        n_sav = max(n_sav, n)
        a, n = _alloc_slots(bwd_iv[i])
        bwd_slot.update(a)
        n_bwd = max(n_bwd, n)
    trash_f, trash_s, trash_b = n_fwd, n_sav, n_bwd

    # ---- tables
    f_mb = np.full((T, S), -1, np.int32)
    b_mb = np.full((T, S), -1, np.int32)
    f_read = np.full((T, S), trash_f, np.int32)
    f_save = np.full((T, S), trash_s, np.int32)
    f_wslot = np.full((T, S), trash_f, np.int32)
    b_slot = np.full((T, S), trash_s, np.int32)
    b_read = np.full((T, S), trash_b, np.int32)
    b_wslot = np.full((T, S), trash_b, np.int32)
    for t, row in enumerate(events):
        for i, r in enumerate(row):
            if r is None:
                continue
            op, m = r
            if op == "F":
                f_mb[t, i] = m
                if i > 0:
                    f_read[t, i] = fwd_slot[(i, m)]
                if not forward_only:
                    f_save[t, i] = sav_slot[(i, m)]
                if i + 1 < S:       # receiver's write slot for this send
                    f_wslot[t, i + 1] = fwd_slot[(i + 1, m)]
            else:
                b_mb[t, i] = m
                b_slot[t, i] = sav_slot[(i, m)]
                if i < S - 1:
                    b_read[t, i] = bwd_slot[(i, m)]
                if i - 1 >= 0:
                    b_wslot[t, i - 1] = bwd_slot[(i - 1, m)]
    return Schedule(kind=kind, n_stages=S, n_micro=M, ticks=T,
                    f_mb=f_mb, f_read=f_read, f_save=f_save, f_wslot=f_wslot,
                    b_mb=b_mb, b_slot=b_slot, b_read=b_read, b_wslot=b_wslot,
                    n_fwd_slots=n_fwd + 1, n_saved_slots=n_sav + 1,
                    n_bwd_slots=n_bwd + 1)


def payload_bytes(cfg, b_local: int, seq: int) -> int:
    """Bytes of one stage-to-stage payload: the activations plus the f32
    running aux loss."""
    return b_local * seq * cfg.d_model * torch_dtype(cfg).itemsize + 4


# ======================================================= stage-graph runtime
def _stage_setup(model, batch, mesh, n_micro: int):
    """Shared validation + microbatch reshape for the stage executors; the
    model axis is the stage count.  On a mesh, this rank's rows of each
    microbatch (split over 'data')."""
    cfg = model.cfg
    if not getattr(model, "supports_stage_split", False):
        raise ValueError(
            f"{cfg.name}: the explicit stage-graph schedules support plain "
            "decoder-only stacks (no enc-dec / modality frontends); use "
            'schedule="gspmd"')
    n_data, S = mesh_dims(mesh)
    if cfg.n_superblocks % max(S, 1):
        raise ValueError(
            f"{cfg.name}: n_superblocks={cfg.n_superblocks} not divisible by "
            f"mesh 'model' size {S}")
    tokens, labels = batch["tokens"], batch["labels"]
    B, s = tokens.shape
    if B % n_micro or (B // n_micro) % n_data:
        raise ValueError(
            f"batch {B} must split into n_microbatches={n_micro} x "
            f"data axis {n_data}")
    mt = tokens.reshape(n_micro, B // n_micro, s)
    ml = labels.reshape(n_micro, B // n_micro, s)
    if _distributed(mesh) and n_data > 1:
        bl, r = B // n_micro // n_data, mesh.coords["data"]
        mt, ml = mt[:, r * bl:(r + 1) * bl], ml[:, r * bl:(r + 1) * bl]
    return S, mt, ml


def _stage_spans(blocks, S: int, mesh):
    """{stage: its contiguous span of the superblock stack} for the stages
    this process runs: every stage's span (views with a leading
    [n_superblocks / S] dim) on one device, this rank's own span (the
    blocks it holds) on a mesh."""
    if _distributed(mesh):
        return {mesh.coords["model"]: blocks}
    n = tree_leaves(blocks)[0].shape[0] // S
    return {i: tree_map(lambda t, i=i: t[i * n:(i + 1) * n], blocks)
            for i in range(S)}


def _pack(payload) -> torch.Tensor:
    """A payload (or its cotangent) as one byte buffer: x, then the f32
    aux."""
    return torch.cat([payload["x"].contiguous().reshape(-1).view(torch.uint8),
                      payload["aux"].float().reshape(1).view(torch.uint8)])


def _unpack(buf: torch.Tensor, like) -> dict:
    nx = like["x"].numel() * like["x"].element_size()
    return {"x": buf[:nx].view(like["x"].dtype).view(like["x"].shape),
            "aux": buf[nx:].view(torch.float32)[0]}


class _Transfers:
    """One tick's stage-to-stage moves: to a stage this process runs, a
    buffer write; to another rank's stage, a send (and the matching receive
    there), all of the tick's in one ``batch_isend_irecv``.  Writes land
    after the tick's reads, since slots are reused at their last read."""

    def __init__(self, mesh, zero):
        self.mesh, self.zero = mesh, zero
        self.writes, self.sends, self.recvs = [], [], []

    def move(self, bufs, dst: int, slot: int, value) -> None:
        if dst in bufs:
            self.writes.append((bufs[dst], slot, value))
        else:
            self.sends.append((_pack(value), dst))

    def expect(self, buf, slot: int, src: int) -> None:
        self.recvs.append((buf, slot, src))

    def finish(self) -> None:
        if self.sends or self.recvs:
            nbytes = _pack(self.zero).numel()
            got = comm.exchange(
                self.sends, [((nbytes,), torch.uint8, src)
                             for _, _, src in self.recvs],
                self.mesh.group("model"), self.zero["x"].device)
            for (buf, slot, _), raw in zip(self.recvs, got):
                self.writes.append((buf, slot, _unpack(raw, self.zero)))
        for buf, slot, value in self.writes:
            buf[slot] = value


def _expect_arrivals(tr, sched, t: int, col: int, S: int, fwd_buf,
                     bwd_buf) -> None:
    """On a mesh: the receives of stage ``col`` at tick ``t`` (an F payload
    from upstream, a B cotangent from downstream), as the table has the
    neighbours send them."""
    if fwd_buf is not None and col > 0 and sched.f_mb[t, col - 1] >= 0:
        tr.expect(fwd_buf[col], sched.f_wslot[t, col], col - 1)
    if bwd_buf is not None and col < S - 1 and sched.b_mb[t, col + 1] >= 0:
        tr.expect(bwd_buf[col], sched.b_wslot[t, col], col + 1)


def _payload_zero(model, mt):
    """The zero payload every buffer slot starts from: [b, s, d]
    activations in the model's dtype and the f32 running aux loss."""
    b, s = mt.shape[1:]
    dev = mt.device
    return {"x": torch.zeros(b, s, model.cfg.d_model,
                             dtype=torch_dtype(model.cfg), device=dev),
            "aux": torch.zeros((), dtype=torch.float32, device=dev)}


def _tick_core(model, params, span, tokens, labels, recv, col: int, S: int,
               remat: bool):
    """One stage's op on one microbatch: embed at stage 0 (else the
    received payload), the stage's span, and at the last stage the head
    loss plus ``0.01 * aux``.  Returns (payload, loss or None)."""
    if col == 0:
        x = model.stage_embed(params, tokens)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    else:
        x, aux = recv["x"], recv["aux"]
    pos = torch.arange(tokens.shape[1], device=x.device)[None, :]
    y, aux_local = model.stage_apply(span, x, positions=pos, remat=remat)
    payload = {"x": y, "aux": aux + aux_local}
    if col != S - 1:
        return payload, None
    return payload, model.stage_head_loss(params, y, labels) \
        + 0.01 * payload["aux"]


def stage_graph_loss(model, params, batch, mesh, *, schedule: str = "gpipe",
                     n_micro: int = 1):
    """Forward-only stage-graph loss: M microbatches through the
    ``forward_only`` table, the last stage's per-microbatch mean losses
    averaged (summed over 'model' and averaged over 'data' on a mesh).  The
    loss value is schedule-independent (and runs without autograd, so remat
    has nothing to change)."""
    S, mt, ml = _stage_setup(model, batch, mesh, n_micro)
    sched = build_schedule(schedule, S, n_micro, forward_only=True)
    spans = _stage_spans(params["blocks"], S, mesh)
    zero = _payload_zero(model, mt)
    fwd_buf = {c: [zero] * sched.n_fwd_slots for c in spans}
    loss = torch.zeros((), dtype=torch.float32, device=mt.device)
    with torch.no_grad():
        for t in range(sched.ticks):
            tr = _Transfers(mesh, zero)
            for col, span in spans.items():
                if _distributed(mesh):
                    _expect_arrivals(tr, sched, t, col, S, fwd_buf, None)
                m = int(sched.f_mb[t, col])
                if m < 0:
                    continue
                payload, loss_m = _tick_core(
                    model, params, span, mt[m], ml[m],
                    fwd_buf[col][sched.f_read[t, col]], col, S, False)
                if loss_m is not None:
                    loss = loss + loss_m / n_micro
                if col + 1 < S:
                    tr.move(fwd_buf, col + 1, sched.f_wslot[t, col + 1],
                            payload)
            tr.finish()
    if _distributed(mesh):
        loss = comm.mean_over_data(
            comm.all_reduce_sum(loss, mesh.group("model")), mesh)
    return loss


def stage_graph_value_and_grad(model, params, batch, mesh, *,
                               schedule: str = "gpipe", n_micro: int = 1,
                               remat: bool = False,
                               memory_budget: Optional[int] = None,
                               specs=None):
    """(loss, [grad per leaf of ``params``]) under an explicit pipeline
    schedule.

    An F op runs without autograd and saves its received payload.  A B op
    re-runs the stage forward from that saved payload with autograd on
    (``remat`` checkpoints each superblock inside it) and pulls back the
    arriving cotangent, or at the last stage ``1/M`` on the loss; the
    parameter gradients accumulate over the ops and the payload's
    cotangent goes to the stage before.  On one device every stage's grads
    land in the one tree, which is the reference's psum over 'model' of the
    leaves replicated there; on a mesh (``params`` this rank's slices,
    ``specs`` their specs) the reduction is explicit: a mean over 'data',
    and a sum over 'model' of the leaves 'model' does not split."""
    S, mt, ml = _stage_setup(model, batch, mesh, n_micro)
    sched = build_schedule(schedule, S, n_micro, memory_budget=memory_budget)
    leaves = tree_leaves(params)
    spans = _stage_spans(params["blocks"], S, mesh)
    zero = _payload_zero(model, mt)
    fwd_buf = {c: [zero] * sched.n_fwd_slots for c in spans}
    sav_buf = {c: [zero] * sched.n_saved_slots for c in spans}
    bwd_buf = {c: [zero] * sched.n_bwd_slots for c in spans}
    grads = [torch.zeros_like(p) for p in leaves]
    loss = torch.zeros((), dtype=torch.float32, device=mt.device)
    ct_loss = torch.full((), 1.0 / n_micro, dtype=torch.float32,
                         device=mt.device)
    for t in range(sched.ticks):
        tr = _Transfers(mesh, zero)
        for col, span in spans.items():
            if _distributed(mesh):
                _expect_arrivals(tr, sched, t, col, S, fwd_buf, bwd_buf)
            f_m, b_m = int(sched.f_mb[t, col]), int(sched.b_mb[t, col])
            if f_m >= 0:
                recv = fwd_buf[col][sched.f_read[t, col]]
                with torch.no_grad():
                    payload, loss_m = _tick_core(
                        model, params, span, mt[f_m], ml[f_m], recv,
                        col, S, False)
                if loss_m is not None:
                    loss = loss + loss_m / n_micro
                tr.move(sav_buf, col, sched.f_save[t, col], recv)
                if col + 1 < S:
                    tr.move(fwd_buf, col + 1, sched.f_wslot[t, col + 1],
                            payload)
            if b_m >= 0:
                recv, ins = None, leaves
                if col > 0:
                    recv = {k: v.detach().requires_grad_() for k, v in
                            sav_buf[col][sched.b_slot[t, col]].items()}
                    ins = leaves + [recv["x"], recv["aux"]]
                with torch.enable_grad():
                    payload, loss_m = _tick_core(
                        model, params, span, mt[b_m], ml[b_m], recv,
                        col, S, remat)
                if col == S - 1:
                    outs, cts = [loss_m], [ct_loss]
                else:       # a dense stack's aux is a constant zero
                    ct = bwd_buf[col][sched.b_read[t, col]]
                    outs, cts = zip(*((payload[k], ct[k]) for k in ("x", "aux")
                                      if payload[k].requires_grad))
                g = torch.autograd.grad(outs, ins, cts, allow_unused=True)
                for acc, gi in zip(grads, g):
                    if gi is not None:
                        acc.add_(gi)
                if col > 0:
                    tr.move(bwd_buf, col - 1, sched.b_wslot[t, col - 1],
                            {"x": g[-2], "aux": g[-1]})
        tr.finish()
    if _distributed(mesh):
        loss = comm.mean_over_data(
            comm.all_reduce_sum(loss, mesh.group("model")), mesh)
        grads = comm.reduce_grads(grads, specs, mesh,
                                  replicated_compute=False)
    return loss, grads


# ==================================================== expert-parallel runtime
def _ep_batch(batch, mesh, n_micro: int):
    """Validation for the EP substrate, and this rank's rows: the batch
    splits over 'data' and the local rows split into microbatches."""
    n_data = mesh_dims(mesh)[0]
    B = batch["tokens"].shape[0]
    if B % n_data or (B // n_data) % n_micro:
        raise ValueError(
            f"expert-parallel batch {B} must split into data axis {n_data} "
            f"x n_microbatches={n_micro}")
    if not _distributed(mesh) or n_data == 1:
        return batch
    bl, r = B // n_data, mesh.coords["data"]
    return {k: v[r * bl:(r + 1) * bl] for k, v in batch.items()}


def ep_loss(model, params, batch, mesh, *, n_micro: int = 1,
            remat: bool = False):
    """Expert-parallel loss: expert weights split over 'model' and
    ``models.moe._moe_apply_ep``'s all-to-alls exchange token buffers
    (``model`` built with ``expert_parallel_axis="model"``).  Non-expert
    compute is replicated over 'model'; the batch splits over 'data'."""
    local = _ep_batch(batch, mesh, n_micro)
    with torch.no_grad(), M.use_mesh(mesh):
        loss = microbatch_loss(model, params, local, n_micro, remat=remat)
    return comm.replicated_mean(loss, mesh) if _distributed(mesh) else loss


def ep_value_and_grad(model, params, batch, mesh, *, specs=None,
                      n_micro: int = 1, remat: bool = False):
    """(loss, [grad per leaf]) of :func:`ep_loss`, a microbatch's backward
    before the next one's forward (:func:`microbatch_value_and_grad`).
    Each 'model' rank computes the replicated loss on its 'data' rows, so
    an expert leaf's gradient, which comes back through the all-to-alls'
    adjoints once per rank, is divided by the axis size, while replicated
    leaves take model rank 0's gradient, and the loss is model rank 0's;
    everything is averaged over 'data'."""
    local = _ep_batch(batch, mesh, n_micro)
    with M.use_mesh(mesh):      # remat's recompute exchanges tokens too
        loss, grads = microbatch_value_and_grad(
            model, params, tree_leaves(params), local, n_micro, remat=remat)
    if _distributed(mesh):
        loss = comm.replicated_mean(loss, mesh)
        grads = comm.reduce_grads(grads, specs, mesh)
    return loss, grads
