"""The port's collectives: the one module that calls ``torch.distributed``'s
communication ops.

- ``all_gather`` / ``reduce_scatter`` along a dim, each the other's
  backward under autograd, so a leaf gathered on use gets its gradient
  reduce-scattered back to its slice;
- ``all_reduce`` (sum) and ``all_to_all`` (equal splits along dim 0), both
  differentiable: the adjoint of a sum seen by every rank is a sum, and an
  equal-split all-to-all is its own inverse;
- ``all_reduce_max`` (no autograd) and ``merge_lse``, flash-decoding's
  exact merge of the slabs' partial attention over their log-sum-exps;
- ``broadcast`` from one group rank, differentiable: its backward sums the
  cotangents on that rank (``reduce_to``) and gives the others zeros;
  ``barrier``;
- ``exchange``: one tick's point-to-point sends and receives in a single
  ``batch_isend_irecv``, so two neighbours never wait on each other;
- ``send_to`` and ``post_recv``: one tensor point to point, the receive
  posted now and waited for later (a pinned serving worker's outputs and
  its ship payloads);
- ``reduce_grads``, ``mean_over_data`` and ``replicated_mean``: the
  runners' gradient and loss reductions over a mesh.

A group of one rank skips the op.  NCCL takes CUDA tensors directly; gloo
runs its ops on host tensors, so on a gloo group a CUDA tensor is staged:
copied into a pinned host buffer (cached by size and role), the op runs
there, and the result is copied back (a gather and a reduce-scatter of
one leaf share their two buffers).  Staging depends on the group's
backend and the tensor's device only.  ``COMM_STATS`` counts, per op, the
calls and the bytes each rank puts in, and the staged bytes (both ways)
and milliseconds (host wall time of the copies and the op).
"""
from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

COMM_STATS: Dict[str, float] = defaultdict(float)
_PINNED: Dict[Tuple, torch.Tensor] = {}


def reset_stats() -> None:
    COMM_STATS.clear()


def release_buffers() -> None:
    """Drop the cached pinned host buffers."""
    _PINNED.clear()


def group_size(group) -> int:
    return dist.get_world_size(group)


def _staged(group, t: torch.Tensor) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _pinned(numel: int, dtype: torch.dtype, role: str) -> torch.Tensor:
    key = (numel, dtype, role)
    buf = _PINNED.get(key)
    if buf is None:
        buf = torch.empty(numel, dtype=dtype, pin_memory=True)
        _PINNED[key] = buf
    return buf


def _count(op: str, nbytes: int) -> None:
    COMM_STATS[f"{op}_calls"] += 1
    COMM_STATS[f"{op}_bytes"] += nbytes


def _run(op: str, group, inp: torch.Tensor, out_shape, fn) -> torch.Tensor:
    """``fn(out, inp)`` on contiguous ``inp`` into a new tensor of
    ``out_shape``, staged through pinned host buffers on gloo."""
    inp = inp.contiguous()
    _count(op, inp.numel() * inp.element_size())
    if not _staged(group, inp):
        out = inp.new_empty(out_shape)
        fn(out, inp)
        return out
    t0 = time.perf_counter()
    n_out = 1
    for s in out_shape:
        n_out *= s
    # two buffers per size: a gather's output is a reduce-scatter's input
    small = inp.numel() <= n_out
    h_in = _pinned(inp.numel(), inp.dtype, "a" if small else "b")
    h_in.copy_(inp.reshape(-1))
    h_out = _pinned(n_out, inp.dtype, "b" if small else "a").view(out_shape)
    fn(h_out, h_in.view(inp.shape))
    out = h_out.to(inp.device)
    COMM_STATS["staged_bytes"] += (inp.numel() + n_out) * inp.element_size()
    COMM_STATS["staged_ms"] += 1e3 * (time.perf_counter() - t0)
    return out


# --------------------------------------------------------------- raw ops
def all_gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Concatenate every rank's ``x`` along ``dim`` in group-rank order."""
    n = group_size(group)
    if n == 1:
        return x
    xm = x.movedim(dim, 0)
    shape = (n * xm.shape[0],) + tuple(xm.shape[1:])
    out = _run("all_gather", group, xm, shape, lambda o, i:
               dist.all_gather_into_tensor(o, i, group=group))
    return out.movedim(0, dim)


def reduce_scatter_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Sum ``x`` over the group and keep this rank's slice along ``dim``."""
    n = group_size(group)
    if n == 1:
        return x
    xm = x.movedim(dim, 0)
    shape = (xm.shape[0] // n,) + tuple(xm.shape[1:])
    out = _run("reduce_scatter", group, xm, shape, lambda o, i:
               dist.reduce_scatter_tensor(o, i, group=group))
    return out.movedim(0, dim)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``x`` (a new tensor)."""
    if group_size(group) == 1:
        return x

    def fn(o, i):
        o.copy_(i)
        dist.all_reduce(o, group=group)
    return _run("all_reduce", group, x, tuple(x.shape), fn)


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise maximum of every rank's ``x`` (a new tensor)."""
    if group_size(group) == 1:
        return x

    def fn(o, i):
        o.copy_(i)
        dist.all_reduce(o, op=dist.ReduceOp.MAX, group=group)
    return _run("all_reduce_max", group, x, tuple(x.shape), fn)


def merge_lse(out: torch.Tensor, lse: torch.Tensor, group) -> torch.Tensor:
    """The exact softmax over the union of the ranks' slabs of a cache
    (flash-decoding) from each rank's f32 partial ``out`` [..., hd]
    (normalised over its own slab) and its log-sum-exp ``lse`` [...]: M =
    max over ranks of lse, then out = sum_r exp(lse_r - M) out_r / sum_r
    exp(lse_r - M), one all-reduce max and one all-reduce sum (numerators
    and denominators packed).  A row with no valid slot on any rank is
    0."""
    m = all_reduce_max(lse, group)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    w = torch.exp(lse - m)[..., None]
    tot = all_reduce_sum(torch.cat([out * w, w], dim=-1), group)
    return tot[..., :-1] / tot[..., -1:].clamp_min(1e-20)


def broadcast_from(x: torch.Tensor, src: int, group) -> torch.Tensor:
    """Group rank ``src``'s ``x`` on every rank (a new tensor)."""
    if group_size(group) == 1:
        return x
    root = dist.get_global_rank(group, src)

    def fn(o, i):
        o.copy_(i)
        dist.broadcast(o, src=root, group=group)
    return _run("broadcast", group, x, tuple(x.shape), fn)


def reduce_to(x: torch.Tensor, dst: int, group) -> torch.Tensor:
    """The sum of every rank's ``x`` on group rank ``dst``; zeros on the
    others."""
    if group_size(group) == 1:
        return x
    root = dist.get_global_rank(group, dst)

    def fn(o, i):
        o.copy_(i)
        dist.reduce(o, dst=root, group=group)
    out = _run("reduce", group, x, tuple(x.shape), fn)
    return out if dist.get_rank(group) == dst else torch.zeros_like(out)


def barrier(group=None) -> None:
    """Wait for every rank of ``group`` (the world by default)."""
    dist.barrier(group=group)


def all_to_all_dim0(x: torch.Tensor, group) -> torch.Tensor:
    """Block j of ``x``'s dim 0 goes to rank j; block j of the result came
    from rank j (equal splits)."""
    if group_size(group) == 1:
        return x
    return _run("all_to_all", group, x, tuple(x.shape), lambda o, i:
                dist.all_to_all_single(o, i, group=group))


def exchange(sends: Sequence[Tuple[torch.Tensor, int]],
             recvs: Sequence[Tuple[tuple, torch.dtype, int]],
             group, device) -> List[torch.Tensor]:
    """One batch of point-to-point ops: each ``(tensor, peer)`` of
    ``sends`` goes to group rank ``peer``; each ``(shape, dtype, peer)`` of
    ``recvs`` is received from it.  Returns the received tensors on
    ``device``, in ``recvs``' order."""
    if not sends and not recvs:
        return []
    staged = torch.device(device).type == "cuda" and \
        dist.get_backend(group) == "gloo"
    t0 = time.perf_counter()
    ops, outs, staged_bytes = [], [], 0
    for j, (t, peer) in enumerate(sends):
        t = t.contiguous()
        nbytes = t.numel() * t.element_size()
        _count("send", nbytes)
        if staged:
            h = _pinned(t.numel(), t.dtype, f"send{j}")
            h.copy_(t.reshape(-1))
            t = h
            staged_bytes += nbytes
        ops.append(dist.P2POp(dist.isend, t, dist.get_global_rank(group, peer),
                              group=group))
    for j, (shape, dtype, peer) in enumerate(recvs):
        n = 1
        for s in shape:
            n *= s
        buf = _pinned(n, dtype, f"recv{j}") if staged else \
            torch.empty(n, dtype=dtype, device=device)
        outs.append(buf.view(shape))
        ops.append(dist.P2POp(dist.irecv, buf,
                              dist.get_global_rank(group, peer), group=group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if staged:
        outs = [o.to(device) for o in outs]
        staged_bytes += sum(o.numel() * o.element_size() for o in outs)
        COMM_STATS["staged_bytes"] += staged_bytes
        COMM_STATS["staged_ms"] += 1e3 * (time.perf_counter() - t0)
    return outs


def send_to(x: torch.Tensor, peer: int, group) -> None:
    """Send ``x`` to group rank ``peer`` and return once it has gone (on
    gloo a CUDA tensor goes from a host copy)."""
    x = x.contiguous()
    _count("send", x.numel() * x.element_size())
    if _staged(group, x):
        COMM_STATS["staged_bytes"] += x.numel() * x.element_size()
        x = x.cpu()
    dist.send(x, dst=dist.get_global_rank(group, peer), group=group)


class Receive:
    """A receive :func:`post_recv` posted: :meth:`wait` waits for it and
    returns the tensor on the device it was asked for."""

    def __init__(self, work, buf: torch.Tensor, device: torch.device):
        self._work, self._buf, self._device = work, buf, device

    def wait(self) -> torch.Tensor:
        self._work.wait()
        if self._buf.device == self._device:
            return self._buf
        COMM_STATS["staged_bytes"] += self._buf.numel() * \
            self._buf.element_size()
        return self._buf.to(self._device)


def post_recv(shape, dtype: torch.dtype, peer: int, group,
              device) -> Receive:
    """Post the receive of a ``shape`` / ``dtype`` tensor from group rank
    ``peer`` without waiting for it (on gloo a CUDA destination receives
    into host memory and moves in :meth:`Receive.wait`)."""
    dev = torch.device(device)
    staged = dev.type == "cuda" and dist.get_backend(group) == "gloo"
    buf = torch.empty(tuple(shape), dtype=dtype,
                      device="cpu" if staged else dev)
    _count("recv", buf.numel() * buf.element_size())
    work = dist.irecv(buf, src=dist.get_global_rank(group, peer), group=group)
    return Receive(work, buf, dev)


# ------------------------------------------------------ autograd wrappers
class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_dim(g, ctx.dim, ctx.group), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return reduce_scatter_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather_dim(g, ctx.dim, ctx.group), None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.group), None


class _Broadcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, src, group):
        ctx.src, ctx.group = src, group
        return broadcast_from(x, src, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_to(g, ctx.src, ctx.group), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_to_all_dim0(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_to_all_dim0(g, ctx.group), None


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Differentiable all-gather along ``dim`` (backward: reduce-scatter)."""
    if group_size(group) == 1:
        return x
    return _AllGather.apply(x, dim, group)


def reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Differentiable reduce-scatter along ``dim`` (backward: all-gather)."""
    if group_size(group) == 1:
        return x
    return _ReduceScatter.apply(x, dim, group)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable all-reduce sum."""
    if group_size(group) == 1:
        return x
    return _AllReduce.apply(x, group)


def broadcast(x: torch.Tensor, src: int, group) -> torch.Tensor:
    """Differentiable broadcast from group rank ``src`` (backward: the
    cotangents summed on ``src``, zeros elsewhere)."""
    if group_size(group) == 1:
        return x
    return _Broadcast.apply(x, src, group)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable all-to-all of equal blocks along dim 0."""
    if group_size(group) == 1:
        return x
    return _AllToAll.apply(x, group)


# ---------------------------------------------------- runner reductions
def mean_over_data(x: torch.Tensor, mesh) -> torch.Tensor:
    """The mean of a per-rank value over 'data' (no autograd)."""
    n = mesh.axis_size("data")
    if n == 1 or not mesh.distributed:
        return x
    return all_reduce_sum(x.detach(), mesh.group("data")) / n


def replicated_mean(x: torch.Tensor, mesh) -> torch.Tensor:
    """The mean over 'data' of a value every rank of a 'model' slice
    computed alike (no autograd): model rank 0's, since the card's
    scatter-adds round in launch order and the replicas' values can differ
    in the last place (as ``reduce_grads`` takes rank 0's gradient)."""
    if mesh.axis_size("model") > 1 and mesh.distributed:
        x = broadcast_from(x.detach(), 0, mesh.group("model"))
    return mean_over_data(x, mesh)


def reduce_grads(grads, specs, mesh, *, replicated_compute: bool = True):
    """Gradients of the mean loss over 'data' from each rank's gradients,
    ``grads`` in the order of the leaves of ``specs``.  A leaf that 'data'
    does not split is averaged over 'data'; one it splits was summed there
    by a reduce-scatter and is divided by its size.  Over 'model', with
    ``replicated_compute`` (every rank of a 'model' slice saw the same
    loss), a leaf 'model' splits was summed over ranks that saw one loss
    and is divided by its size, and a leaf it does not split takes model
    rank 0's gradient: each rank computed the same gradient, but the card's
    scatter-adds (embedding and MoE backward) round in launch order, and
    replicas that stepped on their own would drift apart.  Without it (the
    stage graph, where each stage holds a part of the gradient of the
    leaves it shares), a leaf 'model' does not split is summed over
    'model'."""
    from repro_torch.dist.sharding import spec_axes, spec_leaves
    n_data, n_model = mesh.axis_size("data"), mesh.axis_size("model")
    out = []
    for g, spec in zip(grads, spec_leaves(specs)):
        axes = spec_axes(spec)
        if n_data > 1:
            g = g / n_data if "data" in axes else \
                all_reduce_sum(g, mesh.group("data")) / n_data
        if n_model > 1:
            if replicated_compute:
                g = g / n_model if "model" in axes else \
                    broadcast_from(g, 0, mesh.group("model"))
            elif "model" not in axes:
                g = all_reduce_sum(g, mesh.group("model"))
        out.append(g)
    return out
