"""Mixture-of-Experts FFN with sort-based capacity dispatch, on the paged
serving and training paths.

Mirrors ``repro.models.moe`` (``moe_init``'s layout, ``router_topk``,
``load_balance_loss`` and ``_moe_apply_dense``) with a leading branch dim G
on tokens and weights:
each branch routes its own tokens, which is what ``jax.vmap`` over a
``SemanticModel``'s branches did.  Where a gradient is recorded
(training) the expert product over the [E, C, d] buffer is a batched
``torch.matmul``, as the JAX package leaves it to XLA (``vmap(mlp_apply)``,
outside any Pallas kernel).  Where none is (every serving call runs under
``torch.no_grad()``) the same kept assignments are compacted by expert,
G*T*k rows in the sorted order with the dropped ones last at weight 0,
and each projection is one launch of ``moe_gmm_ragged`` over the G*E
experts' segments, whose offsets stay on the device: the capacity
buffer's empty slots are not computed and only the chosen experts'
weights are read.  The combine adds the same products in the same order
(the sorted order is the slot buffers' expert-major one).

Capacity couples the tokens of a call: ``cap = max(k, ceil(T k cf / E))``
counts every row of the call (inactive decode lanes and padded prefill slots
too), and assignments past an expert's capacity drop.  Empty slots point at
token 0 with weight 0, as in JAX.  The whole dispatch stays on the device
(no data-dependent shapes, so no host sync).

On a mesh whose 'data' axis splits the call's rows, the runner hands down a
:class:`RowSplit` (as it hands ``layers.CacheAxis`` to attention), and the
dispatch drops what the reference's GSPMD drops over the whole batch:
capacity from the global token count, and an assignment kept exactly when
its place in the global stable order (lower 'data' ranks' rows first, the
order of ``jnp.argsort`` over the global tokens) is below it.  That place
is this rank's own place plus the lower ranks' assignments to the same
expert, so the ranks all-gather their per-expert counts ([G*E] integers a
layer and call), and each rank runs the experts on its own kept tokens:
a token's expert output depends on that token alone.  Serving, a rank's
expert product takes its own G*T*k compacted rows; training, its slots
are [G*E, min(C, T)] (up to min(ranks, E / (k cf)) times per-rank
sizing's work, until the ragged kernel has a backward).  The load-balance
term, a product of two means over the tokens, takes the means over the
whole batch too where it is used (training): one differentiable all-reduce
of [G, 2E] sums a layer; the serving calls drop it and skip that.

With ``cfg.expert_parallel_axis`` set (the pipeline runner's
expert-parallel substrate) the experts are split over that axis of the
enclosing ``launch.mesh.use_mesh`` mesh, [E_local, d, ff] a rank, and two
all-to-alls move the token buffers to the experts' owners and back
(``_moe_apply_ep``).
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.moe_gmm import moe_gmm_ragged
from repro_torch.launch.mesh import current_mesh
from repro_torch.models import layers as L


def moe_shapes(cfg: ArchConfig) -> dict:
    """Leaf shapes of ``moe_init``: ``router`` [d, E], ``experts`` MLPs with
    a leading E, and a ``shared`` MLP of width ``n_shared * d_ff``."""
    m = cfg.moe
    eff = m.d_ff or cfg.d_ff
    p = {"router": (cfg.d_model, m.n_experts),
         "experts": L.mlp_shapes(cfg, eff, (m.n_experts,))}
    if m.n_shared:
        p["shared"] = L.mlp_shapes(cfg, m.n_shared * eff)
    return p


def router_topk(logits: torch.Tensor, top_k: int):
    """Top-k routing weights: softmax over the selected logits in f32.
    Equal logits take the lower expert index first, as ``jax.lax.top_k``
    does (bf16 router logits tie often): a stable descending sort, then the
    first k."""
    w, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return torch.softmax(w[..., :top_k].float(), dim=-1), idx[..., :top_k]


def load_balance_loss(logits: torch.Tensor, idx: torch.Tensor,
                      n_experts: int, rows=None) -> torch.Tensor:
    """Switch-style auxiliary load-balance loss per branch: logits [G, T, E],
    idx [G, T, k] -> [G]; with ``rows`` (a :class:`RowSplit`) that can sum
    over ranks the means run over every rank's tokens."""
    probs = torch.softmax(logits.float(), dim=-1)
    primary = torch.nn.functional.one_hot(idx[..., 0], n_experts).float()
    if rows is None or rows.sum is None:
        me, ce = probs.mean(dim=-2), primary.mean(dim=-2)
    else:
        both = torch.cat([probs.sum(dim=-2), primary.sum(dim=-2)], dim=-1)
        me, ce = (rows.sum(both) / (logits.shape[-2] * rows.size)).split(
            n_experts, dim=-1)
    return n_experts * (me * ce).sum(dim=-1)


class RowSplit(NamedTuple):
    """One rank's handle on the mesh axis that splits a call's rows
    ('data'): the rank's ``index`` of ``size`` ranks, each holding as many
    tokens; ``gather(t)``, which concatenates every rank's 1-D integer
    tensor ``t`` in rank order (``dist.comm.all_gather_dim`` over the
    axis); and ``sum(t)``, the differentiable sum of every rank's ``t``
    (``dist.comm.all_reduce``), or None where the caller drops the
    load-balance aux (serving: the aux's means then stay this rank's, and
    no collective is spent on them).  The runner that owns the mesh passes
    it; no module reads a mesh."""
    index: int
    size: int
    gather: Callable
    sum: Optional[Callable]


def moe_apply(params, x: torch.Tensor, cfg: ArchConfig,
              rows: Optional[RowSplit] = None):
    """x [G, T, d] -> ([G, T, d], aux [G]), each branch routed on its own;
    aux is the branch's load-balance loss (a training term: the serving
    path drops it, as the JAX one does).  ``rows``: the split of the
    call's rows over ranks, whose capacity is the whole batch's.  Without
    a gradient recorded (serving) the expert product is the compacted,
    ragged one; with one, the capacity slots'."""
    if cfg.expert_parallel_axis:
        return _moe_apply_ep(params, x, cfg)
    if not torch.is_grad_enabled():
        return _moe_apply_compact(params, x, cfg, rows)
    return _moe_apply_dense(params, x, cfg, rows)


def _sorted_keep(weights, idx, g: int, t: int, m,
                 rows: Optional[RowSplit] = None):
    """The sort-based dispatch's order and keep rule, shared by both
    dispatches: G branches' [T, k] assignments in one stable sort over
    (branch, expert), each one's place within its expert and whether it
    is kept (its place, with ``rows`` its place in the whole batch's order,
    below the capacity; see the module docstring).  Returns (se, sw, st,
    pos, keep, cap): the sorted experts (branch b's expert e is b*E + e),
    weights and tokens (rows of the [G*T, d] tokens), places, the keep
    mask and the capacity."""
    n_e, k = m.n_experts, m.top_k
    dev = idx.device
    n_rows = 1 if rows is None else rows.size
    cap = int(max(k, math.ceil(t * n_rows * k * m.capacity_factor / n_e)))
    # branch b's expert e is b*E + e and its token j row b*T + j of xt, so
    # one stable sort orders every branch exactly as its own sort would
    flat_e = (idx + n_e * torch.arange(g, device=dev)[:, None, None]) \
        .reshape(-1)                                         # [G*T*k]
    flat_w = weights.reshape(-1)
    flat_tok = torch.arange(g * t, device=dev).repeat_interleave(k)
    order = torch.argsort(flat_e, stable=True)
    se, sw, st = flat_e[order], flat_w[order], flat_tok[order]
    # position within its expert's group = rank - first rank of the expert
    experts = torch.arange(g * n_e, device=dev)
    first = torch.searchsorted(se, experts)
    pos = torch.arange(se.numel(), device=dev) - first[se]
    if rows is None:
        keep = pos < cap
    else:
        # the lower ranks' assignments to each expert come first in the
        # global order
        count = torch.searchsorted(se, experts, right=True) - first
        every = rows.gather(count).reshape(rows.size, g * n_e)
        keep = pos + every[:rows.index].sum(0)[se] < cap
    return se, sw, st, pos, keep, cap


def _dispatch_buffers(weights, idx, g: int, t: int, m,
                      rows: Optional[RowSplit] = None):
    """Sort-based dispatch of G branches' [T, k] assignments into [G*E, C]
    slots (the training path's, shared with the expert-parallel one).
    With ``rows`` the T tokens are this rank's of ``rows.size`` ranks', the
    capacity and the drops are the whole batch's (see the module
    docstring), and C is the smaller of that capacity and T.  Returns
    (buf_tok [G*E, C] rows of the [G*T, d] tokens, buf_w [G*E, C])."""
    n_ge = g * m.n_experts
    se, sw, st, pos, keep, cap = _sorted_keep(weights, idx, g, t, m, rows)
    # a rank keeps at most its own t tokens an expert (a token's k experts
    # differ), so its slots need not span the whole batch's capacity
    width = cap if rows is None else min(cap, t)
    # dropped assignments land in a spare row that is cut off afterwards
    # (JAX's out-of-range index with mode="drop")
    slot_e = torch.where(keep, se, n_ge)
    slot_p = torch.where(keep, pos, 0)
    buf_tok = torch.zeros(n_ge + 1, width, dtype=torch.long, device=se.device)
    buf_w = torch.zeros(n_ge + 1, width, dtype=sw.dtype, device=se.device)
    buf_tok[slot_e, slot_p] = torch.where(keep, st, 0)
    buf_w[slot_e, slot_p] = torch.where(keep, sw, 0.0)
    return buf_tok[:-1], buf_w[:-1]


def _dispatch_compact(weights, idx, g: int, t: int, m,
                      rows: Optional[RowSplit] = None):
    """The same dispatch compacted by expert (the serving path's): the
    kept assignments in the sorted order, which is the slot buffers'
    expert-major order, then the dropped ones with weight 0, R = G*T*k in
    all (a static size).  Returns (tok [R] rows of the [G*T, d] tokens,
    w [R], offsets [G*E + 1] int32: expert e's kept assignments are rows
    offsets[e] .. offsets[e + 1]).  Nothing is read on the host."""
    n_ge = g * m.n_experts
    se, sw, st, _, keep, _ = _sorted_keep(weights, idx, g, t, m, rows)
    # kept first, each part in the sorted order (a stable sort on keep)
    order = torch.argsort(keep, descending=True, stable=True)
    tok = st[order]
    w = torch.where(keep, sw, 0.0)[order]
    # the kept rows' experts ascend, the dropped rows read as expert G*E:
    # expert e's rows start where the experts below it end
    expert = torch.where(keep, se, n_ge)[order]
    offsets = torch.searchsorted(
        expert, torch.arange(n_ge + 1, device=se.device), out_int32=True)
    return tok, w, offsets


def _route(params, x: torch.Tensor, m, rows: Optional[RowSplit] = None,
           compact: bool = False):
    """Router logits, top-k and the load-balance aux of x [G, T, d], and
    the dispatch's buffers (``compact``: :func:`_dispatch_compact`'s)."""
    g, t, _ = x.shape
    logits = x @ params["router"]                            # [G, T, E]
    weights, idx = router_topk(logits, m.top_k)              # [G, T, k]
    aux = load_balance_loss(logits, idx, m.n_experts, rows)
    dispatch = _dispatch_compact if compact else _dispatch_buffers
    return aux, *dispatch(weights, idx, g, t, m, rows)


def _combine(params, x, xt, buf_tok, buf_w, ey, cfg):
    """Expert outputs [G*E*C, d] (or [R, d] compacted) back to the tokens
    (weights cast to the activations' dtype, as in JAX), plus the shared
    expert."""
    g, t, d = x.shape
    out = torch.zeros_like(xt).index_add_(
        0, buf_tok.reshape(-1), ey * buf_w.reshape(-1, 1).to(ey.dtype))
    out = out.reshape(g, t, d)
    if cfg.moe.n_shared:
        out = out + L.mlp_apply(params["shared"], x, cfg)
    return out


def _moe_apply_dense(params, x: torch.Tensor, cfg: ArchConfig,
                     rows: Optional[RowSplit] = None):
    g, t, d = x.shape
    aux, buf_tok, buf_w = _route(params, x, cfg.moe, rows)
    # ---- expert compute: batched matmul over [G, E, C, d]
    xt = x.reshape(g * t, d)
    ex = xt[buf_tok].reshape(g, cfg.moe.n_experts, -1, d)
    ey = L.mlp_apply(params["experts"], ex, cfg).reshape(-1, d)
    return _combine(params, x, xt, buf_tok, buf_w, ey, cfg), aux


def _ragged_mlp(params, xs: torch.Tensor, offsets: torch.Tensor, cfg):
    """``mlp_apply`` of the experts [G, E, d, f] (viewed as G*E groups) on
    the compacted rows xs [R, d]: each projection one ragged launch, the
    activation in plain torch between them; rows past offsets[-1] are 0."""
    ge = offsets.numel() - 1

    def grouped(w):
        # the kernel reads each weight row dense; a leaf gathered on use over
        # its last dim (``comm.all_gather_dim``) arrives with that dim
        # strided and is copied once here
        w = w.reshape(ge, *w.shape[-2:])
        return w if w.stride(-1) == 1 else w.contiguous()
    if "wg" in params:
        h = F.silu(moe_gmm_ragged(xs, grouped(params["wg"]), offsets)) \
            * moe_gmm_ragged(xs, grouped(params["wu"]), offsets)
    else:
        h = F.gelu(moe_gmm_ragged(xs, grouped(params["wu"]), offsets),
                   approximate="tanh")
    return moe_gmm_ragged(h, grouped(params["wd"]), offsets)


def _moe_apply_compact(params, x: torch.Tensor, cfg: ArchConfig,
                       rows: Optional[RowSplit] = None):
    """The serving path (no gradient recorded): the same routing, capacity
    and drops as the slot path, the kept assignments compacted by expert
    and run through ``moe_gmm_ragged`` (G*T*k rows, the chosen experts'
    weights; on a row split this rank's T), combined in the slot path's
    order."""
    g, t, d = x.shape
    aux, tok, w, offsets = _route(params, x, cfg.moe, rows, compact=True)
    xt = x.reshape(g * t, d)
    ey = _ragged_mlp(params["experts"], xt[tok], offsets, cfg)
    return _combine(params, x, xt, tok, w, ey, cfg), aux


def _moe_apply_ep(params, x: torch.Tensor, cfg: ArchConfig):
    """Expert-parallel MoE of one branch (G = 1): this rank's experts
    [E_local, d, ff]; every rank dispatches its own tokens into [E, C]
    slots (capacity from its own token count: the reference runs this path
    inside ``shard_map``, where each shard sizes its own, so no
    :class:`RowSplit` reaches it), the first all-to-all sends expert e's
    rows to e's owner, which runs them as [E_local, A*C, d], and the second
    sends the outputs back."""
    from repro_torch.dist import comm    # dist imports the models
    mesh = current_mesh()
    if mesh is None:     # the reference's axis name is unbound outside
        raise NotImplementedError(       # shard_map
            "expert-parallel MoE runs inside a mesh (launch.mesh.use_mesh, "
            "as the expert-parallel training substrate sets it): outside "
            "one, as outside the reference's shard_map, its axis is "
            "unbound")
    group = mesh.group(cfg.expert_parallel_axis) if mesh.distributed \
        else None
    a = comm.group_size(group) if group is not None else 1
    g, t, d = x.shape
    n_e = cfg.moe.n_experts
    e_l = n_e // a
    aux, buf_tok, buf_w = _route(params, x, cfg.moe)
    cap = buf_tok.shape[1]
    xt = x.reshape(g * t, d)
    ex = xt[buf_tok]                                         # [E, C, d]
    if a > 1:
        ex = comm.all_to_all(ex, group)          # block j: rank j's rows
    ex = ex.reshape(a, e_l, cap, d).transpose(0, 1).reshape(e_l, a * cap, d)
    ey = L.mlp_apply(params["experts"], ex[None], cfg)[0]
    ey = ey.reshape(e_l, a, cap, d).transpose(0, 1).reshape(n_e, cap, d)
    if a > 1:
        ey = comm.all_to_all(ey, group)          # back to the tokens' rank
    return _combine(params, x, xt, buf_tok, buf_w, ey.reshape(-1, d),
                    cfg), aux
