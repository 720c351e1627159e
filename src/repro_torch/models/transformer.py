"""Superblock assembly (``repro.models.transformer``): every architecture
is a loop over homogeneous superblocks, the repeating (mixer, ffn) pattern
of its config.

Every tensor carries a leading branch dim G (G = 1 for ``Model``): where the
JAX package ``jax.vmap``-ed a ``SemanticModel``'s branches, the branches run
side by side here.  Block leaves are [G, ...]; stack leaves [G, n, ...]
(branch, superblock), and the JAX ``lax.scan`` over the stacked leaves is a
loop over the per-superblock views :func:`superblocks` gives.  Every apply
returns ``(x, caches, aux)`` with aux [G], the per-branch sum of the MoE
load-balance terms.

Decode caches follow the JAX layout, a tree per block (``{"k", "v"}`` for
attention, ``{"ssm", "conv"}`` for Mamba, tuples of state tensors for the
xLSTM cells) with leaves [G, n, B, ...].  A step writes each block's new
state into its superblock's view of the cache in place and returns the
same tree.

``remat`` is ``torch.utils.checkpoint`` (non-reentrant) around one
superblock, the body that ``jax.checkpoint`` wraps at
``repro/models/transformer.py:155,186``: its activations are recomputed in
the backward, so the attention forward runs twice per layer and step.

A stack may also be a :class:`StackOnUse`, whose superblocks are fetched
(on a mesh: gathered from the ranks' slices) inside their body, so inside
the checkpoint: no fetched superblock outlives its use, and the recompute
fetches it again.
"""
from __future__ import annotations

import functools
from typing import List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models import xlstm as X
from repro_torch.models.moe import RowSplit, moe_apply


def block_cache(cfg: ArchConfig, mixer: str, batch: int, cache_len: int,
                dtype, lead: tuple, device):
    """Decode-time state of one block, leaves ``lead + (batch, ...)``."""
    if mixer in ("attn", "attn_local"):
        eff = cache_len
        if mixer == "attn_local" and cfg.sliding_window:
            eff = min(cache_len, cfg.sliding_window)
        shape = lead + (batch, eff, cfg.n_kv_heads, cfg.hd)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    if mixer == "mamba":
        return S.mamba_init_state(cfg, batch, dtype, lead, device)
    if mixer == "mlstm":
        return X.mlstm_init_state(cfg, batch, lead, device)
    if mixer == "slstm":
        return X.slstm_init_state(cfg, batch, lead, device)
    raise ValueError(mixer)


def block_apply(params, x, cfg: ArchConfig, mixer: str, ffn: str, *,
                positions, cache=None, cache_index: Optional[int] = None,
                enc_kv=None, window_override: Optional[int] = None,
                cache_axis: Optional[L.CacheAxis] = None,
                rows: Optional[RowSplit] = None):
    """One block on x [G, B, S, d].  ``cache_axis``: this rank's slab of
    attention caches whose length is split over a mesh axis, and the merge
    over it (flash-decoding, :class:`~repro_torch.models.layers.CacheAxis`).
    ``rows``: the split of the batch's rows over ranks, which sizes the
    MoE's capacity by the whole batch (:class:`~repro_torch.models.moe.
    RowSplit`).  Returns (x, new_cache, aux [G])."""
    g, b, s, d = x.shape
    aux = x.new_zeros(g, dtype=torch.float32)
    h = L.norm_apply(params["mix_norm"], x, cfg)
    if mixer in ("attn", "attn_local"):
        window = cfg.sliding_window if mixer == "attn_local" else 0
        if window_override is not None and mixer == "attn":
            window = window_override
        out, new_cache = L.attn_apply(
            params["mix"], h, cfg, positions=positions, window=window,
            kv_cache=cache, cache_index=cache_index, cache_axis=cache_axis)
    elif mixer == "mamba":
        out, new_cache = S.mamba_apply(params["mix"], h, cfg, state=cache)
    elif mixer == "mlstm":
        out, new_cache = X.mlstm_apply(params["mix"], h, cfg, state=cache)
    elif mixer == "slstm":
        out, new_cache = X.slstm_apply(params["mix"], h, cfg, state=cache)
    else:
        raise ValueError(mixer)
    if cfg.post_norms:
        out = L.norm_apply(params["mix_post_norm"], out, cfg)
    x = x + out
    if enc_kv is not None:          # cross-attention (enc-dec decoder)
        h = L.norm_apply(params["cross_norm"], x, cfg)
        out, _ = L.attn_apply(params["cross"], h, cfg, positions=positions,
                              kv_override=enc_kv)
        x = x + out
    if ffn != "none":
        h = L.norm_apply(params["ffn_norm"], x, cfg).reshape(g, b * s, d)
        if ffn == "dense":
            out = L.mlp_apply(params["ffn"], h, cfg)
        else:
            out, aux = moe_apply(params["ffn"], h, cfg, rows)
        out = out.reshape(g, b, s, d)
        if cfg.post_norms:
            out = L.norm_apply(params["ffn_post_norm"], out, cfg)
        x = x + out
    return x, new_cache, aux


def tree_map(fn, *trees):
    """``fn`` over the tensor leaves of same-shaped trees of dicts and
    tuples."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: tree_map(fn, *(u[k] for u in trees)) for k in t}
    if isinstance(t, tuple):
        return tuple(tree_map(fn, *u) for u in zip(*trees))
    return fn(*trees)


def _store(view, new) -> None:
    """Write a block's new decode state into its view of the cache (an
    attention cache was written in place already)."""
    if new is not view:
        tree_map(lambda dst, src: dst.copy_(src), view, new)


def superblock_apply(params, x, cfg: ArchConfig, *, positions, cache=None,
                     cache_index: Optional[int] = None, enc_kv=None,
                     window_override: Optional[int] = None,
                     cache_axis: Optional[L.CacheAxis] = None,
                     rows: Optional[RowSplit] = None):
    """Apply one superblock (leaves [G, ...]; ``cache`` the superblock's
    views [G, B, ...], written in place).  Returns (x, cache, aux [G])."""
    aux = x.new_zeros(x.shape[0], dtype=torch.float32)
    for i, (mixer, ffn) in enumerate(cfg.pattern):
        key = f"pos{i}"
        view = None if cache is None else cache[key]
        x, new, a = block_apply(
            params[key], x, cfg, mixer, ffn, positions=positions,
            cache=view, cache_index=cache_index,
            enc_kv=None if enc_kv is None else enc_kv[key],
            window_override=window_override, cache_axis=cache_axis,
            rows=rows)
        if view is not None:
            _store(view, new)
        aux = aux + a
    return x, cache, aux


class StackOnUse:
    """A superblock stack of ``n`` whose superblock ``i`` is the tree
    ``fetch(i)`` returns, built when its body runs."""

    def __init__(self, n: int, fetch):
        self.n, self.fetch = n, fetch

    def map(self, fn) -> "StackOnUse":
        """The same stack with ``fn`` applied to each fetched leaf."""
        return StackOnUse(self.n, lambda i: tree_map(fn, self.fetch(i)))


def fetched(sb):
    """A superblock's tree (a :class:`StackOnUse` member is fetched)."""
    return sb() if callable(sb) else sb


def sb_slice(tree, i: int):
    """Superblock ``i`` of a stacked tree: leaves [G, n, ...] -> [G, ...]
    (views)."""
    return tree_map(lambda v: v[:, i], tree)


def superblocks(tree) -> List[dict]:
    """The per-superblock views of a stacked parameter tree (of a
    :class:`StackOnUse`, its members, fetched in their bodies)."""
    if isinstance(tree, StackOnUse):
        return [functools.partial(tree.fetch, i) for i in range(tree.n)]
    n = tree["pos0"]["mix_norm"]["w"].shape[1]
    return [sb_slice(tree, i) for i in range(n)]


def stack_apply(sbs: List[dict], x, cfg: ArchConfig, *, positions,
                caches=None, cache_index: Optional[int] = None,
                enc_kv_stack: Optional[List[dict]] = None,
                window_override: Optional[int] = None,
                remat: bool = False,
                cache_axis: Optional[L.CacheAxis] = None,
                rows: Optional[RowSplit] = None):
    """Loop over superblocks ``sbs`` (per-superblock trees, leaves
    [G, ...]).  ``caches`` (leaves [G, n, ...]) are written in place at
    ``cache_index`` (their length split over a mesh axis when
    ``cache_axis`` is given); ``enc_kv_stack`` holds each superblock's
    cross-attention K/V; ``rows`` as in :func:`block_apply`.  ``remat``
    (training) wraps each superblock in a checkpoint.  Returns (x, caches,
    aux [G])."""
    aux = x.new_zeros(x.shape[0], dtype=torch.float32)
    for i, sb in enumerate(sbs):
        cache = None if caches is None else sb_slice(caches, i)
        enc = None if enc_kv_stack is None else enc_kv_stack[i]

        def body(h, sb=sb, cache=cache, enc=enc):
            h, _, a = superblock_apply(
                fetched(sb), h, cfg, positions=positions, cache=cache,
                cache_index=cache_index, enc_kv=enc,
                window_override=window_override, cache_axis=cache_axis,
                rows=rows)
            return h, a

        x, a = checkpoint(body, x, use_reentrant=False) if remat \
            else body(x)
        aux = aux + a
    return x, caches, aux
