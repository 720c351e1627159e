"""Paged decode forward passes: chunked prefill and the K-token greedy
decode loop, over a ``Model`` or a ``SemanticModel``.

``make_prefill_chunk_fn``  one call commits up to ``chunk`` prompt tokens
                    per prefilling lane directly into the paged pool: per
                    layer the chunk's K/V scatter to their block slots, then
                    the queries attend through the block table over the
                    cached prefix and the in-chunk causal triangle
                    (``paged_prefill_attention``).
``make_decode_fn``  K greedy decode steps per dispatch: a Python loop with
                    argmax on the device; the caller reads the K tokens back
                    once.  Per-lane ``remaining`` masks retire lanes
                    mid-loop (writes route to the null block, lengths
                    freeze).
``paged_decode_logits``  one paged decode step (``paged_decode_attention``).
``make_prefill_fn``  the scheduler's chunk call: the chunk committed, each
                    lane's greedy token at its last valid position returned
                    instead of its logits.

Where the JAX package ``lax.scan``-ned the superblock stack, this loops
over ``N_sb``; where it ``jax.vmap``-ed a ``SemanticModel``'s branches, every
tensor carries a leading branch dim G (G = 1 for ``Model``) and one kernel
launch per layer serves all branches.  The branches' vocab shards merge in
the JAX order (``(1, 0, 2)`` transpose).  The pool is updated in place
(``index_put_``) and returned.  int8 pools quantize on write and dequantize
in the kernels' registers.

Every forward takes an optional ``params``: the model's grouped views
(``model.grouped_views()``, the default) or a copy whose attention
projections :func:`quantize_attn_params` replaced by ``{"q", "scale"}``
dicts; those route the four attention matmuls through ``quant_matmul``.
MoE FFNs go through ``moe_apply``.

The forwards also serve one rank's slice of a model on a process-group
mesh (``dist.api``'s runners hand the scheduler a model-like view: its
``grouped_views()`` are the rank's slices, its pool the rank's slice of the
pool, and its ``join`` says how the slices meet).  A superblock view may be
a callable that fetches the superblock when its body runs
(``transformer.StackOnUse``).  The join decides three things: where the
activation comes from (``enter``: the embedding, or the stage before), what
leaves the stack (``tokens``: the greedy token of each lane, the only thing
the decode loop and the prefill read, so no logits cross ranks) and how
per-rank statistics add up (``reduce_stats``).  :data:`LOCAL` is the join
of a rank that runs the whole model, one process included.  A LAYER stage
runs its superblocks over its slice of the pool; a SEMANTIC rank runs its
branches (the leading dim G is its share of them) over theirs.  'data'
splits neither the pool nor the wave: a lane's table may point at any
physical block and prefix sharing aliases blocks across lanes, so each
'data' rank holds its model slice's whole pool and runs the whole wave.
That is exact and needs no collective, and 'data' gains nothing; splitting
lanes over replicas is a fleet's job.  COMPRESSED (fsdp) gathers its
weights on use, as its gang path does, and runs every layer on every rank.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.decode.paged_cache import (chunk_write_slots, quantize_kv,
                                            write_slots)
from repro_torch.kernels.paged_decode_attention import paged_decode_attention
from repro_torch.kernels.paged_prefill_attention import \
    paged_prefill_attention
from repro_torch.kernels.quant_matmul import (dequantize_blockwise,
                                              quant_matmul, quantize_blockwise)
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.moe import moe_apply

#: the serving-side projection weights eligible for blockwise quantization
ATTN_PROJ = ("wq", "wk", "wv", "wo")


def supports_paged_decode(model) -> bool:
    """Paged decode needs pure global-attention mixers."""
    return getattr(model, "supports_single_step_prefill", False)


class LocalJoin:
    """The join of a rank that runs the whole model (one process; a rank
    whose mesh axes split nothing of this model): it embeds, runs every
    superblock and takes the greedy tokens over the merged vocab; nothing
    crosses ranks."""

    @staticmethod
    def enter(embed, shape):
        """The stack's input: ``embed()`` ([G, B, S, d]); ``shape`` (B, S)
        sizes an activation received instead."""
        return embed()

    @staticmethod
    def tokens(model, params, x, select):
        """[B] int32 greedy tokens of the stack's output ``x`` [G, B, S, d]
        at the positions ``select(x)`` ([G, B, d]) picks."""
        return torch.argmax(_head(model, params, select(x)), dim=-1).int()

    @staticmethod
    def reduce_stats(stats):
        """(max, sum, count) of per-rank statistics over the ranks that
        hold the other slices of the model."""
        return stats


LOCAL = LocalJoin()


def join_of(model):
    """The model's join: a mesh view's own, else :data:`LOCAL`."""
    return getattr(model, "join", LOCAL)


def _grouped_pool(model, pool: Dict) -> Dict:
    """Pool leaves with a leading branch dim (views; writes reach ``pool``).
    A semantic model's (or rank's) pool has one already."""
    if model.cfg.n_branches > 1:
        return pool
    return {pos: {k: v.unsqueeze(0) for k, v in e.items()}
            for pos, e in pool.items()}


def _sb_pool(gpool: Dict, n: int) -> Dict:
    return {pos: {k: v[:, n] for k, v in e.items()} for pos, e in gpool.items()}


def _with_mix(sb: Dict, mixes: Dict) -> Dict:
    """Superblock ``sb`` with each block's attention projections replaced
    by ``mixes[pos]``'s."""
    return {pos: {**blk, "mix": {**blk["mix"], **mixes[pos]}}
            for pos, blk in sb.items()}


@torch.no_grad()
def quantize_attn_params(params, bits: int, reduce=None):
    """Serving-side blockwise weight quantization of the attention
    projections (wq/wk/wv/wo) in every superblock of ``params`` (grouped
    views, as ``model.grouped_views()`` returns them).

    Returns ``(new_params, telemetry)``: a NEW views tuple (the model's
    float parameters are untouched) whose projection leaves are
    ``{"q", "scale"}`` dicts consumed by :func:`_proj`, plus the max / mean
    absolute dequantization error over all quantized weights.  Norms,
    embeddings and FFN weights keep their dtype.  A superblock fetched on
    use stays so: only its quantized projections are kept.  ``reduce``
    (a join's ``reduce_stats``) adds up the (max, sum, count) of the error
    over the ranks holding the other slices, so a rank reports the whole
    model's telemetry."""
    err_max, err_sum, err_n = 0.0, 0.0, 0
    new_sbs = []
    for sb in params[2]:
        mixes = {}
        for pos, blk in T.fetched(sb).items():
            mixes[pos] = {}
            for name in ATTN_PROJ:
                w = blk["mix"][name]
                q, s = quantize_blockwise(w, bits=bits)
                err = (dequantize_blockwise(q, s, bits=bits) - w.float()).abs()
                err_max = max(err_max, float(err.max()))
                err_sum += float(err.sum(dtype=torch.float64))
                err_n += err.numel()
                mixes[pos][name] = {"q": q, "scale": s}
        new_sbs.append(
            (lambda sb=sb, mixes=mixes: _with_mix(sb(), mixes))
            if callable(sb) else _with_mix(sb, mixes))
    if reduce is not None:
        err_max, err_sum, err_n = reduce((err_max, err_sum, err_n))
    tele = {
        "weight_quant_bits": bits,
        "weight_quant_max_err": round(err_max, 6),
        "weight_quant_mean_err": round(err_sum / max(err_n, 1), 6),
    }
    return (params[0], params[1], new_sbs), tele


def _proj(x: torch.Tensor, w) -> torch.Tensor:
    """x [G, B, S, D] @ w -> [G, B, S, E].  ``w`` is a float [G, D, E] or a
    quantized ``{"q", "scale"}`` dict, routed through ``quant_matmul`` with
    x in the [G, B*S, D] layout, so the branches share one launch."""
    g, b, s, d = x.shape
    xf = x.reshape(g, b * s, d)
    if isinstance(w, dict):
        out = quant_matmul(xf.contiguous(), w["q"], w["scale"])
    else:
        out = xf @ w
    return out.reshape(g, b, s, -1)


def _scatter_kv(pool: Dict, k, v, wb, wo) -> Dict:
    """Write new K/V [G, B, (C,) K, hd] into their (wb, wo) slots in place,
    quantizing on write when the pool carries int8 code + scale leaves.
    Per-token scales make each slot a function of its own K/V vector, so
    chunk prefill, decode steps and COW copies commit identical bytes."""
    wb, wo = wb.long(), wo.long()
    if "k_scale" in pool:
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        pool["k"][:, wb, wo] = kq
        pool["k_scale"][:, wb, wo] = ks
        pool["v"][:, wb, wo] = vq
        pool["v_scale"][:, wb, wo] = vs
    else:
        pool["k"][:, wb, wo] = k.to(pool["k"].dtype)
        pool["v"][:, wb, wo] = v.to(pool["v"].dtype)
    return pool


def _qkv(params, x, cfg: ArchConfig, positions):
    g, b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = _proj(x, params["wq"]).reshape(g, b, s, h, hd)
    k = _proj(x, params["wk"]).reshape(g, b, s, kv, hd)
    v = _proj(x, params["wv"]).reshape(g, b, s, kv, hd)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _paged_attn(params, x, cfg: ArchConfig, *, positions, pool, block_tables,
                valid_lens, wb, wo):
    """One-token GQA attention against the paged pool: scatter the new K/V
    into the (wb, wo) write slots, then attend through the block table."""
    g, b, s, _ = x.shape                    # s == 1
    q, k, v = _qkv(params, x, cfg, positions)
    _scatter_kv(pool, k[:, :, 0], v[:, :, 0], wb, wo)
    out = paged_decode_attention(
        q[:, :, 0].contiguous(), pool["k"], pool["v"], block_tables,
        valid_lens, k_scale=pool.get("k_scale"), v_scale=pool.get("v_scale"),
        softcap=cfg.attn_softcap)
    return _proj(out.reshape(g, b, s, -1), params["wo"])


def _paged_chunk_attn(params, x, cfg: ArchConfig, *, positions, pool,
                      block_tables, wb, wo):
    """Chunk GQA attention against the paged pool: scatter the chunk's K/V,
    then attend with the absolute-position causal mask."""
    g, b, s, _ = x.shape                    # s == chunk
    q, k, v = _qkv(params, x, cfg, positions)
    _scatter_kv(pool, k, v, wb, wo)
    out = paged_prefill_attention(
        q.contiguous(), pool["k"], pool["v"], block_tables, positions,
        k_scale=pool.get("k_scale"), v_scale=pool.get("v_scale"),
        softcap=cfg.attn_softcap)
    return _proj(out.reshape(g, b, s, -1), params["wo"])


def _stack_body(cfg: ArchConfig, h, sb_params, sb_pool, attn_fn):
    """One superblock of the paged forward; ``attn_fn(blk_params, hn,
    sb_pool_entry)`` returns the mixer output.  h: [G, B, S, d]."""
    for i, (mixer, ffn) in enumerate(cfg.pattern):
        if mixer != "attn":
            raise ValueError("paged decode requires global attention")
        blk = sb_params[f"pos{i}"]
        hn = L.norm_apply(blk["mix_norm"], h, cfg)
        out = attn_fn(blk["mix"], hn, sb_pool[f"pos{i}"])
        if cfg.post_norms:
            out = L.norm_apply(blk["mix_post_norm"], out, cfg)
        h = h + out
        if ffn != "none":
            hn = L.norm_apply(blk["ffn_norm"], h, cfg)
            g, b, s, d = hn.shape
            hf = hn.reshape(g, b * s, d)
            out = L.mlp_apply(blk["ffn"], hf, cfg) if ffn == "dense" \
                else moe_apply(blk["ffn"], hf, cfg)[0]    # aux: training only
            out = out.reshape(g, b, s, d)
            if cfg.post_norms:
                out = L.norm_apply(blk["ffn_post_norm"], out, cfg)
            h = h + out
    return h


def _run_stack(model, params, pool, x, attn_fn):
    cfg = model.branch_cfg
    _, _, sbs = params
    gpool = _grouped_pool(model, pool)
    for n, sb_params in enumerate(sbs):
        x = _stack_body(cfg, x, T.fetched(sb_params), _sb_pool(gpool, n),
                        attn_fn)
    return x


def _head(model, params, x):
    """Final norm + unembed of x [G, B, d] -> merged [B, vocab] f32."""
    cfg = model.branch_cfg
    emb, fnorm, _ = params
    x = L.norm_apply(fnorm, x, cfg)
    return model._merge(L.unembed_apply(emb, x, cfg))   # from [G, B, V/G]


def _block_size(pool: Dict) -> int:
    return next(iter(next(iter(pool.values())).values())).shape[-3]


def _decode_pass(model, pool, tokens, block_tables, lengths, active,
                 params):
    """One paged decode step through this rank's superblocks: (the stack's
    output [G, B, 1, d], the position picker, params)."""
    cfg = model.branch_cfg
    params = params or model.grouped_views()
    x = join_of(model).enter(
        lambda: L.embed_apply(params[0], tokens, cfg), tokens.shape)
    positions = lengths[:, None]
    wb, wo = write_slots(lengths, block_tables, active, _block_size(pool))
    valid_lens = (lengths + active.int()).int()
    attn = lambda p, hn, entry: _paged_attn(
        p, hn, cfg, positions=positions, pool=entry,
        block_tables=block_tables, valid_lens=valid_lens, wb=wb, wo=wo)
    x = _run_stack(model, params, pool, x, attn)
    return x, lambda h: h[:, :, -1], params


@torch.no_grad()
def paged_decode_logits(model, pool, tokens, block_tables, lengths, active,
                        params=None):
    """One paged decode step.  tokens: [B, 1]; lengths: [B] tokens already
    in cache (the new token's position); active: [B] bool.  Returns
    ([B, vocab] f32 logits, pool)."""
    x, select, params = _decode_pass(model, pool, tokens, block_tables,
                                     lengths, active, params)
    return _head(model, params, select(x)), pool


@torch.no_grad()
def paged_decode_tokens(model, pool, tokens, block_tables, lengths, active,
                        params=None):
    """:func:`paged_decode_logits`'s greedy tokens: ([B] int32, pool), on
    every rank of a mesh."""
    x, select, params = _decode_pass(model, pool, tokens, block_tables,
                                     lengths, active, params)
    return join_of(model).tokens(model, params, x, select), pool


def _chunk_pass(model, pool, tokens, starts, n_tok, block_tables, params):
    """One prefill chunk through this rank's superblocks: (the stack's
    output [G, B, C, d], the picker of each lane's last valid position,
    params)."""
    cfg = model.branch_cfg
    params = params or model.grouped_views()
    b, c = tokens.shape
    x = join_of(model).enter(
        lambda: L.embed_apply(params[0], tokens, cfg), tokens.shape)
    ar = torch.arange(c, device=tokens.device)
    positions = (starts[:, None] + ar[None, :]).int()
    wb, wo = chunk_write_slots(starts, n_tok, block_tables,
                               _block_size(pool), c)
    attn = lambda p, hn, entry: _paged_chunk_attn(
        p, hn, cfg, positions=positions, pool=entry,
        block_tables=block_tables, wb=wb, wo=wo)
    x = _run_stack(model, params, pool, x, attn)
    idx = (n_tok.long() - 1).clamp(0, c - 1)
    rows = torch.arange(b, device=x.device)
    return x, lambda h: h[:, rows, idx], params


@torch.no_grad()
def paged_chunk_logits(model, pool, tokens, starts, n_tok, block_tables,
                       params=None):
    """Chunked prefill: commit ``tokens`` [B, C] at absolute positions
    ``starts + [0..C)`` into the pool and return the [B, vocab] logits at
    each lane's last valid chunk position.  Padded token slots (>= n_tok)
    write to the null block and their outputs are never read."""
    x, select, params = _chunk_pass(model, pool, tokens, starts, n_tok,
                                    block_tables, params)
    return _head(model, params, select(x)), pool


# ---------------------------------------------------------------- factories
def make_prefill_chunk_fn(model, params=None):
    """(pool, toks [W, C], starts [W], n_tok [W], block_tables [W, NB]) ->
    ([W, vocab] last-valid-position logits, pool)."""
    def chunk(pool, toks, starts, n_tok, block_tables):
        return paged_chunk_logits(model, pool, toks, starts, n_tok,
                                  block_tables, params)
    return chunk


def make_prefill_fn(model, params=None):
    """(pool, toks [W, C], starts [W], n_tok [W], block_tables [W, NB]) ->
    (pool, [W] int32 greedy tokens at each lane's last valid position)."""
    @torch.no_grad()
    def chunk(pool, toks, starts, n_tok, block_tables):
        x, select, p = _chunk_pass(model, pool, toks, starts, n_tok,
                                   block_tables, params)
        return pool, join_of(model).tokens(model, p, x, select)
    return chunk


def make_decode_fn(model, *, scan_tokens: int, params=None):
    """K = ``scan_tokens`` greedy decode steps for every active lane.

    (pool, tok [B, 1], block_tables [B, NB], lengths [B], remaining [B]) ->
    (pool, tok', lengths', remaining', toks [B, K]), all on the device.
    A lane with remaining == 0 is inactive for the rest of the loop
    (null-block writes, frozen length, frozen token).  The params views
    are read once a call."""
    def decode(pool, tok, block_tables, lengths, remaining):
        p = params or model.grouped_views()
        steps = []
        for _ in range(scan_tokens):
            active = remaining > 0
            nxt, pool = paged_decode_tokens(model, pool, tok, block_tables,
                                            lengths, active, p)
            tok = torch.where(active, nxt, tok[:, 0])[:, None]
            lengths = lengths + active.int()
            remaining = remaining - active.int()
            steps.append(nxt)
        return pool, tok, lengths, remaining, torch.stack(steps, dim=1)
    return decode
