"""Core layers of the serving and training paths: init helpers, norms,
rotary embeddings, GQA attention (full-sequence, over a dense KV cache with
ring buffers, and cross-attention), dense MLPs, embedding and unembedding.

Functions over plain tensors and dicts of tensors (a ``ParamTree`` indexes
the same way), mirroring ``repro.models.layers``.  Weights may carry
leading batch dims (the superblock stack, the semantic split's branches);
callers slice them before use, so these functions see one layer's weights
with at most a leading branch dim that lines up with the activations'.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import decode_attention


def torch_dtype(cfg: ArchConfig) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg.dtype]


def normal_init(w: torch.Tensor, generator: torch.Generator,
                std: float) -> None:
    """Fill ``w`` in place with N(0, std^2), drawn in f32."""
    z = torch.randn(w.shape, generator=generator, device=w.device)
    w.copy_(z * std)


def dense_init(w: torch.Tensor, generator: torch.Generator) -> None:
    """Fill ``w`` [..., d_in, d_out] in place with N(0, 1/d_in), the
    distribution of the JAX ``dense_init`` (not its draws)."""
    z = torch.randn(w.shape, generator=generator, device=w.device)
    w.copy_(z / math.sqrt(w.shape[-2]))


def norm_shapes(cfg: ArchConfig, d: Optional[int] = None) -> dict:
    d = d or cfg.d_model
    if cfg.norm_type == "layernorm":
        return {"w": (d,), "b": (d,)}
    return {"w": (d,)}


def _align(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Broadcast a [..., d] weight against x [..., T, d] sharing leading
    (branch) dims: insert the missing middle dims."""
    extra = x.dim() - w.dim()
    return w.reshape(w.shape[:-1] + (1,) * extra + w.shape[-1:])


def norm_apply(params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """LayerNorm or RMSNorm in f32, cast back to x's dtype."""
    xf = x.float()
    w = _align(params["w"], x).float()
    if cfg.norm_type == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        out = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        out = out * w + _align(params["b"], x).float()
    else:
        ms = xf.square().mean(-1, keepdim=True)
        out = xf * torch.rsqrt(ms + cfg.norm_eps) * w
    return out.to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., seq, heads, hd]; positions: [..., seq] (broadcastable).
    Split-halves rotation, computed in f32 and cast back."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    angles = positions[..., :, None].float() * freqs       # [..., seq, hd/2]
    angles = angles[..., :, None, :]                       # [..., seq, 1, hd/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[..., S, K, hd] -> [..., S, K*n_rep, hd] (kv head k serves query
    heads k*n_rep .. k*n_rep+n_rep-1)."""
    if n_rep == 1:
        return x
    return torch.repeat_interleave(x, n_rep, dim=-2)


def sdpa(q, k, v, mask, *, softcap: float = 0.0) -> torch.Tensor:
    """q: [..., Sq, H, hd]; k, v: [..., Sk, H, hd]; mask broadcastable to
    [..., H, Sq, Sk].  Dense scaled-dot-product attention: f32 scores,
    masked to -1e30, probabilities cast to v's dtype."""
    hd = q.shape[-1]
    logits = torch.einsum("...qhd,...khd->...hqk", q.float(),
                          k.float()) / math.sqrt(hd)
    logits = _softcap(logits, softcap)
    logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("...hqk,...khd->...qhd", probs.to(v.dtype), v)


def causal_mask(sq: int, sk: int, *, window: int = 0,
                device=None) -> torch.Tensor:
    """[1, 1, sq, sk] boolean mask; queries at positions sk-sq .. sk-1."""
    qpos = torch.arange(sq, device=device)[:, None] + (sk - sq)
    kpos = torch.arange(sk, device=device)[None, :]
    m = kpos <= qpos
    if window:
        m &= kpos > (qpos - window)
    return m[None, None]


def _dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [(G,) B, S, D] @ w [(G,) D, E] -> [(G,) B, S, E]: B and S fold into
    one row dim, so a branch dim on both lines up."""
    return (x.flatten(-3, -2) @ w).unflatten(-2, x.shape[-3:-1])


def _self_attend(q, k, v, window: int, cfg: ArchConfig) -> torch.Tensor:
    """Self-attention of a sequence q [..., S, H, hd] over its own k/v
    [..., S, K, hd]: at ``S >= 2048`` through
    :func:`repro_torch.models.attention.attention` (the flash kernel
    forward, a chunked recompute backward), the leading dims folded into
    its batch dim; below, dense ``sdpa`` with the causal mask."""
    s, h, hd = q.shape[-3:]
    kv = k.shape[-2]
    if s >= 2048:
        from repro_torch.models.attention import attention
        out = attention(q.reshape(-1, s, h, hd), k.reshape(-1, s, kv, hd),
                        v.reshape(-1, s, kv, hd), causal=cfg.causal,
                        window=window, softcap=cfg.attn_softcap)
        return out.reshape(q.shape)
    mask = causal_mask(s, s, window=window, device=q.device) \
        if cfg.causal else torch.ones(1, 1, s, s, dtype=torch.bool,
                                      device=q.device)
    return sdpa(q, _repeat_kv(k, h // kv), _repeat_kv(v, h // kv), mask,
                softcap=cfg.attn_softcap)


def _cache_attend(q, k, v, kv_cache, cache_index: int, window: int,
                  cfg: ArchConfig) -> torch.Tensor:
    """Write this call's k/v [..., S, K, hd] into the dense cache (in
    place) and attend q [..., S, H, hd] over it.

    The write starts at ``cache_index`` (``cache_index % W`` in a ring
    buffer of window W), clamped to ``L - S`` as ``lax.dynamic_update_slice``
    clamps its start.  A decode step (S = 1) runs the ``decode_attention``
    kernel over the first ``min(cache_index + 1, W)`` slots of every lane
    (the reference's mask: ``kpos <= cache_index``, or the whole ring once
    it has wrapped), the leading dims folded into its batch; a prefill into
    the cache (S > 1) is the masked dense ``sdpa``, as the reference
    computes it outside any kernel."""
    ck, cv = kv_cache["k"], kv_cache["v"]
    s, h, hd = q.shape[-3], q.shape[-2], q.shape[-1]
    L, kv = ck.shape[-3], ck.shape[-2]
    W = min(window, L) if window else L
    slot = cache_index % W if window else cache_index
    slot = min(max(slot, 0), L - s)
    ck.narrow(-3, slot, s).copy_(k)
    cv.narrow(-3, slot, s).copy_(v)
    if s == 1:
        lanes = q.shape[:-3].numel()
        length = torch.full((lanes,), min(cache_index + 1, W),
                            dtype=torch.int32, device=q.device)
        out = decode_attention(q.reshape(lanes, h, hd),
                               ck.reshape(lanes, L, kv, hd),
                               cv.reshape(lanes, L, kv, hd), length,
                               softcap=cfg.attn_softcap)
        return out.reshape(q.shape)
    if s >= 2048 and cache_index == 0 and not window:
        # nothing precedes the prompt: its attention over the cache is its
        # own causal attention, on the flash path as without a cache
        return _self_attend(q, k, v, 0, cfg)
    kpos = torch.arange(L, device=q.device)[None, :]
    qpos = (cache_index + torch.arange(s, device=q.device))[:, None]
    valid = kpos < W if window and cache_index >= W else kpos <= qpos
    return sdpa(q, _repeat_kv(ck, h // kv), _repeat_kv(cv, h // kv),
                valid[None, None], softcap=cfg.attn_softcap)


#: flash-decoding's merges of the slabs' partial attention (one per
#: attention layer and call on a length-sharded cache)
FLASH_STATS = {"lse_merges": 0}


class CacheAxis(NamedTuple):
    """One rank's handle on the mesh axis that splits a cache's length
    (flash-decoding): the rank's slab ``index`` of ``size`` slabs, and
    ``merge(out, lse)``, which turns every rank's f32 partial ``out``
    [..., hd] (normalised over its own slab) and ``lse`` [...] into the
    softmax over all the slabs (a collective over the axis:
    ``dist.comm.merge_lse``).  The reference passes the axis name and its
    ``pmax`` / ``psum`` find the axis; here the runner that owns the mesh
    passes what the name would find."""
    index: int
    size: int
    merge: Callable


def _flash_decode_sharded(q, k, v, kv_cache, cache_index: int, window: int,
                          cfg: ArchConfig, axis: CacheAxis) -> torch.Tensor:
    """Attention over a cache whose LENGTH dim is split over a mesh axis
    (``repro.models.layers._flash_decode_sharded``): the rank at
    ``axis.index`` r holds global slots [r * L_loc, (r + 1) * L_loc) of
    every cache leaf [..., B, L_loc, K, hd].

    Only the slab owning a written slot stores it (global slot
    ``cache_index % W`` in a ring of W = min(window, A * L_loc), else
    ``cache_index`` clamped as one device clamps it).  A decode step (S =
    1) runs the ``decode_attention`` kernel over the slab's valid prefix,
    ``clamp(n_valid - r * L_loc, 0, L_loc)`` slots with ``n_valid = W``
    once the ring has wrapped, else ``cache_index + 1``, and returns each
    row's log-sum-exp with it; a prompt (S > 1, global attention) attends
    densely over its slab with the mask ``kpos <= qpos``.  The slabs'
    partials merge exactly (``axis.merge``, counted in ``FLASH_STATS``).
    A prompt at ``cache_index == 0`` sees only itself: every rank computes
    its causal attention directly, and nothing merges."""
    r, n_ax = axis.index, axis.size
    ck, cv = kv_cache["k"], kv_cache["v"]
    s, h, hd = q.shape[-3:]
    L_loc, kv = ck.shape[-3], ck.shape[-2]
    L_glob = n_ax * L_loc
    W = min(window, L_glob) if window else L_glob
    if s > 1 and window:
        raise ValueError("a prompt into a ring-buffer cache (window "
                         f"{window}) runs one token at a time")
    slot = cache_index % W if window else \
        min(max(cache_index, 0), L_glob - s)
    lo, hi = max(slot, r * L_loc), min(slot + s, (r + 1) * L_loc)
    if lo < hi:
        ck.narrow(-3, lo - r * L_loc, hi - lo).copy_(k.narrow(-3, lo - slot,
                                                              hi - lo))
        cv.narrow(-3, lo - r * L_loc, hi - lo).copy_(v.narrow(-3, lo - slot,
                                                              hi - lo))
    if s > 1 and cache_index == 0:
        return _self_attend(q, k, v, 0, cfg)
    if s == 1:
        n_valid = W if window and cache_index >= W else \
            min(cache_index + 1, L_glob)
        lanes = q.shape[:-3].numel()
        length = torch.full((lanes,), min(max(n_valid - r * L_loc, 0), L_loc),
                            dtype=torch.int32, device=q.device)
        out, lse = decode_attention(
            q.reshape(lanes, h, hd), ck.reshape(lanes, L_loc, kv, hd),
            cv.reshape(lanes, L_loc, kv, hd), length,
            softcap=cfg.attn_softcap, return_lse=True)
        out = out.reshape(q.shape)
        lse = lse.reshape(q.shape[:-1])
    else:
        kpos = r * L_loc + torch.arange(L_loc, device=q.device)[None, :]
        qpos = (cache_index + torch.arange(s, device=q.device))[:, None]
        out, lse = ref.attention_lse_ref(q, ck, cv, kpos <= qpos,
                                         softcap=cfg.attn_softcap)
    FLASH_STATS["lse_merges"] += 1
    return axis.merge(out, lse).to(q.dtype)


def attn_apply(params, x, cfg: ArchConfig, *, positions, window: int = 0,
               kv_cache=None, cache_index=None, kv_override=None,
               cache_axis=None):
    """GQA attention.  x: [(G,) B, S, d] with weights [(G,) d, e];
    positions: [1, S].  Returns ``(out, cache)``, as the JAX ``attn_apply``
    returns ``(out, new_cache)``.

    - Training / full prefill (``kv_cache`` None): causal self-attention
      over the sequence.  At ``S >= 2048`` through :func:`repro_torch.
      models.attention.attention` (the flash kernel forward, a chunked
      recompute backward), the branches folded into its batch dim; below,
      dense ``sdpa`` with the causal mask.
    - Dense cache (the legacy gang path): ``kv_cache = {"k", "v"}`` with
      leaves [(G,) B, L, K, hd], written in place at the Python int
      ``cache_index`` (see :func:`_cache_attend`); the returned cache is
      the same dict.
    - Cross-attention: ``kv_override = (k, v)``, the encoder's K/V
      [(G,) B, S_enc, K, hd]; no RoPE, every key visible.

    - Length-sharded cache (flash-decoding): ``cache_axis``, a
      :class:`CacheAxis`, is this rank's slab of the cache length and the
      merge of the ranks' partials (see :func:`_flash_decode_sharded`).
    """
    s = x.shape[-2]
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = _dense(x, params["wq"]).unflatten(-1, (h, hd))
    if kv_override is not None:
        k, v = kv_override
        mask = torch.ones(1, 1, s, k.shape[-3], dtype=torch.bool,
                          device=x.device)
        out = sdpa(q, _repeat_kv(k, h // k.shape[-2]),
                   _repeat_kv(v, h // v.shape[-2]), mask,
                   softcap=cfg.attn_softcap)
    else:
        k = _dense(x, params["wk"]).unflatten(-1, (kv, hd))
        v = _dense(x, params["wv"]).unflatten(-1, (kv, hd))
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        if kv_cache is not None and cache_axis is not None:
            out = _flash_decode_sharded(q, k, v, kv_cache, cache_index,
                                        window, cfg, cache_axis)
        elif kv_cache is not None:
            out = _cache_attend(q, k, v, kv_cache, cache_index, window, cfg)
        else:
            out = _self_attend(q, k, v, window, cfg)
    out = out.reshape(x.shape[:-1] + (h * hd,))
    return _dense(out, params["wo"]), kv_cache


def cross_kv(params, enc_out: torch.Tensor, cfg: ArchConfig):
    """The encoder's K, V for cross-attention (computed once per request):
    enc_out [(G,) B, S_enc, d] -> two [(G,) B, S_enc, K, hd]."""
    kv, hd = cfg.n_kv_heads, cfg.hd
    return (_dense(enc_out, params["wk"]).unflatten(-1, (kv, hd)),
            _dense(enc_out, params["wv"]).unflatten(-1, (kv, hd)))


def mlp_shapes(cfg: ArchConfig, d_ff: Optional[int] = None,
               lead: tuple = ()) -> dict:
    """Leaf shapes of a dense MLP of hidden width ``d_ff`` (default
    ``cfg.d_ff``), with ``lead`` dims in front (an expert dim), as
    ``mlp_init(key, cfg, d_ff=...)`` (vmapped over experts) lays them out."""
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    if cfg.mlp_type == "swiglu":
        shapes = {"wg": (d, ff), "wu": (d, ff), "wd": (ff, d)}
    else:
        shapes = {"wu": (d, ff), "wd": (ff, d)}
    return {k: tuple(lead) + v for k, v in shapes.items()}


def mlp_apply(params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """x [..., T, d] @ weights [..., d, f] (matching leading dims: a branch
    dim, an expert dim); the hidden width is the weights'."""
    if "wg" in params:
        return (F.silu(x @ params["wg"]) * (x @ params["wu"])) @ params["wd"]
    return F.gelu(x @ params["wu"], approximate="tanh") @ params["wd"]


def _softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    if cap and cap > 0:
        return torch.tanh(logits / cap) * cap
    return logits


def embed_apply(params, tokens: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """tok [..., V, d] gathered at ``tokens`` -> [..., *tokens.shape, d].
    Ids past the table clamp to its last row, as a JAX gather does (a
    semantic branch embeds full-vocab ids with its vocab shard), and, as in
    JAX, such an id sends no gradient to the row it read."""
    tok = params["tok"]
    ids = tokens.long()
    idx = ids.clamp(0, tok.shape[-2] - 1)
    x = tok[..., idx, :]
    if x.requires_grad:
        x = torch.where((ids == idx)[..., None], x, x.detach())
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    return x


def unembed_apply(params, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """x [..., T, d] -> f32 logits [..., T, vocab] with the final softcap."""
    w = params["tok"].transpose(-1, -2) if cfg.tie_embeddings \
        else params["head"]
    logits = x @ w.to(x.dtype)
    return _softcap(logits.float(), cfg.final_softcap)
