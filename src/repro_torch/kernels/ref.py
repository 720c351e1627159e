"""Plain PyTorch oracles for every kernel (the allclose targets), one to one
with the jnp versions of the JAX package (``repro.kernels.ref``).

Each attention oracle runs a masked softmax in float32 (the paged ones over
the block table gathered into a dense cache); the result is cast back to
q's dtype.  Masked scores are -1e30, as in the jnp versions, so a row with
no valid key averages over every key (callers never read such rows).
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _repeat_heads(x, rep: int):
    """[..., K, hd] -> [..., K*rep, hd] (kv head k serves query heads
    k*rep .. k*rep+rep-1)."""
    return x if rep == 1 else torch.repeat_interleave(x, rep, dim=-2)


def flash_attention_ref(q, k, v, *, causal=True, window=0, softcap=0.0):
    """Dense oracle of the flash-attention kernel.  q: [B, Sq, H, hd];
    k, v: [B, Sk, K, hd]; queries at positions Sk - Sq .. Sk - 1."""
    b, sq, h, hd = q.shape
    sk, kh = k.shape[1], k.shape[2]
    k = _repeat_heads(k, h // kh).float()
    v = _repeat_heads(v, h // kh).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k) / math.sqrt(hd)
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    qpos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > (qpos - window)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v).to(q.dtype)


def block_diag_matmul_ref(x, w):
    """Per-branch product: x [Bb, T, d] @ w [Bb, d, e] in f32, cast to x's
    dtype."""
    return torch.einsum("btd,bde->bte", x.float(), w.float()).to(x.dtype)


def block_diag_dense_ref(x, w):
    """The dense equivalent: one [T, Bb*d] @ [Bb*d, Bb*e] product against
    the block-diagonal embedding of w."""
    bb, t, d = x.shape
    e = w.shape[2]
    big = torch.zeros(bb * d, bb * e, dtype=torch.float32, device=x.device)
    for i in range(bb):
        big[i * d:(i + 1) * d, i * e:(i + 1) * e] = w[i].float()
    xf = x.transpose(0, 1).reshape(t, bb * d).float()
    out = xf @ big
    return out.reshape(t, bb, e).transpose(0, 1).to(x.dtype)


def moe_gmm_ref(x, w):
    """Per-expert product: x [E, C, d] @ w [E, d, f] in f32, cast to x's
    dtype."""
    return torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(x.dtype)


def ssm_scan_ref(a, b):
    """h_t = a_t h_{t-1} + b_t along axis 1 of [B, S, D, N], the state in
    f32 from h_{-1} = 0, the output in a's dtype (a loop over S, as the
    jnp version's ``lax.scan``)."""
    h = torch.zeros(a.shape[:1] + a.shape[2:], dtype=torch.float32,
                    device=a.device)
    out = torch.empty(a.shape, dtype=a.dtype, device=a.device)
    for t in range(a.shape[1]):
        h = a[:, t].float() * h + b[:, t].float()
        out[:, t] = h
    return out


def decode_attention_ref(q, k_cache, v_cache, length, *, softcap=0.0):
    """q: [B, H, hd]; k/v_cache: [B, L, K, hd]; length: [B] valid slots."""
    b, h, hd = q.shape
    L, kh = k_cache.shape[1], k_cache.shape[2]
    k = _repeat_heads(k_cache, h // kh).float()
    v = _repeat_heads(v_cache, h // kh).float()
    s = torch.einsum("bhd,blhd->bhl", q.float(), k) / math.sqrt(hd)
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    valid = torch.arange(L, device=q.device)[None, None, :] \
        < length.to(q.device)[:, None, None]
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhl,blhd->bhd", p, v).to(q.dtype)


def attention_lse_ref(q, k, v, valid, *, softcap=0.0):
    """Masked attention of q [..., S, H, hd] over k/v [..., L, K, hd] with
    one pass over the scores (``valid`` broadcasts against them, [..., H,
    S, L]): the f32 output [..., S, H, hd] and each row's log-sum-exp
    [..., S, H] of its valid (softcapped) scores.  Unlike the oracles
    above, a row with no valid key gives 0 and -inf: partial results over
    slabs of one cache merge through their log-sum-exps."""
    h, hd = q.shape[-2], q.shape[-1]
    kk = _repeat_heads(k, h // k.shape[-2]).float()
    vv = _repeat_heads(v, h // v.shape[-2]).float()
    s = torch.einsum("...qhd,...khd->...hqk", q.float(), kk) / math.sqrt(hd)
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    s = torch.where(valid, s, -math.inf)
    lse = torch.logsumexp(s, dim=-1)                     # [..., H, S]
    p = torch.exp(s - torch.where(torch.isfinite(lse), lse, 0.0)[..., None])
    out = torch.einsum("...hqk,...khd->...qhd", p, vv)
    return out, lse.transpose(-1, -2)


def dequant_pool_ref(pool, scale):
    """Dequantize an int8 KV pool [P, bs, K, hd] with per-token-slot scales
    [P, bs, K].  Identity for ``scale=None`` (float pools)."""
    if scale is None:
        return pool
    return pool.float() * scale[..., None]


def _gather(pool, scale, block_tables):
    """[P, bs, K, hd] pool -> dense [B, NB*bs, K, hd] through the table."""
    d = dequant_pool_ref(pool, scale)[block_tables.long()]
    b, nb, bs, kh, hd = d.shape
    return d.reshape(b, nb * bs, kh, hd)


def paged_decode_attention_ref(q, k_pool, v_pool, block_tables, lengths, *,
                               k_scale=None, v_scale=None, softcap=0.0):
    """Dense-gather oracle for the paged decode kernel.  q: [B, H, hd];
    k/v_pool: [P, bs, K, hd]; block_tables: [B, NB]; lengths: [B]."""
    k = _gather(k_pool, k_scale, block_tables)
    v = _gather(v_pool, v_scale, block_tables)
    return decode_attention_ref(q, k, v, lengths, softcap=softcap)


def paged_prefill_attention_ref(q, k_pool, v_pool, block_tables, positions, *,
                                k_scale=None, v_scale=None, softcap=0.0):
    """Chunked-prefill oracle.  q: [B, C, H, hd] at absolute ``positions``
    [B, C]; the pools already hold the chunk's K/V.  The causal rule
    ``kpos <= qpos`` covers the cached prefix and the in-chunk triangle."""
    kd = _gather(k_pool, k_scale, block_tables)
    vd = _gather(v_pool, v_scale, block_tables)
    h, kh = q.shape[2], kd.shape[2]
    kd = _repeat_heads(kd, h // kh).float()
    vd = _repeat_heads(vd, h // kh).float()
    hd = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kd) / math.sqrt(hd)
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    kpos = torch.arange(kd.shape[1], device=q.device)[None, None, None, :]
    mask = kpos <= positions.to(q.device)[:, None, :, None]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vd).to(q.dtype)


def quant_matmul_ref(x, q, scales, *, bits=None):
    """Dequantize-then-matmul oracle for the blockwise quant GEMM kernel:
    x [..., T, D] @ dequant(q, scales) [..., D, E] in f32, cast to x's
    dtype."""
    from repro_torch.kernels.quant_matmul import (dequantize_blockwise,
                                                  infer_bits)
    if bits is None:
        bits = infer_bits(x.shape[-1], q)
    w = dequantize_blockwise(q, scales, bits=bits)
    return (x.float() @ w).to(x.dtype)
