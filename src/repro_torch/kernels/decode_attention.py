"""Single-token GQA decode attention over a contiguous KV cache: Hopper
kernel, wrapper and plain version.

Replaces the Pallas TPU kernel ``decode_attention``
(src/repro/kernels/decode_attention.py, ``_decode_kernel``): one query
token per lane against its [L, K, hd] cache, valid slots ``t < length``,
an optional logit softcap, the GQA group's query heads riding together so
each kv head's cache is read once.  The CUDA kernel
(``csrc/decode_attention.cu``) splits the cache into 256-slot pieces, one
CTA per (piece, kv head's head group, lane), stops at the lane's length,
and merges the pieces' online-softmax states in a second pass; it is bound
by the bytes of K/V it reads.

A row with ``length == 0`` is 0 here, as in the TPU kernel (its
``acc / max(l, 1e-20)`` with nothing accumulated).  With ``return_lse``
each row's f32 log-sum-exp [B, H] of its valid scores comes back too (-inf
for a length-0 row), and the output is f32: partial results over slabs of
one cache then merge exactly, before any rounding, which is how
flash-decoding over a length-sharded cache (``models.layers``) combines
the ranks' slabs.  The dense oracle
``ref.decode_attention_ref`` instead returns the mean of v there (a
softmax over all-masked scores is uniform); ``ops.decode_attention`` with
``use_kernels(False)`` follows the oracle, as the JAX ``ops`` does.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._decode_launch import CHUNK, dry_launch, launch


def decode_attention_plain(q, k_cache, v_cache, length, *,
                           softcap: float = 0.0, return_lse: bool = False):
    """The kernel's function in plain PyTorch (the CPU path, and the
    kernel's yardstick on the card): the dense oracle, with length-0 rows
    set to 0 as the kernel returns them; with ``return_lse`` in f32, and
    the rows' log-sum-exp (``ref.attention_lse_ref``)."""
    if return_lse:
        valid = torch.arange(k_cache.shape[1], device=q.device)[None, :] \
            < length.to(q.device)[:, None]                   # [B, L]
        out, lse = ref.attention_lse_ref(q[:, None], k_cache, v_cache,
                                         valid[:, None, None],
                                         softcap=softcap)
        return out[:, 0], lse[:, 0]
    out = ref.decode_attention_ref(q, k_cache, v_cache, length,
                                   softcap=softcap)
    return torch.where((length > 0).to(out.device)[:, None, None], out,
                       torch.zeros_like(out))


def decode_attention_emulated(q, k_cache, v_cache, length, *,
                              softcap: float = 0.0, drop_piece=None):
    """The CUDA kernel's walk in plain PyTorch, returning (out, lse): the
    cache cut into ``CHUNK``-slot pieces (one CTA each), in each piece
    token group ``j`` of ``ng`` visiting slots ``base + u * ng + j`` (4
    slots in flight) with its own f32 max, sum and accumulator over the
    scaled, softcapped scores; the groups merged against their common max
    (the CTA's shared-memory merge), then, past one piece, the pieces in
    order from 0 as ``decode_merge_kernel`` merges them; the output in f32,
    as the kernel's log-sum-exp entry writes it.  ``drop_piece``
    leaves that piece out of every lane, as a faulty kernel would: the
    checks must reject it.  Shapes as :func:`decode_attention`."""
    b, h, hd = q.shape
    L, kh = k_cache.shape[1], k_cache.shape[2]
    vec = 16 // q.element_size()
    ng = 128 // 32 * (32 // (hd // vec))
    u_n = 4
    splits = max(1, -(-L // CHUNK))
    neg = ref.NEG_INF
    qs = q.float() * (1.0 / math.sqrt(hd))
    out = torch.zeros(b, h, hd)
    lse = torch.full((b, h), -math.inf)
    for lane in range(b):
        n = min(max(int(length[lane]), 0), L)
        kf = ref._repeat_heads(k_cache[lane], h // kh).float()   # [L, H, hd]
        vf = ref._repeat_heads(v_cache[lane], h // kh).float()
        big_m, big_l, big_a = torch.full((h,), neg), torch.zeros(h), \
            torch.zeros(h, hd)
        for sp in range(-(-n // CHUNK)):
            t0, t1 = sp * CHUNK, min(n, sp * CHUNK + CHUNK)
            m = torch.full((ng, h), neg)
            l = torch.zeros(ng, h)
            acc = torch.zeros(ng, h, hd)
            for base in range(t0, t1, ng * u_n) if sp != drop_piece else ():
                tok = base + torch.arange(u_n)[:, None] * ng \
                    + torch.arange(ng)[None, :]                  # [U, NG]
                ok = (tok < t1)[..., None]
                tk = tok.clamp(max=L - 1)
                s = (kf[tk] * qs[lane]).sum(-1)                  # [U, NG, H]
                if softcap:
                    s = torch.tanh(s / softcap) * softcap
                s = torch.where(ok, s, torch.tensor(neg))
                mx = torch.maximum(m, s.max(0).values)
                alpha = torch.exp(m - mx)
                p = torch.where(ok, torch.exp(s - mx), torch.tensor(0.0))
                l = l * alpha + p.sum(0)
                acc = acc * alpha[..., None] + torch.einsum(
                    "ugh,ughd->ghd", p, vf[tk])
                m = mx
            mc = m.max(0).values                                 # [H]
            c = torch.exp(m - mc)
            ls, a = (l * c).sum(0), (acc * c[..., None]).sum(0)
            if splits == 1:
                big_m, big_l, big_a = mc, ls, a
                continue
            m_new = torch.maximum(big_m, mc)
            c_old, c_new = torch.exp(big_m - m_new), torch.exp(mc - m_new)
            big_l = big_l * c_old + ls * c_new
            big_a = big_a * c_old[:, None] + a * c_new[:, None]
            big_m = m_new
        out[lane] = big_a / big_l.clamp_min(1e-20)[:, None]
        lse[lane] = torch.where(big_l > 0, big_m + torch.log(big_l),
                                torch.tensor(-math.inf))
    return out, lse


def decode_attention(q, k_cache, v_cache, length, *, softcap: float = 0.0,
                     return_lse: bool = False):
    """q [B, H, hd] (one token per lane); k/v_cache [B, L, K, hd] (GQA:
    H % K == 0); length [B] valid slots (int32 on the cache's device for
    the kernel).  Returns [B, H, hd] in q's dtype, or with ``return_lse``
    the pair (f32 out, f32 lse [B, H]).

    CPU tensors take the plain version; CUDA tensors launch the kernel (and
    count the launch in ``decode_attention.launches``) or raise; meta
    tensors (the dry run) are checked as a CUDA launch would be, the
    predicted launch counted in ``decode_attention.dry_launches`` (the real
    count moves only where a kernel launches), what the launch allocates
    allocated on meta and the call's work added to ``cost.DRYRUN``."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, length,
                                      softcap=softcap, return_lse=return_lse)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"decode_attention: no kernel for {q.device}")
    if q.device.type == "meta":
        decode_attention.dry_launches += 1
        return dry_launch(q, k_cache, v_cache, length, softcap=softcap,
                          return_lse=return_lse)
    out = launch(q, k_cache, v_cache, length, softcap=softcap,
                 return_lse=return_lse)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
decode_attention.dry_launches = 0
