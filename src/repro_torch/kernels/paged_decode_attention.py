"""Paged single-token decode attention: Hopper kernel, wrapper and plain
version.

Replaces the Pallas TPU kernel ``paged_decode_attention``
(src/repro/kernels/paged_decode_attention.py, ``_paged_kernel``).  The CUDA
kernel (``csrc/paged_attention.cu``, path ``decode_split``) is bound by the
bytes of K/V it reads (about 1 flop per bf16 byte), so its design is about
bytes in flight: a CTA takes a group of kv heads of one lane (a token's K
row for the group is one contiguous read, 16-byte loads spread over the
threads) and all their query heads, the lane's length is cut into pieces
over the CTAs of a cluster, token groups inside a CTA each keep an f32
online softmax over the tokens they visit, and the groups and then the
pieces merge in a fixed order inside the one launch
(:func:`paged_decode_attention_emulated` walks the same steps in plain
PyTorch).  int8 codes are scaled in registers.  Tables may alias blocks
across lanes (prefix sharing): the pool is only read.

A leading branch dim on q and the pools (the semantic split's branches, each
with its own pool; tables and lengths shared) folds into one launch.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _paged_launch, ref
from repro_torch.kernels._paged_launch import launch


def paged_decode_attention_plain(q, k_pool, v_pool, block_tables, lengths, *,
                                 k_scale=None, v_scale=None, softcap=0.0):
    """The kernel's function in plain PyTorch (the CPU path, and the
    kernel's yardstick on the card).  Shapes as :func:`paged_decode_attention`.
    A length-0 row returns 0, as the kernel's acc / max(l, 1e-20) does."""
    if q.dim() == 4:
        return torch.stack([paged_decode_attention_plain(
            q[i], k_pool[i], v_pool[i], block_tables, lengths,
            k_scale=None if k_scale is None else k_scale[i],
            v_scale=None if v_scale is None else v_scale[i],
            softcap=softcap) for i in range(q.shape[0])])
    out = ref.paged_decode_attention_ref(q, k_pool, v_pool, block_tables,
                                         lengths, k_scale=k_scale,
                                         v_scale=v_scale, softcap=softcap)
    return torch.where((lengths > 0).to(out.device)[:, None, None], out,
                       torch.zeros_like(out))


def _merge(m, l, acc, mo, lo, ao):
    """Two online-softmax states merged as the kernel merges them."""
    mn = torch.maximum(m, mo)
    c, co = torch.exp(m - mn), torch.exp(mo - mn)
    return mn, l * c + lo * co, acc * c[..., None] + ao * co[..., None]


def paged_decode_attention_emulated(q, k_pool, v_pool, block_tables,
                                    lengths, *, k_scale=None, v_scale=None,
                                    softcap=0.0, n_sm: int = 132,
                                    drop_piece=None):
    """The ``decode_split`` kernel's walk in plain PyTorch: the pieces,
    kv-head groups and token groups that ``_paged_launch.decode_plan`` gives
    for ``n_sm`` SMs; in each piece, token group ``j`` of ``ng`` visits
    tokens ``base + u * ng + j`` (u < the tokens in flight) of each
    64-block window, keeping f32 max, sum and accumulator (scores from the
    scaled query, times the slot's K scale, softcapped, masked past the
    length; p times the slot's V scale on V); the groups merge in order (the
    kernel's butterfly and warp order differ from it only in f32 rounding),
    then the pieces in order from 0, and the output is acc / max(l, 1e-20).
    ``drop_piece`` leaves that piece out of every lane, as a faulty kernel
    would: the checks must reject it.  Shapes as
    :func:`paged_decode_attention`."""
    if q.dim() == 4:
        return torch.stack([paged_decode_attention_emulated(
            q[i], k_pool[i], v_pool[i], block_tables, lengths,
            k_scale=None if k_scale is None else k_scale[i],
            v_scale=None if v_scale is None else v_scale[i],
            softcap=softcap, n_sm=n_sm, drop_piece=drop_piece)
            for i in range(q.shape[0])])
    b, h, hd = q.shape
    _, bs, kh, _ = k_pool.shape
    nb = block_tables.shape[1]
    rep = h // kh
    hg, rt, pieces, piece = _paged_launch.decode_plan(
        h=h, kh=kh, hd=hd, kv_item=k_pool.element_size(), b=b, g=1, nb=nb,
        bs=bs, n_sm=n_sm)
    ng = _paged_launch.token_groups(hg, hd, k_pool.element_size())
    u_n = _paged_launch.tokens_in_flight(rt)
    window = 64 * bs
    qs = q.float() / math.sqrt(hd)                              # [H, hd]
    kflat = k_pool.reshape(-1, kh, hd)
    vflat = v_pool.reshape(-1, kh, hd)
    neg = torch.tensor(ref.NEG_INF)
    out = torch.zeros(b, h, hd, dtype=torch.float32, device=q.device)
    for lane in range(b):
        length = min(max(int(lengths[lane]), 0), nb * bs)
        table = block_tables[lane].long()
        pm = torch.full((h,), ref.NEG_INF)
        pl = torch.zeros(h)
        pa = torch.zeros(h, hd)
        for pi in range(pieces):
            t0, t1 = pi * piece, min(length, pi * piece + piece)
            m = torch.full((ng, h), ref.NEG_INF)
            l = torch.zeros(ng, h)
            acc = torch.zeros(ng, h, hd)
            for w0 in range(t0, t1, window) if pi != drop_piece else ():
                w1 = min(t1, w0 + window)
                for base in range(w0, w1, ng * u_n):
                    tok = base + torch.arange(u_n)[:, None] * ng \
                        + torch.arange(ng)[None, :]             # [U, NG]
                    ok = tok < w1
                    tc = tok.clamp(max=w1 - 1)
                    slot = table[tc // bs] * bs + tc % bs
                    kt = kflat[slot].float().repeat_interleave(rep, -2)
                    vt = vflat[slot].float().repeat_interleave(rep, -2)
                    s = torch.einsum("hd,unhd->unh", qs[lane], kt)
                    if k_scale is not None:
                        s = s * k_scale.reshape(-1, kh)[slot] \
                            .repeat_interleave(rep, -1)
                    if softcap:
                        s = torch.tanh(s / softcap) * softcap
                    s = torch.where(ok[..., None], s, neg)
                    mx = torch.maximum(m, s.amax(0))
                    alpha = torch.exp(m - mx)
                    p = torch.exp(s - mx) * ok[..., None]
                    l = l * alpha + p.sum(0)
                    if v_scale is not None:
                        p = p * v_scale.reshape(-1, kh)[slot] \
                            .repeat_interleave(rep, -1)
                    acc = acc * alpha[..., None] + torch.einsum(
                        "unh,unhd->nhd", p, vt)
                    m = mx
            cm, cl, ca = m[0], l[0], acc[0]
            for j in range(1, ng):
                cm, cl, ca = _merge(cm, cl, ca, m[j], l[j], acc[j])
            pm, pl, pa = _merge(pm, pl, pa, cm, cl, ca)
        out[lane] = pa / pl.clamp(min=1e-20)[:, None]
    return out.to(q.dtype)


def paged_decode_attention(q, k_pool, v_pool, block_tables, lengths, *,
                           k_scale=None, v_scale=None, softcap: float = 0.0):
    """q: [B, H, hd], or [G, B, H, hd] with a branch dim; k/v_pool:
    [P, bs, K, hd] (or [G, P, bs, K, hd]) in q's dtype, or int8 with f32
    ``k/v_scale`` [P, bs, K]; block_tables: [B, NB] int32; lengths: [B]
    int32 valid tokens.  Returns q's shape and dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel (and
    count the launch in ``paged_decode_attention.launches``) or raise."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(
            q, k_pool, v_pool, block_tables, lengths, k_scale=k_scale,
            v_scale=v_scale, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: no kernel for {q.device}")
    lead = q.dim() == 4
    out = launch("paged_decode_attention_launch",
                 q if lead else q.unsqueeze(0), k_pool, v_pool, block_tables,
                 lengths, k_scale=k_scale, v_scale=v_scale, softcap=softcap,
                 chunk=False)
    paged_decode_attention.launches += 1
    return out if lead else out[0]


paged_decode_attention.launches = 0
