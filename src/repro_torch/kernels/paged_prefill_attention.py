"""Paged chunked-prefill attention: Hopper kernel, wrapper and plain
version.

Replaces the Pallas TPU kernel ``paged_prefill_attention``
(src/repro/kernels/paged_prefill_attention.py, ``_chunk_kernel``).  The CUDA
kernels live in ``csrc/paged_attention.cu``: one CTA per (lane, kv head,
branch x tile of query rows), walking the block table only up to the tile's
last position with f32 online-softmax state, and the absolute causal rule
``kpos <= qpos`` covering the cached prefix and the in-chunk triangle.  A
bf16 q (over bf16 or int8 pools) takes the tensor-core kernel: 64 query rows
per CTA, 64-token K/V tiles gathered with ``cp.async`` into a 2-stage ring,
both products on bf16 ``mma.sync`` with f32 accumulation, P rounded to bf16
for P·V (:func:`paged_prefill_attention_emulated` walks the same tiles in
plain PyTorch).  An f32 q keeps the CUDA-core kernel (32 rows per CTA, f32
products: tensor cores would mean TF32).  Padded query slots (positions past
a lane's ``n_tok``) may reach past the table: the walk is clipped to NB
blocks, and their rows are never read by the caller.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._paged_launch import launch


def paged_prefill_attention_plain(q, k_pool, v_pool, block_tables, positions,
                                  *, k_scale=None, v_scale=None, softcap=0.0):
    """The kernel's function in plain PyTorch (the CPU path, and the
    kernel's yardstick on the card).  Shapes as
    :func:`paged_prefill_attention`."""
    if q.dim() == 5:
        return torch.stack([paged_prefill_attention_plain(
            q[i], k_pool[i], v_pool[i], block_tables, positions,
            k_scale=None if k_scale is None else k_scale[i],
            v_scale=None if v_scale is None else v_scale[i],
            softcap=softcap) for i in range(q.shape[0])])
    return ref.paged_prefill_attention_ref(q, k_pool, v_pool, block_tables,
                                           positions, k_scale=k_scale,
                                           v_scale=v_scale, softcap=softcap)


#: query rows per CTA and K/V tokens per tile of the tensor-core kernel
MMA_ROWS = MMA_TILE = 64


def paged_prefill_attention_emulated(q, k_pool, v_pool, block_tables,
                                     positions, *, k_scale=None,
                                     v_scale=None, softcap=0.0):
    """The tensor-core kernel's numerics in plain PyTorch, for bf16 q: for
    each lane and tile of ``MMA_ROWS`` query rows of a kv head (row = c *
    rep + r), ``MMA_TILE``-token K/V tiles walked through the table up to
    the tile's last position (clipped to NB blocks), f32 scores scaled (and,
    for int8 pools, times each slot's K scale), softcapped and masked; f32
    running max, sum and accumulator; P times each slot's V scale (int8)
    rounded to bf16 before P·V, the sum over the unrounded P.  Shapes as
    :func:`paged_prefill_attention`."""
    if q.dim() == 5:
        return torch.stack([paged_prefill_attention_emulated(
            q[i], k_pool[i], v_pool[i], block_tables, positions,
            k_scale=None if k_scale is None else k_scale[i],
            v_scale=None if v_scale is None else v_scale[i],
            softcap=softcap) for i in range(q.shape[0])])
    b, c, h, hd = q.shape
    _, bs, kh, _ = k_pool.shape
    rep, nb = h // kh, block_tables.shape[1]
    scale = 1.0 / math.sqrt(hd)
    rows = c * rep
    qg = q.reshape(b, c, kh, rep, hd).transpose(1, 2).reshape(
        b, kh, rows, hd).float()
    qpos = positions.long().repeat_interleave(rep, dim=1)       # [B, rows]
    kflat = k_pool.reshape(-1, kh, hd)
    vflat = v_pool.reshape(-1, kh, hd)
    out = torch.zeros(b, kh, rows, hd, dtype=torch.float32, device=q.device)
    for lane in range(b):
        table = block_tables[lane].long()
        for r0 in range(0, rows, MMA_ROWS):
            qt = qg[lane, :, r0:r0 + MMA_ROWS]
            qp = qpos[lane, r0:r0 + MMA_ROWS]
            kv_len = min(int(qp.max()) + 1, nb * bs)
            m = torch.full(qt.shape[:2], ref.NEG_INF, device=q.device)
            l = torch.zeros(qt.shape[:2], device=q.device)
            acc = torch.zeros(qt.shape, device=q.device)
            for t0 in range(0, kv_len, MMA_TILE):
                kpos = torch.arange(t0, t0 + MMA_TILE, device=q.device)
                valid = kpos < kv_len
                slot = table[kpos.clamp(max=kv_len - 1) // bs] * bs + kpos % bs
                zero = (~valid)[:, None, None]
                kt = kflat[slot].float().masked_fill(zero, 0)   # [T, K, hd]
                vt = vflat[slot].float().masked_fill(zero, 0)
                s = torch.einsum("krd,tkd->krt", qt, kt) * scale
                if k_scale is not None:
                    s = s * k_scale.reshape(-1, kh)[slot].T[:, None, :]
                if softcap:
                    s = torch.tanh(s / softcap) * softcap
                ok = (kpos[None, :] <= qp[:, None]) & valid[None, :]
                s = s.masked_fill(~ok, float("-inf"))
                m_new = torch.maximum(m, s.amax(-1))
                alpha = torch.exp(m - m_new)
                p = torch.exp(s - m_new[..., None])
                l = l * alpha + p.sum(-1)
                if v_scale is not None:
                    p = p * v_scale.reshape(-1, kh)[slot].T[:, None, :]
                pb = p.to(torch.bfloat16).float()
                acc = acc * alpha[..., None] + torch.einsum(
                    "krt,tkd->krd", pb, vt)
                m = m_new
            out[lane, :, r0:r0 + MMA_ROWS] = acc / l.clamp(
                min=1e-20)[..., None]
    return out.reshape(b, kh, c, rep, hd).transpose(1, 2).reshape(
        b, c, h, hd).to(q.dtype)


#: query rows per CTA of the CUDA-core kernel (f32 q), and its K/V tile:
#: 32 tokens, 16 at head dim 128 (where 32 would pass the kernel's 48 KB of
#: static shared memory)
SIMT_ROWS = 32


def simt_tile(hd: int) -> int:
    return 16 if hd > 64 else 32


def paged_prefill_attention_simt_emulated(q, k_pool, v_pool, block_tables,
                                          positions, *, k_scale=None,
                                          v_scale=None, softcap=0.0,
                                          drop_tile=None):
    """The CUDA-core kernel's numerics (``prefill_simt``, f32 q) in plain
    PyTorch: for each lane and tile of ``SIMT_ROWS`` query rows of a kv
    head (row = c * rep + r), K/V tiles of :func:`simt_tile` tokens walked
    through the table up to the tile's last position (clipped to NB
    blocks), each dequantized into f32 (int8: times its slot's scale); the
    queries pre-scaled by 1/sqrt(hd), scores softcapped and masked (key
    position <= query position), the running max starting at -1e30; f32
    max, sum and accumulator, P unrounded.  ``drop_tile`` leaves that tile
    index out of every walk, as a faulty kernel would.  Shapes as
    :func:`paged_prefill_attention`."""
    if q.dim() == 5:
        return torch.stack([paged_prefill_attention_simt_emulated(
            q[i], k_pool[i], v_pool[i], block_tables, positions,
            k_scale=None if k_scale is None else k_scale[i],
            v_scale=None if v_scale is None else v_scale[i],
            softcap=softcap, drop_tile=drop_tile) for i in range(q.shape[0])])
    b, c, h, hd = q.shape
    _, bs, kh, _ = k_pool.shape
    rep, nb, tile = h // kh, block_tables.shape[1], simt_tile(hd)
    rows = c * rep
    n_rt = -(-rows // SIMT_ROWS)
    pad = n_rt * SIMT_ROWS - rows
    # every CTA (lane, row tile) at once: [B, n_rt, K, ROWS, hd]; pad rows
    # have position -1 (no key), as the kernel's
    qg = q.reshape(b, c, kh, rep, hd).transpose(1, 2).reshape(
        b, kh, rows, hd).float() * (1.0 / math.sqrt(hd))
    qg = torch.nn.functional.pad(qg, (0, 0, 0, pad)).reshape(
        b, kh, n_rt, SIMT_ROWS, hd).transpose(1, 2)
    qpos = torch.nn.functional.pad(
        positions.long().repeat_interleave(rep, dim=1), (0, pad),
        value=-1).reshape(b, n_rt, SIMT_ROWS)
    # each CTA's walk: [0, min(its last position + 1, NB * bs))
    kv_len = (qpos.amax(-1) + 1).clamp(max=nb * bs)           # [B, n_rt]
    kflat = k_pool.reshape(-1, kh, hd).float()
    vflat = v_pool.reshape(-1, kh, hd).float()
    if k_scale is not None:
        kflat = kflat * k_scale.reshape(-1, kh)[..., None]
        vflat = vflat * v_scale.reshape(-1, kh)[..., None]
    tables = block_tables.long()
    m = torch.full((b, n_rt, kh, SIMT_ROWS), ref.NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qg)
    # a CTA past its own walk adds p = 0 at alpha = 1: exactly nothing
    for t0 in range(0, int(kv_len.max()), tile):
        if t0 // tile == drop_tile:
            continue
        kpos = torch.arange(t0, t0 + tile, device=q.device)
        slot = tables[:, (kpos // bs).clamp(max=nb - 1)] * bs + kpos % bs
        valid = kpos[None, None, :] < kv_len[..., None]        # [B, n_rt, T]
        kt, vt = kflat[slot], vflat[slot]                      # [B, T, K, hd]
        s = torch.einsum("bnkrd,btkd->bnkrt", qg, kt)
        if softcap:
            s = torch.tanh(s / softcap) * softcap
        ok = (kpos[None, None, None, :] <= qpos[..., None]) \
            & valid[:, :, None, :]                              # [B,n_rt,R,T]
        ok = ok[:, :, None]
        m_new = torch.maximum(m, s.masked_fill(~ok, ref.NEG_INF).amax(-1))
        p = torch.exp(s - m_new[..., None]).masked_fill(~ok, 0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bnkrt,btkd->bnkrd", p,
                                                    vt)
        m = m_new
    out = (acc / l.clamp(min=1e-20)[..., None]).transpose(1, 2).reshape(
        b, kh, n_rt * SIMT_ROWS, hd)[:, :, :rows]
    return out.reshape(b, kh, c, rep, hd).transpose(1, 2).reshape(
        b, c, h, hd).to(q.dtype)


def paged_prefill_attention(q, k_pool, v_pool, block_tables, positions, *,
                            k_scale=None, v_scale=None, softcap: float = 0.0):
    """q: [B, C, H, hd], or [G, B, C, H, hd] with a branch dim, at absolute
    ``positions`` [B, C] int32; k/v_pool: [P, bs, K, hd] (or
    [G, P, bs, K, hd]) that already hold the chunk's K/V, in q's dtype or
    int8 with f32 ``k/v_scale`` [P, bs, K]; block_tables: [B, NB] int32.
    Returns q's shape and dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel (and
    count the launch in ``paged_prefill_attention.launches``) or raise."""
    if q.device.type == "cpu":
        return paged_prefill_attention_plain(
            q, k_pool, v_pool, block_tables, positions, k_scale=k_scale,
            v_scale=v_scale, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"paged_prefill_attention: no kernel for {q.device}")
    lead = q.dim() == 5
    out = launch("paged_prefill_attention_launch",
                 q if lead else q.unsqueeze(0), k_pool, v_pool, block_tables,
                 positions, k_scale=k_scale, v_scale=v_scale, softcap=softcap,
                 chunk=True)
    paged_prefill_attention.launches += 1
    return out if lead else out[0]


paged_prefill_attention.launches = 0
