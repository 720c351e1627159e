"""Paged chunked-prefill attention: Hopper kernel, wrapper and plain
version.

Replaces the Pallas TPU kernel ``paged_prefill_attention``
(src/repro/kernels/paged_prefill_attention.py, ``_chunk_kernel``).  The CUDA
kernel lives in ``csrc/paged_attention.cu``: one CTA per (lane, kv head,
branch x tile of 32 query rows), walking the block table only up to the
tile's last position with f32 online-softmax state, and the absolute causal
rule ``kpos <= qpos`` covering the cached prefix and the in-chunk triangle.
At a 128-token chunk it is bound by its CUDA-core f32 arithmetic (score and
P·V products of this simple tiling), not by the K/V bytes it reads once per
row tile; tensor-core tiles are later work.  Padded query slots (positions
past a lane's ``n_tok``) may reach past the table: the walk is clipped to NB
blocks, and their rows are never read by the caller.
"""
from __future__ import annotations

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
