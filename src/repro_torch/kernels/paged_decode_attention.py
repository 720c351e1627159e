"""Paged single-token decode attention: Hopper kernel, wrapper and plain
version.

Replaces the Pallas TPU kernel ``paged_decode_attention``
(src/repro/kernels/paged_decode_attention.py, ``_paged_kernel``).  The CUDA
kernel lives in ``csrc/paged_attention.cu``: one CTA per (lane, kv head,
branch), the GQA group's queries riding together so each K/V token is read
once per kv head, the block table walked only up to the lane's fill level.
It is bound by the bytes of K/V it reads (about 4 flops per bf16 byte); the
design reads each token row once with 16-byte loads straight from the
reference pool layout [P, bs, K, hd], dequantizes int8 in registers and keeps
the softmax state on chip.  Tables may alias blocks across lanes (prefix
sharing): the pool is only read.

A leading branch dim on q and the pools (the semantic split's branches, each
with its own pool; tables and lengths shared) folds into one launch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
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
