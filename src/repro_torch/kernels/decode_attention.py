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
``acc / max(l, 1e-20)`` with nothing accumulated).  The dense oracle
``ref.decode_attention_ref`` instead returns the mean of v there (a
softmax over all-masked scores is uniform); ``ops.decode_attention`` with
``use_kernels(False)`` follows the oracle, as the JAX ``ops`` does.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._decode_launch import launch


def decode_attention_plain(q, k_cache, v_cache, length, *,
                           softcap: float = 0.0):
    """The kernel's function in plain PyTorch (the CPU path, and the
    kernel's yardstick on the card): the dense oracle, with length-0 rows
    set to 0 as the kernel returns them."""
    out = ref.decode_attention_ref(q, k_cache, v_cache, length,
                                   softcap=softcap)
    return torch.where((length > 0).to(out.device)[:, None, None], out,
                       torch.zeros_like(out))


def decode_attention(q, k_cache, v_cache, length, *, softcap: float = 0.0):
    """q [B, H, hd] (one token per lane); k/v_cache [B, L, K, hd] (GQA:
    H % K == 0); length [B] valid slots (int32 on the cache's device for
    the kernel).  Returns [B, H, hd] in q's dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel (and
    count the launch in ``decode_attention.launches``) or raise."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, length,
                                      softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for {q.device}")
    out = launch(q, k_cache, v_cache, length, softcap=softcap)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
