"""Full-sequence (flash) GQA attention forward: Hopper kernel, wrapper and
plain version.

Replaces the Pallas TPU kernel ``flash_attention``
(src/repro/kernels/flash_attention.py, ``_attn_kernel``): causal GQA
attention with a sliding window and a logit softcap, queries at the end of
the key range, fully masked key blocks skipped.  The CUDA kernel lives in
``csrc/flash_attention.cu``: one CTA per (64-query tile, head, batch),
register-tiled f32 products on CUDA cores over key tiles staged in shared
memory, online softmax, reading q/k/v in the [B, S, H, hd] layout through
strides.  At the training shapes it is bound by arithmetic (f32 outside the
tensor cores), not by the bytes it moves; tensor-core tiles and a backward
kernel are later work.  Forward only: ``repro_torch.models.attention``
wraps it with a recomputing backward, as the JAX package does.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels._flash_launch import launch

NEG_INF = -1e30
#: query rows per step of the plain version (bounds its [.., rows, Sk]
#: score temporaries)
PLAIN_Q_ROWS = 512


def _flat(t: torch.Tensor) -> torch.Tensor:
    """[..., S, H, hd] -> [N, S, H, hd], a view where the strides allow."""
    return t.reshape((-1,) + tuple(t.shape[-3:]))


def flash_attention_plain(q, k, v, *, causal: bool = True, window: int = 0,
                          softcap: float = 0.0):
    """The kernel's function in plain PyTorch (the CPU path, and the
    kernel's yardstick on the card): masked softmax in f32, a block of
    query rows at a time, cast to q's dtype.  Shapes as
    :func:`flash_attention`."""
    qf, kf, vf = _flat(q), _flat(k), _flat(v)
    n, sq, h, hd = qf.shape
    sk, kh = kf.shape[1], kf.shape[2]
    rep = h // kh
    kf = torch.repeat_interleave(kf, rep, dim=2).float()
    vf = torch.repeat_interleave(vf, rep, dim=2).float()
    kpos = torch.arange(sk, device=q.device)
    outs = []
    for r0 in range(0, sq, PLAIN_Q_ROWS):
        qc = qf[:, r0:r0 + PLAIN_Q_ROWS].float()
        s = torch.einsum("nqhd,nkhd->nhqk", qc, kf) / math.sqrt(hd)
        if softcap:
            s = torch.tanh(s / softcap) * softcap
        qpos = torch.arange(r0, r0 + qc.shape[1], device=q.device) + sk - sq
        mask = torch.ones(qc.shape[1], sk, dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window:
            mask &= kpos[None, :] > (qpos[:, None] - window)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        p = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("nhqk,nkhd->nqhd", p, vf).to(q.dtype))
    return torch.cat(outs, dim=1).reshape(q.shape)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0):
    """q: [..., Sq, H, hd]; k, v: [..., Sk, K, hd] (GQA: H % K == 0,
    Sq <= Sk, the same leading dims).  Returns q's shape and dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel (and
    count the launch in ``flash_attention.launches``) or raise.  The
    leading dims fold into one batch dim, so a semantic split's branches
    share one launch."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    if q.shape[:-3] != k.shape[:-3]:
        raise ValueError(f"flash_attention: leading dims {tuple(q.shape)} "
                         f"vs {tuple(k.shape)}")
    out = launch(_flat(q), _flat(k), _flat(v), causal=causal, window=window,
                 softcap=softcap)
    flash_attention.launches += 1
    return out.reshape(q.shape)


flash_attention.launches = 0
