"""Full-sequence attention of the training forward: chunked attention in
plain PyTorch, and ``attention``, whose forward is the flash kernel and
whose backward recomputes the chunked path (``repro.models.attention``).

``chunked_attention`` never materializes the [Sq, Sk] scores: a loop over
query and key blocks with an online-softmax running (max, sum, acc), every
key block walked (masked blocks included), as the JAX ``_chunked`` scans
them.  ``attention`` is a ``torch.autograd.Function``: its forward runs
``kernels.flash_attention`` (the hand-written kernel on a CUDA tensor, the
plain version on a CPU tensor, as JAX runs ``chunked_attention`` off the
TPU) and saves (q, k, v); its backward rebuilds ``chunked_attention`` under
autograd and returns its vector-Jacobian product, which is the JAX
``_flash_bwd``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention import flash_attention

NEG_INF = -1e30


def _heads_first(x: torch.Tensor, rep: int) -> torch.Tensor:
    """[b, s, K, hd] -> [b, K*rep, s, hd] (kv head k serves query heads
    k*rep .. k*rep+rep-1)."""
    if rep > 1:
        x = torch.repeat_interleave(x, rep, dim=2)
    return x.transpose(1, 2)


def _chunked(q, k, v, causal: bool, window: int, softcap: float,
             q_chunk: int, k_chunk: int):
    b, sq, h, hd = q.shape
    sk, kh = k.shape[1], k.shape[2]
    rep = h // kh
    scale = 1.0 / math.sqrt(hd)
    q_off = sk - sq                  # queries sit at the END of the key range
    kg = _heads_first(k, rep).float()
    vg = _heads_first(v, rep).float()
    outs = []
    for qi in range(sq // q_chunk):
        qc = q[:, qi * q_chunk:(qi + 1) * q_chunk].transpose(1, 2).float() \
            * scale                                     # [b, h, qc, hd]
        qpos = qi * q_chunk + torch.arange(q_chunk, device=q.device) + q_off
        acc = torch.zeros(b, h, q_chunk, hd, device=q.device)
        m = torch.full((b, h, q_chunk), NEG_INF, device=q.device)
        l = torch.zeros(b, h, q_chunk, device=q.device)
        for ki in range(sk // k_chunk):
            kc = kg[:, :, ki * k_chunk:(ki + 1) * k_chunk]
            vc = vg[:, :, ki * k_chunk:(ki + 1) * k_chunk]
            s = torch.einsum("bhqd,bhkd->bhqk", qc, kc)
            if softcap:
                s = torch.tanh(s / softcap) * softcap
            kpos = ki * k_chunk + torch.arange(k_chunk, device=q.device)
            mask = torch.ones(q_chunk, k_chunk, dtype=torch.bool,
                              device=q.device)
            if causal:
                mask = kpos[None, :] <= qpos[:, None]
            if window:
                mask = mask & (kpos[None, :] > (qpos[:, None] - window))
            s = torch.where(mask, s, torch.full_like(s, NEG_INF))
            m_cur = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_cur[..., None])
            alpha = torch.exp(m - m_cur)
            l = alpha * l + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhqk,bhkd->bhqd", p, vc)
            m = m_cur
        out = acc / l.clamp_min(1e-20)[..., None]
        outs.append(out.to(q.dtype).transpose(1, 2))
    return torch.cat(outs, dim=1)


def chunked_attention(q, k, v, *, causal=True, window=0, softcap=0.0,
                      q_chunk=1024, k_chunk=1024):
    """q: [B, Sq, H, hd]; k, v: [B, Sk, K, hd] -> [B, Sq, H, hd]."""
    sq, sk = q.shape[1], k.shape[1]
    q_chunk = min(q_chunk, sq)
    k_chunk = min(k_chunk, sk)
    assert sq % q_chunk == 0 and sk % k_chunk == 0
    return _chunked(q, k, v, causal, window, softcap, q_chunk, k_chunk)


class _FlashAttention(torch.autograd.Function):
    """Forward: the flash kernel.  Backward: the vjp of chunked_attention,
    recomputed from the saved (q, k, v)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        ctx.save_for_backward(q, k, v)
        ctx.opts = dict(causal=causal, window=window, softcap=softcap)
        return flash_attention(q, k, v, causal=causal, window=window,
                               softcap=softcap)

    @staticmethod
    def backward(ctx, g):
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = chunked_attention(q, k, v, **ctx.opts)
            dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
        return dq, dk, dv, None, None, None


def attention(q, k, v, *, causal=True, window=0, softcap=0.0):
    """Public full-sequence attention entry point used by the model layers.
    q: [B, Sq, H, hd]; k, v: [B, Sk, K, hd]."""
    return _FlashAttention.apply(q, k, v, causal, window, softcap)
