"""Full-sequence (flash) GQA attention forward: Hopper kernel, wrapper and
plain version.

Replaces the Pallas TPU kernel ``flash_attention``
(src/repro/kernels/flash_attention.py, ``_attn_kernel``): causal GQA
attention with a sliding window and a logit softcap, queries at the end of
the key range, fully masked key blocks skipped.  The CUDA kernels live in
``csrc/flash_attention.cu``, one CTA per (head, batch, query tile), walking
the 64-token key tiles that ``_flash_launch.flash_plan`` gives (masks only
on the tiles crossing the causal frontier, the window edge or Sk) through
a ``cp.async`` ring, online softmax in f32, q/k/v read in the [B, S, H, hd]
layout through strides.  bf16 runs on the tensor cores (``wgmma`` at hd 64
and 128, ``mma.sync`` at hd 32; P rounded to bf16 for P·V), f32 on the
CUDA cores in f32 (tensor cores would mean TF32);
:func:`flash_attention_emulated` walks the same tiles in plain PyTorch.
Forward only: ``repro_torch.models.attention`` wraps it with a recomputing
backward, as the JAX package does.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels._flash_launch import (KEY_TILE, dry_launch,
                                               flash_plan, launch)

NEG_INF = -1e30
#: the kernels' check (the GPU tests, ``chip_smoke.py``, the emulation's
#: tests): |kernel - plain| <= tol times the max |plain| of each output
#: (head) row.  f32: the summation order.  bf16: one ulp of a bf16 output
#: is at most 2^-7 of its row's max, and at S 2048 a 64-key tile dropped
#: from the longest rows moves them by as little as 2x a 2e-2 limit
FLASH_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
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


def flash_attention_emulated(q, k, v, *, causal: bool = True,
                             window: int = 0, softcap: float = 0.0,
                             drop_tile=None):
    """The kernels' numerics in plain PyTorch: for each batch and head, the
    query tiles of :func:`_flash_launch.flash_plan`, each walking its
    ``KEY_TILE``-token key tiles in order (keys past Sk as zeros); f32
    scores scaled by 1/sqrt(hd), then softcapped; the mask applied only on
    the tiles the plan marks; f32
    running max, sum and accumulator; for bf16, P rounded to bf16 before
    P·V, the sum over the unrounded P; one cast at the end.  ``drop_tile``
    (an index into each query tile's walk, -1 the last) leaves that tile
    out where the walk has one, as a faulty kernel would: the checks must
    reject it.  Shapes as :func:`flash_attention`."""
    qf, kf, vf = _flat(q), _flat(k), _flat(v)
    n, sq, h, hd = qf.shape
    sk, kh = kf.shape[1], kf.shape[2]
    rep = h // kh
    scale = 1.0 / math.sqrt(hd)
    bf16_p = q.dtype == torch.bfloat16
    plan = flash_plan(sq, sk, causal=causal, window=window)
    # [N, H, S, hd] in f32, keys zero-padded to whole tiles
    pad = -(-sk // KEY_TILE) * KEY_TILE - sk
    qh = qf.float().transpose(1, 2)
    kh_ = torch.nn.functional.pad(kf.float(), (0, 0, 0, 0, 0, pad))
    vh = torch.nn.functional.pad(vf.float(), (0, 0, 0, 0, 0, pad))
    kh_ = kh_.repeat_interleave(rep, dim=2).transpose(1, 2)
    vh = vh.repeat_interleave(rep, dim=2).transpose(1, 2)
    out = torch.empty(n, h, sq, hd, dtype=torch.float32, device=q.device)
    for tile in plan:
        qt = qh[:, :, tile.q0:tile.q1]
        qpos = torch.arange(tile.q0, tile.q1, device=q.device) + sk - sq
        m = torch.full(qt.shape[:3], NEG_INF, device=q.device)
        l = torch.zeros(qt.shape[:3], device=q.device)
        acc = torch.zeros(qt.shape, device=q.device)
        walk = list(zip(range(tile.kt0, tile.kt1), tile.masked))
        if drop_tile is not None and -len(walk) <= drop_tile < len(walk):
            del walk[drop_tile]
        for kt, masked in walk:
            k0 = kt * KEY_TILE
            s = torch.einsum("nhqd,nhkd->nhqk", qt,
                             kh_[:, :, k0:k0 + KEY_TILE]) * scale
            if softcap:
                s = torch.tanh(s / softcap) * softcap
            if masked:
                kpos = torch.arange(k0, k0 + KEY_TILE, device=q.device)
                ok = (kpos < sk)[None, :].expand(len(qpos), -1)
                if causal:
                    ok = ok & (kpos[None, :] <= qpos[:, None])
                if window:
                    ok = ok & (kpos[None, :] > qpos[:, None] - window)
                s = s.masked_fill(~ok, float("-inf"))
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(-1)
            if bf16_p:
                p = p.to(torch.bfloat16).float()
            acc = acc * alpha[..., None] + torch.einsum(
                "nhqk,nhkd->nhqd", p, vh[:, :, k0:k0 + KEY_TILE])
            m = m_new
        out[:, :, tile.q0:tile.q1] = acc / l.clamp(min=1e-20)[..., None]
    return out.transpose(1, 2).to(q.dtype).reshape(q.shape)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    softcap: float = 0.0):
    """q: [..., Sq, H, hd]; k, v: [..., Sk, K, hd] (GQA: H % K == 0,
    Sq <= Sk, the same leading dims).  Returns q's shape and dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel of
    their dtype's path (and count the launch in
    ``flash_attention.launches`` and ``_flash_launch.PATH_LAUNCHES``) or
    raise; meta tensors (the dry run) are checked as a CUDA launch would
    be, the predicted launch counted in ``flash_attention.dry_launches``
    (the real count moves only where a kernel launches), the output
    allocated on meta and the call's work added to ``cost.DRYRUN``.  The
    leading dims fold into one batch dim, so a semantic split's branches
    share one launch."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    if q.shape[:-3] != k.shape[:-3]:
        raise ValueError(f"flash_attention: leading dims {tuple(q.shape)} "
                         f"vs {tuple(k.shape)}")
    kw = dict(causal=causal, window=window, softcap=softcap)
    if q.device.type == "meta":
        flash_attention.dry_launches += 1
        return dry_launch(_flat(q), _flat(k), _flat(v), **kw).reshape(q.shape)
    out = launch(_flat(q), _flat(k), _flat(v), **kw)
    flash_attention.launches += 1
    return out.reshape(q.shape)


flash_attention.launches = 0
flash_attention.dry_launches = 0
