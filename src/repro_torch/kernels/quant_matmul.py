"""Blockwise-scaled int8 / int4 weight matmul: Hopper kernel, wrapper,
plain version and the quantization helpers.

Replaces the Pallas TPU kernel ``quant_matmul``
(src/repro/kernels/quant_matmul.py, ``_qmm_kernel``).  Weights are
quantized symmetrically per (contraction group, output column): the
contraction axis D is cut into groups of ``g = fit_group(D)`` rows and every
(group, column) cell carries one f32 scale ``amax / qmax``.  int4 packs two
codes per int8 byte within a group: the low nibble holds rows
``[gG, gG + G/2)`` and the high nibble rows ``[gG + G/2, (g+1)G)``, and sign
extension is two int8 shifts (``(p << 4) >> 4`` and ``p >> 4``).

The CUDA kernel lives in ``csrc/quant_matmul.cu``: it walks the contraction
one group at a time, takes each group's product on the integer codes with
f32 accumulation and scales it once into an f32 accumulator, so the weight
is never dequantized to memory.  bf16 x runs on the tensor cores (``mma.sync``
m16n8k16, the codes widened to bf16, exact): ``mma_skinny`` at decode-sized
T (<= 32, bound by the code bytes; the groups split over the CTAs of a
cluster and merged in the same launch) and ``mma_tile`` above (128 x 128
tiles, bound by tensor-core operations at a 1024-row prefill);
:func:`quant_matmul_emulated` walks the same steps in plain PyTorch.  f32 x
keeps CUDA-core f32 FMAs (``simt``: no TF32; decode-sized calls split the
groups over CTAs and a second kernel adds the splits in order), which
:func:`quant_matmul_simt_emulated` walks.  A leading branch dim G (the
semantic split's branches) folds into the grid.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref


def fit_group(d: int, group: int = 128) -> int:
    """Largest divisor of ``d`` reached by halving ``min(group, d)``: the
    per-128-row default degrades gracefully for small model dims."""
    g = min(group, d)
    while d % g:
        g //= 2
    return max(g, 1)


def quantize_blockwise(w: torch.Tensor, *, bits: int = 8, group: int = 128):
    """Symmetric blockwise quantization of ``w`` [..., D, E].

    Returns ``(q, scales)``: int8 codes (``[..., D, E]`` for int8;
    nibble-packed ``[..., D//2, E]`` for int4) and f32 scales
    ``[..., D//g, E]`` with ``g = fit_group(D, group)``.  Zero groups get a
    zero scale.  Rounds half to even, as ``jnp.round`` does, so codes and
    scales equal the JAX package's bit for bit."""
    if bits not in (8, 4):
        raise ValueError(f"bits={bits}; expected 8 or 4")
    *lead, d, e = w.shape
    g = fit_group(d, group)
    if bits == 4 and g < 2:
        raise ValueError(f"int4 needs group >= 2 (D={d})")
    n_g = d // g
    qmax = 127 if bits == 8 else 7
    wg = w.float().reshape(*lead, n_g, g, e)
    amax = wg.abs().amax(dim=-2)                             # [..., n_g, E]
    scale = amax / qmax
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(wg / safe[..., None, :]), -qmax, qmax) \
        .to(torch.int8)
    if bits == 4:
        half = g // 2
        lo, hi = q[..., :half, :], q[..., half:, :]
        q = ((hi << 4) | (lo & 0xF)).reshape(*lead, d // 2, e)
    else:
        q = q.reshape(*lead, d, e)
    return q, scale


def unpack_int4(p: torch.Tensor):
    """Split nibble-packed codes [..., n_g, G/2, E] into (lo, hi) int8
    slabs; arithmetic int8 shifts sign-extend the 4-bit codes."""
    return (p << 4) >> 4, p >> 4


def dequantize_blockwise(q: torch.Tensor, scales: torch.Tensor, *,
                         bits: int = 8) -> torch.Tensor:
    """Inverse of :func:`quantize_blockwise`: f32 [..., D, E]."""
    *lead, dq, e = q.shape
    n_g = scales.shape[-2]
    if bits == 4:
        half = (2 * dq) // n_g // 2
        lo, hi = unpack_int4(q.reshape(*lead, n_g, half, e))
        full = torch.cat([lo, hi], dim=-2)                   # [.., n_g, G, E]
    else:
        full = q.reshape(*lead, n_g, dq // n_g, e)
    deq = full.float() * scales[..., None, :]
    return deq.reshape(*lead, n_g * full.shape[-2], e)


def infer_bits(d: int, q: torch.Tensor) -> int:
    """4 when the code matrix holds two rows per byte, else 8."""
    return 4 if q.shape[-2] * 2 == d else 8


def quant_matmul_plain(x: torch.Tensor, q: torch.Tensor,
                       scales: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch (the CPU path, and the
    kernel's yardstick on the card): dequantize, an f32 product, cast to
    x's dtype.  Shapes as :func:`quant_matmul`."""
    return ref.quant_matmul_ref(x, q, scales,
                                bits=infer_bits(x.shape[-1], q))


def _group_codes(q: torch.Tensor, gi: int, group: int,
                 bits: int) -> torch.Tensor:
    """Group ``gi``'s codes [G, group, E] as f32, contraction rows in order,
    by the kernel's index arithmetic: int8 stored row ``gi*group + p`` is
    contraction row ``gi*group + p``; int4 stored row ``gi*group/2 + p``
    holds contraction row ``gi*group + p`` in its low nibble and
    ``gi*group + group/2 + p`` in its high nibble."""
    if bits == 8:
        return q[:, gi * group:(gi + 1) * group].float()
    span = group // 2
    raw = q[:, gi * span:(gi + 1) * span]
    out = torch.empty((q.shape[0], group, q.shape[2]), dtype=torch.float32,
                      device=q.device)
    p = torch.arange(span, device=q.device)
    out[:, p] = ((raw << 4) >> 4).float()          # low nibbles: rows p
    out[:, span + p] = (raw >> 4).float()           # high: rows group/2 + p
    return out


def quant_matmul_emulated(x: torch.Tensor, q: torch.Tensor,
                          scales: torch.Tensor, *, n_sm: int = 132,
                          drop_group=None) -> torch.Tensor:
    """The tensor-core paths' numerics in plain PyTorch (bf16 x): the split
    of the groups that ``_quant_launch.mma_plan`` gives for ``n_sm`` SMs,
    each split walking its groups in order; each group's product on the
    codes summed over its k16 steps in the kernel's order in f32 (bf16 x
    bf16 products are exact in f32), scaled by the group's per-column scale
    into the split's f32 accumulator; the splits added in order from 0, and
    one cast to x's dtype.  ``drop_group`` (a group index or a set of
    them) leaves those groups out, as a faulty kernel would: the checks
    must reject it.
    Shapes as :func:`quant_matmul`."""
    from repro_torch.kernels._quant_launch import mma_plan
    lead = x.dim() == 3
    if not lead:
        x, q, scales = x[None], q[None], scales[None]
    g, t, d = x.shape
    n_g, e = scales.shape[1], scales.shape[2]
    group, bits = d // n_g, infer_bits(d, q)
    drop = set() if drop_group is None else (
        {drop_group} if isinstance(drop_group, int) else set(drop_group))
    _, splits, per = mma_plan(g, t, e, n_g, n_sm)
    span = group // 2 if bits == 4 else group
    # the k16 steps in the kernel's order: per 16 stored rows p0, rows p0..
    # (int4: the low nibbles) and then, for int4, rows group/2 + p0..
    steps = [k for p0 in range(0, span, 16)
             for k in ((p0, span + p0) if bits == 4 else (p0,))]
    out = torch.zeros((g, t, e), dtype=torch.float32, device=x.device)
    for s in range(splits):
        acc = torch.zeros_like(out)
        for gi in range(s * per, min(n_g, (s + 1) * per)):
            if gi in drop:
                continue
            w = _group_codes(q, gi, group, bits)
            part = torch.zeros_like(out)
            for k0 in steps:
                part += torch.bmm(
                    x[:, :, gi * group + k0:gi * group + k0 + 16].float(),
                    w[:, k0:k0 + 16])
            acc += part * scales[:, gi][:, None, :]
        out = out + acc
    out = out.to(x.dtype)
    return out if lead else out[0]


def quant_matmul_simt_emulated(x: torch.Tensor, q: torch.Tensor,
                               scales: torch.Tensor, *, n_sm: int = 132,
                               drop_group=None) -> torch.Tensor:
    """The CUDA-core path's numerics (``simt``: f32 x) in plain PyTorch: the
    groups split as ``_quant_launch.split_count`` splits them for ``n_sm``
    SMs (decode-sized T only), each split walking its groups in order; a
    group's product on the codes taken a shared-memory slab at a time (128
    contraction rows at decode-sized T, 32 above; int4: a slab of stored
    rows, its low nibbles and then its high nibbles) in f32, scaled once by
    the group's per-column scale into the split's f32 accumulator; the
    splits then added in order from 0 (the reduce kernel), one cast to x's
    dtype.  ``drop_group`` (an index or a set) leaves those groups out, as
    a faulty kernel would.  Shapes as :func:`quant_matmul`."""
    from repro_torch.kernels._quant_launch import DECODE_T, split_count
    lead = x.dim() == 3
    if not lead:
        x, q, scales = x[None], q[None], scales[None]
    g, t, d = x.shape
    n_g, e = scales.shape[1], scales.shape[2]
    group, bits = d // n_g, infer_bits(d, q)
    drop = set() if drop_group is None else (
        {drop_group} if isinstance(drop_group, int) else set(drop_group))
    splits = split_count(g, t, e, n_g, n_sm)
    per = -(-n_g // splits)
    slab = (128 if t <= DECODE_T else 32) // (2 if bits == 4 else 1)
    span = group // 2 if bits == 4 else group
    xf = x.float()
    out = torch.zeros((g, t, e), dtype=torch.float32, device=x.device)
    for s in range(splits):
        acc = torch.zeros_like(out)
        for gi in range(s * per, min(n_g, (s + 1) * per)):
            if gi in drop:
                continue
            w = _group_codes(q, gi, group, bits)     # contraction order
            part = torch.zeros_like(out)
            for p0 in range(0, span, slab):
                rows = list(range(p0, min(span, p0 + slab)))
                if bits == 4:                         # then the high nibbles
                    rows += [span + r for r in rows]
                part += torch.bmm(xf[:, :, [gi * group + r for r in rows]],
                                  w[:, rows])
            acc += part * scales[:, gi][:, None, :]
        out = out + acc
    out = out.to(x.dtype)
    return out if lead else out[0]


def quant_matmul(x: torch.Tensor, q: torch.Tensor,
                 scales: torch.Tensor) -> torch.Tensor:
    """x [(G,) T, D] f32/bf16 @ dequant(q, scales) -> [(G,) T, E] in x's
    dtype.  ``q``: int8 codes [(G,) D, E] or nibble-packed [(G,) D/2, E];
    ``scales``: f32 [(G,) D/g, E].

    CPU tensors take the plain version; CUDA tensors launch the kernel (and
    count the launch in ``quant_matmul.launches``) or raise."""
    if x.device.type == "cpu":
        return quant_matmul_plain(x, q, scales)
    if x.device.type != "cuda":
        raise ValueError(f"quant_matmul: no kernel for {x.device}")
    from repro_torch.kernels._quant_launch import launch
    lead = x.dim() == 3
    out = launch(x if lead else x.unsqueeze(0), q if lead else q.unsqueeze(0),
                 scales if lead else scales.unsqueeze(0))
    quant_matmul.launches += 1
    return out if lead else out[0]


quant_matmul.launches = 0
