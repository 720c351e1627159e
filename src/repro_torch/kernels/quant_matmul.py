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
one group slab at a time, takes each slab's product on the integer codes in
f32 and scales it once into an f32 accumulator, so the weight is never
dequantized to memory.  At decode (8 rows) it is bound by the bytes of
codes it reads; at a 1024-row prefill by its f32 CUDA-core arithmetic.  A
leading branch dim G (the semantic split's branches) folds into the grid.
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
