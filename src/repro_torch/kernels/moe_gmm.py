"""Grouped matmul over expert segments (MoE): Hopper kernel, wrapper and
plain version.

Replaces the Pallas TPU kernel ``moe_gmm`` (src/repro/kernels/moe_gmm.py,
``_gmm_kernel``): after the sort-based dispatch, tokens sit in a
capacity-padded [E, C, d] buffer and expert e applies its own [d, f]
weight.  The CUDA kernel is the grouped GEMM of ``csrc/grouped_matmul.cu``
(shared with ``block_diag_matmul``).  In bf16 it runs on the tensor cores
(``wgmma`` fed by TMA): at a 2048-token sequence's capacity (C = 171 for 60
experts) one CTA of three 64-row warpgroups covers an expert's rows, so
each weight tile is read from device memory once, and the bytes of the
expert weights bound it.  In f32 it runs on CUDA cores in 64-row tiles
(little padding at C 171), bound by f32 arithmetic.  A capacity of 32 rows
or fewer takes the decode-sized tile of ``block_diag_matmul`` (one launch,
the contraction split over a cluster).  The TPU kernel's
block knobs (``block_c/f/d``) are not carried; any C, d and f are taken.

The serving paths call the ragged entry, :func:`moe_gmm_ragged`: the kept
assignments compacted by expert (``models/moe.py``), rows
offsets[e] .. offsets[e + 1] for expert e, one launch whose CTAs read the
offsets on the device, so only the chosen experts' weights are read and
only kept rows computed (the capacity buffer's empty slots are not).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._gemm_launch import (launch, ragged_dry_launch,
                                              ragged_launch)


#: the kernel's function in plain PyTorch (the CPU path, and the kernel's
#: yardstick on the card) is the oracle itself: an f32 einsum, cast to x's dtype
moe_gmm_plain = ref.moe_gmm_ref


def moe_gmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [E, C, d] @ w [E, d, f] -> [E, C, f] in x's dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel (and
    count the launch in ``moe_gmm.launches``) or raise."""
    if x.device.type == "cpu":
        return moe_gmm_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"moe_gmm: no kernel for {x.device}")
    out = launch(x, w, "moe_gmm")
    moe_gmm.launches += 1
    return out


moe_gmm.launches = 0


def moe_gmm_ragged_plain(x: torch.Tensor, w: torch.Tensor,
                         offsets: torch.Tensor) -> torch.Tensor:
    """The ragged entry's function in plain PyTorch (the CPU path, and the
    kernel's yardstick on the card): each group's segment, rows
    offsets[g] .. offsets[g + 1] (read on the host), as ``moe_gmm_ref``
    computes it; every other row 0."""
    r = x.shape[0]
    out = torch.zeros((r, w.shape[2]), dtype=x.dtype, device=x.device)
    off = [min(max(o, 0), r) for o in offsets.tolist()]
    for g, (lo, hi) in enumerate(zip(off, off[1:])):
        if hi > lo:
            out[lo:hi] = moe_gmm_plain(x[None, lo:hi], w[g:g + 1])[0]
    return out


def moe_gmm_ragged(x: torch.Tensor, w: torch.Tensor,
                   offsets: torch.Tensor) -> torch.Tensor:
    """x [R, d] @ w [G, d, f] by segments -> [R, f] in x's dtype: rows
    offsets[g] .. offsets[g + 1] times w[g], the rows at or past
    offsets[G] zero; ``offsets`` an int32 [G + 1] on x's device,
    non-decreasing from 0.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (one CUDA kernel, no read of the offsets on the host; counted in
    ``moe_gmm_ragged.launches``) or raise; meta tensors (the dry run) are
    checked as a CUDA launch would be, the predicted launch counted in
    ``moe_gmm_ragged.dry_launches`` and its worst-case work added to
    ``cost.DRYRUN``."""
    if x.device.type == "cpu":
        return moe_gmm_ragged_plain(x, w, offsets)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"moe_gmm_ragged: no kernel for {x.device}")
    if x.device.type == "meta":
        moe_gmm_ragged.dry_launches += 1
        return ragged_dry_launch(x, w, offsets, "moe_gmm_ragged")
    out = ragged_launch(x, w, offsets, "moe_gmm_ragged")
    moe_gmm_ragged.launches += 1
    return out


moe_gmm_ragged.launches = 0
moe_gmm_ragged.dry_launches = 0
