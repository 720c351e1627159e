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
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._gemm_launch import launch


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
