"""Block-diagonal (semantic-split) matmul: Hopper kernel, wrapper and plain
version.

Replaces the Pallas TPU kernel ``block_diag_matmul``
(src/repro/kernels/block_diag_matmul.py, ``_bdm_kernel``): a semantic split
turns a weight matrix into Bb independent diagonal blocks, and branch b's
``x[b] @ w[b]`` is computed alone, at 1/Bb of the dense product's flops.
The CUDA kernel is the grouped GEMM of ``csrc/grouped_matmul.cu`` (shared
with ``moe_gmm``), x and w read through their strides, ragged shapes
masked: bf16 at prefill-sized T on the tensor cores (``wgmma`` fed by TMA,
bound by bf16 tensor-core arithmetic), f32 on register-tiled CUDA-core
products (bound by f32 arithmetic), decode-sized T (<= 32, the mLSTM's
per-head projections on the gang path) in one launch whose contraction is
split over a thread-block cluster and merged inside it, bf16 on
``mma.sync`` and f32 on CUDA-core FMAs (bound by the bytes of w);
``_gemm_launch.path_for`` states the rule.  The TPU
kernel's block knobs (``block_t/e/d``, tiles for the MXU) are not carried:
the kernel picks its own tiles and takes shapes the TPU asserts refuse.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._gemm_launch import dry_launch, launch


#: the kernel's function in plain PyTorch (the CPU path, and the kernel's
#: yardstick on the card) is the oracle itself: an f32 einsum, cast to x's dtype
block_diag_matmul_plain = ref.block_diag_matmul_ref


def block_diag_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [Bb, T, d_b] @ w [Bb, d_b, e_b] -> [Bb, T, e_b] in x's dtype.

    CPU tensors take the plain version; CUDA tensors launch the kernel (and
    count the launch in ``block_diag_matmul.launches``) or raise; meta
    tensors (the dry run) are checked as a CUDA launch would be, the
    predicted launch counted in ``block_diag_matmul.dry_launches`` (the real
    count moves only where a kernel launches), what the launch allocates
    allocated on meta and the call's work added to ``cost.DRYRUN``."""
    if x.device.type == "cpu":
        return block_diag_matmul_plain(x, w)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"block_diag_matmul: no kernel for {x.device}")
    if x.device.type == "meta":
        block_diag_matmul.dry_launches += 1
        return dry_launch(x, w, "block_diag_matmul")
    out = launch(x, w, "block_diag_matmul")
    block_diag_matmul.launches += 1
    return out


block_diag_matmul.launches = 0
block_diag_matmul.dry_launches = 0
