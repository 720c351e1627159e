"""Linear-recurrence (Mamba selective) scan: Hopper kernel, wrapper and
plain version.

Replaces the Pallas TPU kernel ``ssm_scan`` (src/repro/kernels/ssm_scan.py,
``_scan_kernel``): ``h_t = a_t h_{t-1} + b_t`` along S of [B, S, D, N]
gates and inputs, the state in f32, each h_t in a's dtype.  The CUDA kernel
(``csrc/ssm_scan.cu``) gives each thread four neighbouring recurrences of
the contiguous D*N axis, keeps their state in registers and walks S with
several steps' loads in flight: one read of a and b and one write of h,
bound by device-memory bytes.  Any S (the TPU kernel's ``chunk`` must
divide S; the port has no chunk).  Each step is a rounded multiply then a
rounded add, as the plain loop computes it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._scan_launch import launch


#: the kernel's function in plain PyTorch (the CPU path, and the kernel's
#: yardstick on the card) is the oracle itself: a loop over S
ssm_scan_plain = ref.ssm_scan_ref


def ssm_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b [B, S, D, N] -> h [B, S, D, N] in a's dtype, with
    h_t = a_t h_{t-1} + b_t from h_{-1} = 0.

    CPU tensors take the plain version; CUDA tensors launch the kernel (and
    count the launch in ``ssm_scan.launches``) or raise."""
    if a.device.type == "cpu":
        return ssm_scan_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"ssm_scan: no kernel for {a.device}")
    out = launch(a, b)
    ssm_scan.launches += 1
    return out


ssm_scan.launches = 0
