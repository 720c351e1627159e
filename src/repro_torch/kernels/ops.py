"""The kernel-op layer: one public op per kernel, and the switch that sends
every op to its plain oracle.

Port of ``src/repro/kernels/ops.py``, with its six ops and their
signatures, and ``use_kernels``:

- ``use_kernels(False)`` routes every op to the port's copy of the jnp
  oracles, ``repro_torch.kernels.ref`` (``quant_matmul_ref`` is what
  ``quant_matmul_plain`` computes).
- With kernels on, each op calls its kernel's wrapper, and the tensor's
  device decides: a CUDA tensor launches the hand-written kernel and counts
  the launch on the wrapper; a CPU tensor takes the kernel's plain version.
  Nothing falls back: a kernel that fails to build or launch raises.

The JAX ops take an ``interpret`` override, which picks between compiling
the Pallas kernel for the TPU and emulating it elsewhere.  The port has no
such argument: on this card the tensor's device does that job, and a CUDA
kernel has no emulation mode.

The JAX docstring says the fsdp/semantic/pipeline runners call through
these ops; they do not.  Nothing under ``src/repro`` imports
``kernels/ops.py``, and nothing in the port imports this module: the
models call the paged, quant and flash wrappers directly, and the
block-diagonal, MoE and scan products are plain batched ``torch.matmul``
and loops, as the JAX models use ``vmap`` and ``lax.scan``.  This layer is
the kernels' public surface, driven by ``chip_smoke.py`` and the tests.
"""
from __future__ import annotations

from repro_torch.kernels import ref
from repro_torch.kernels.block_diag_matmul import block_diag_matmul as _bdm
from repro_torch.kernels.decode_attention import decode_attention as _dec
from repro_torch.kernels.flash_attention import flash_attention as _flash
from repro_torch.kernels.moe_gmm import moe_gmm as _gmm
from repro_torch.kernels.quant_matmul import quant_matmul as _qmm
from repro_torch.kernels.ssm_scan import ssm_scan as _scan

_STATE = {"enabled": True}


def use_kernels(enabled: bool) -> None:
    """Route every op to its kernel wrapper (True) or its oracle (False)."""
    _STATE["enabled"] = bool(enabled)


def flash_attention(q, k, v, causal=True, window=0, softcap=0.0):
    if not _STATE["enabled"]:
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       softcap=softcap)
    return _flash(q, k, v, causal=causal, window=window, softcap=softcap)


def block_diag_matmul(x, w):
    if not _STATE["enabled"]:
        return ref.block_diag_matmul_ref(x, w)
    return _bdm(x, w)


def moe_gmm(x, w):
    if not _STATE["enabled"]:
        return ref.moe_gmm_ref(x, w)
    return _gmm(x, w)


def ssm_scan(a, b):
    if not _STATE["enabled"]:
        return ref.ssm_scan_ref(a, b)
    return _scan(a, b)


def decode_attention(q, k_cache, v_cache, length, softcap=0.0):
    """With kernels on, a ``length == 0`` row is 0 (the kernel's rule);
    with kernels off it is the oracle's mean of v."""
    if not _STATE["enabled"]:
        return ref.decode_attention_ref(q, k_cache, v_cache, length,
                                        softcap=softcap)
    return _dec(q, k_cache, v_cache, length, softcap=softcap)


def quant_matmul(x, q, scales):
    """Blockwise int8/int4 dequant GEMM (bit width inferred from the packed
    code-matrix shape)."""
    if not _STATE["enabled"]:
        return ref.quant_matmul_ref(x, q, scales)
    return _qmm(x, q, scales)
