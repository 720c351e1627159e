"""Argument checks and the ctypes launch of the quant GEMM kernel
(``csrc/quant_matmul.cu``).  CUDA tensors only: the wrapper routes CPU
tensors to the plain version before reaching this module."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_I, _P = ctypes.c_int, ctypes.c_void_p
#: the kernel's decode-sized tile (csrc/quant_matmul.cu): T <= DECODE_T
#: takes BT x BE = 8 x 32 output tiles and may split its groups over CTAs
DECODE_T, DECODE_BT, DECODE_BE = 32, 8, 32
#: CTAs per SM a decode-sized call aims for when it splits its groups
CTAS_PER_SM = 2


_FN = []                 # the bound C entry point, once loaded


def _fn():
    if not _FN:
        fn = _build.load("quant_matmul").quant_matmul_launch
        fn.argtypes = [_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                       _P]
        fn.restype = ctypes.c_int
        _FN.append(fn)
    return _FN[0]


def split_count(g: int, t: int, e: int, n_groups: int, n_sm: int) -> int:
    """Group splits for a call: 1 at prefill-sized T; at decode-sized T
    enough to give ~``CTAS_PER_SM`` CTAs per SM, every split non-empty."""
    if t > DECODE_T:
        return 1
    tiles = -(-e // DECODE_BE) * -(-t // DECODE_BT) * g
    want = max(1, min(n_groups, -(-CTAS_PER_SM * n_sm // tiles)))
    per = -(-n_groups // want)
    return -(-n_groups // per)


def launch(x: torch.Tensor, q: torch.Tensor,
           scales: torch.Tensor) -> torch.Tensor:
    """Check the arguments and launch one kernel on the current stream.

    ``x``: [G, T, D] contiguous f32/bf16; ``q``: int8 [G, D, E] or
    nibble-packed [G, D/2, E]; ``scales``: f32 [G, D/g, E]; all contiguous
    on x's device.  Returns [G, T, E] in x's dtype."""
    name = "quant_matmul"
    dev = x.device
    for t in (q, scales):
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name}: x must be f32/bf16, got {x.dtype}")
    if q.dtype != torch.int8 or scales.dtype != torch.float32:
        raise ValueError(f"{name}: codes must be int8 and scales f32, got "
                         f"{q.dtype} / {scales.dtype}")
    if x.dim() != 3 or q.dim() != 3 or scales.dim() != 3:
        raise ValueError(f"{name}: x, q and scales take one leading branch "
                         "dim")
    g, t, d = x.shape
    _, rows, e = q.shape
    n_g = scales.shape[1]
    if q.shape[0] != g or tuple(scales.shape) != (g, n_g, e):
        raise ValueError(f"{name}: x {tuple(x.shape)}, q {tuple(q.shape)}, "
                         f"scales {tuple(scales.shape)} do not line up")
    if d == 0 or n_g == 0 or d % n_g:
        raise ValueError(f"{name}: {n_g} scale groups do not divide D={d}")
    group = d // n_g
    if rows == d:
        bits = 8
    elif rows * 2 == d and group % 2 == 0:
        bits = 4
    else:
        raise ValueError(f"{name}: {rows} code rows for D={d} (group "
                         f"{group}): neither int8 nor int4-packed")
    if not (x.is_contiguous() and q.is_contiguous()
            and scales.is_contiguous()):
        raise ValueError(f"{name}: tensors must be contiguous")
    out = torch.empty((g, t, e), dtype=x.dtype, device=dev)
    if out.numel() == 0:
        return out
    splits = split_count(g, t, e, n_g, _build.sm_count(dev))
    if g * splits > 65535 or -(-t // DECODE_BT) > 65535:
        raise ValueError(f"{name}: grid too large")
    partial = torch.empty((splits, g, t, e), dtype=torch.float32,
                          device=dev) if splits > 1 else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _fn()(_DTYPE_CODE[x.dtype], bits, x.data_ptr(), q.data_ptr(),
                   scales.data_ptr(), out.data_ptr(),
                   None if partial is None else partial.data_ptr(), splits,
                   g, t, d, e, group, stream)
    if rc != 0:
        raise RuntimeError(f"{name} failed with CUDA error {rc}")
    return out
