"""Argument checks and the ctypes launch of the linear-recurrence scan
(``csrc/ssm_scan.cu``).  CUDA tensors only: the wrapper routes CPU tensors
to the plain version before reaching this module."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_I, _LL, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
_FN = []


def _fn():
    if not _FN:
        fn = _build.load("ssm_scan").ssm_scan_launch
        fn.argtypes = [_I, _I, _P, _P, _P, _I, _I, _LL, _P]
        fn.restype = ctypes.c_int
        _FN.append(fn)
    return _FN[0]


def launch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b [B, S, D, N] contiguous on one CUDA device, both f32 or both
    bf16.  Returns h [B, S, D, N] in a's dtype."""
    name = "ssm_scan"
    if b.device != a.device:
        raise ValueError(f"{name}: tensors on {b.device} and {a.device}")
    if a.dtype not in _DTYPE_CODE or b.dtype != a.dtype:
        raise ValueError(f"{name}: dtypes {a.dtype} / {b.dtype}; the kernel "
                         "takes f32 or bf16, the same for both")
    if a.dim() != 4 or b.shape != a.shape:
        raise ValueError(f"{name}: a {tuple(a.shape)}, b {tuple(b.shape)}; "
                         "expected two [B, S, D, N]")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"{name}: a and b must be contiguous")
    bn, s, d, n = a.shape
    dn = d * n
    h = torch.empty_like(a)
    if h.numel() == 0:
        return h
    if bn >= 2 ** 31 or s >= 2 ** 31:
        raise ValueError(f"{name}: shape too large")
    align = 4 * a.element_size()
    vec = 4 if dn % 4 == 0 and all(t.data_ptr() % align == 0
                                   for t in (a, b, h)) else 1
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = _fn()(_DTYPE_CODE[a.dtype], vec, a.data_ptr(), b.data_ptr(),
                   h.data_ptr(), bn, s, dn, stream)
    if rc != 0:
        raise RuntimeError(f"{name} failed with CUDA error {rc}")
    return h
