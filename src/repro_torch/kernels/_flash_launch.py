"""Argument checks and the ctypes launch of the flash-attention forward
(``csrc/flash_attention.cu``).  CUDA tensors only: the wrapper routes CPU
tensors to the plain version before reaching this module."""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)

_I, _LL, _F, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_float, \
    ctypes.c_void_p
_ARGTYPES = [_I, _I] + [_P] * 4 + [_I] * 5 + [_LL] * 9 + [_I, _I, _F, _F, _P]


def _fn():
    fn = _build.load("flash_attention").flash_attention_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def launch(q, k, v, *, causal: bool, window: int, softcap: float):
    """q [N, Sq, H, hd], k/v [N, Sk, KH, hd] on one CUDA device, one of f32
    or bf16, with a dense head dim and 16-byte aligned rows (any batch,
    sequence and head strides).  Returns a dense [N, Sq, H, hd] in q's
    dtype."""
    name = "flash_attention"
    dev = q.device
    for t in (k, v):
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name}: q {q.dtype} but k/v {t.dtype}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name}: dtype {q.dtype}; the kernel takes f32 "
                         "and bf16")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    n, sq, h, hd = q.shape
    nk, sk, kh, hdk = k.shape
    if nk != n or hdk != hd or h % kh:
        raise ValueError(f"{name}: q {tuple(q.shape)} vs k {tuple(k.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {hd}; the kernel takes "
                         f"{HEAD_DIMS}")
    if sq > sk:
        raise ValueError(f"{name}: {sq} queries over {sk} keys; queries sit "
                         "at the end of the key range, so Sq <= Sk")
    if window < 0 or softcap < 0:
        raise ValueError(f"{name}: window {window}, softcap {softcap}")
    item = q.element_size()
    for t in (q, k, v):
        if t.stride(-1) != 1 or t.data_ptr() % 16 or any(
                s * item % 16 for s in t.stride()[:3]):
            raise ValueError(f"{name}: the head dim must be dense and rows "
                             "16-byte aligned")
    if h > 65535 or n > 65535:
        raise ValueError(f"{name}: grid too large")
    out = torch.empty((n, sq, h, hd), dtype=q.dtype, device=dev)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _fn()(
            _DTYPE_CODE[q.dtype], hd, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), n, sq, sk, h, kh,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            int(bool(causal)), int(window), 1.0 / math.sqrt(hd),
            float(softcap), stream)
    if rc != 0:
        raise RuntimeError(f"{name} failed with CUDA error {rc}")
    return out
