"""Argument checks, split choice and the ctypes launch of the decode
attention kernel (``csrc/decode_attention.cu``).  :func:`launch` takes
CUDA tensors only: the wrapper routes CPU tensors to the plain version
before reaching this module, and meta tensors to :func:`dry_launch`, which
runs the same checks and allocates what a launch allocates without one."""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.cost import add_dryrun, decode_cost

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)
#: query heads one CTA may carry (the kernel's instantiations)
HEAD_GROUPS = (8, 4, 2, 1)
#: cache slots per CTA; a longer cache is split over CTAs and merged
CHUNK = 256
_I, _LL, _F, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_float, \
    ctypes.c_void_p
_ARGTYPES = [_I] * 3 + [_P] * 8 + [_I] * 6 + [_LL] * 8 + [_F, _F, _P]
_FN = []


def _fn():
    if not _FN:
        fn = _build.load("decode_attention").decode_attention_launch
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _FN.append(fn)
    return _FN[0]


def head_group(rep: int) -> int:
    """Query heads per CTA: the largest instantiated group dividing the GQA
    ratio, so a kv head's rows are read once per group."""
    return next(g for g in HEAD_GROUPS if rep % g == 0)


def check(q, k_cache, v_cache, length, *, softcap: float) -> None:
    """The launch's argument checks (raising ``ValueError``): q [B, H, hd],
    k/v_cache [B, L, K, hd] on one device, one of f32 or bf16, the head dim
    dense and rows 16-byte aligned (any other strides); length int32 [B]
    on the same device."""
    name = "decode_attention"
    dev = q.device
    for t in (k_cache, v_cache, length):
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
    if q.dtype not in _DTYPE_CODE or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype:
        raise ValueError(f"{name}: dtypes q {q.dtype}, k {k_cache.dtype}, "
                         f"v {v_cache.dtype}; the kernel takes f32 or bf16, "
                         "the same for all three")
    if length.dtype != torch.int32:
        raise ValueError(f"{name}: length must be int32, got {length.dtype}")
    if q.dim() != 3 or k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k "
                         f"{tuple(k_cache.shape)}, v {tuple(v_cache.shape)}")
    b, h, hd = q.shape
    bk, L, kh, hdk = k_cache.shape
    if bk != b or hdk != hd or h % kh or tuple(length.shape) != (b,):
        raise ValueError(f"{name}: q {tuple(q.shape)}, k "
                         f"{tuple(k_cache.shape)}, length "
                         f"{tuple(length.shape)} do not line up")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {hd}; the kernel takes "
                         f"{HEAD_DIMS}")
    if softcap < 0:
        raise ValueError(f"{name}: softcap {softcap}")
    item = q.element_size()
    for t in (q, k_cache, v_cache):
        if t.stride(-1) != 1 or t.data_ptr() % 16 or any(
                s * item % 16 for s in t.stride()[:-1]):
            raise ValueError(f"{name}: the head dim must be dense and rows "
                             "16-byte aligned")
    if b > 65535 or h // head_group(h // kh) > 65535 or L >= 2 ** 31:
        raise ValueError(f"{name}: grid too large")


def _buffers(q, L: int, return_lse: bool):
    """(out, lse or None, the merge's two workspaces or None) as a launch
    allocates them: the pieces' partial accumulators and (max, sum) pairs
    when the cache is split over more than one ``CHUNK``-slot piece."""
    b, h, hd = q.shape
    dev = q.device
    out = torch.empty((b, h, hd), dtype=torch.float32 if return_lse
                      else q.dtype, device=dev)
    lse = torch.empty((b, h), dtype=torch.float32, device=dev) \
        if return_lse else None
    splits = max(1, -(-L // CHUNK))
    ws = None
    if splits > 1 and out.numel():
        ws = (torch.empty((b, h, splits, hd), dtype=torch.float32,
                          device=dev),
              torch.empty((b, h, splits, 2), dtype=torch.float32,
                          device=dev))
    return out, lse, ws


def dry_launch(q, k_cache, v_cache, length, *, softcap: float,
               return_lse: bool = False):
    """A launch on meta tensors: the checks, the output (and lse) and the
    merge's workspaces allocated on meta, the call's work over every slot
    of the cache (the lengths are not known there) added to
    ``cost.DRYRUN``.  Returns what :func:`launch` returns."""
    check(q, k_cache, v_cache, length, softcap=softcap)
    b, h, hd = q.shape
    L, kh = k_cache.shape[1], k_cache.shape[2]
    out, lse, ws = _buffers(q, L, return_lse)
    del ws
    if out.numel():
        add_dryrun(decode_cost(b, h, kh, hd, b * L, q.element_size(),
                               return_lse=return_lse))
    return (out, lse) if return_lse else out


def launch(q, k_cache, v_cache, length, *, softcap: float,
           return_lse: bool = False):
    """q, k/v_cache and length on one CUDA device, as :func:`check` takes
    them.  Returns a dense [B, H, hd] in q's dtype; with ``return_lse`` an
    f32 one and each row's f32 log-sum-exp [B, H] (-inf where the row has
    no valid slot)."""
    name = "decode_attention"
    check(q, k_cache, v_cache, length, softcap=softcap)
    dev = q.device
    b, h, hd = q.shape
    L, kh = k_cache.shape[1], k_cache.shape[2]
    length = length.contiguous()
    out, lse, ws = _buffers(q, L, return_lse)
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    rt = head_group(h // kh)
    splits = max(1, -(-L // CHUNK))
    ws_acc, ws_ml = ws if ws is not None else (None, None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _fn()(
            _DTYPE_CODE[q.dtype], hd, rt, q.data_ptr(), k_cache.data_ptr(),
            v_cache.data_ptr(), length.data_ptr(), out.data_ptr(),
            None if ws_acc is None else ws_acc.data_ptr(),
            None if ws_ml is None else ws_ml.data_ptr(),
            None if lse is None else lse.data_ptr(), b, h, kh, L, CHUNK,
            splits, q.stride(0), q.stride(1), k_cache.stride(0),
            k_cache.stride(1), k_cache.stride(2), v_cache.stride(0),
            v_cache.stride(1), v_cache.stride(2), 1.0 / math.sqrt(hd),
            float(softcap), stream)
    if rc != 0:
        raise RuntimeError(f"{name} failed with CUDA error {rc}")
    return (out, lse) if return_lse else out
