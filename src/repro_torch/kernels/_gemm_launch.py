"""Argument checks, tile and split choice, and the ctypes launch of the
grouped GEMM (``csrc/grouped_matmul.cu``), which serves both
``block_diag_matmul`` and ``moe_gmm``.  CUDA tensors only: the wrappers
route CPU tensors to their plain versions before reaching this module."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_I, _LL, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
_ARGTYPES = [_I, _I, _P, _P, _P, _P] + [_I] * 6 + [_LL] * 4 + [_I, _I, _P]
#: rows at or below which the skinny 8-row tile is used
SKINNY_M = 32
#: contraction slab depth of each tile (csrc/grouped_matmul.cu)
SLAB = {8: 32, 64: 16, 128: 16}
#: CTAs per SM a call aims for before it splits the contraction: the skinny
#: tile is small (several fit an SM); the tiled kernel fits two
CTAS_PER_SM = {8: 4, 64: 2, 128: 2}
_FN = []


def _fn():
    if not _FN:
        fn = _build.load("grouped_matmul").grouped_matmul_launch
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _FN.append(fn)
    return _FN[0]


def tile_rows(m: int) -> int:
    """Output rows per CTA: 8 at decode-sized M, else 128, or 64 where
    64-row tiles pad M less (M = 171: 192 rows instead of 256)."""
    if m <= SKINNY_M:
        return 8
    return 128 if -(-m // 128) * 128 <= -(-m // 64) * 64 else 64


def split_plan(tiles: int, k: int, slab: int, want_ctas: int):
    """(splits, k_per_split): split the contraction, in whole slabs, until
    ``tiles`` output tiles give about ``want_ctas`` CTAs; every split is
    non-empty."""
    slabs = -(-k // slab)
    want = max(1, min(slabs, -(-want_ctas // tiles)))
    per = -(-slabs // want) * slab
    return -(-k // per) if k else 1, max(per, slab)


def _vec_ok(t: torch.Tensor) -> bool:
    """The tensor's pointer and group/row strides are 4-element aligned."""
    return t.data_ptr() % (4 * t.element_size()) == 0 and \
        all(s % 4 == 0 for s in t.stride()[:2])


def launch(x: torch.Tensor, w: torch.Tensor, name: str) -> torch.Tensor:
    """x [G, M, K] @ w [G, K, N] on one CUDA device, both f32 or both bf16,
    the last dim dense (any group and row strides).  Returns a dense
    [G, M, N] in x's dtype."""
    if w.device != x.device:
        raise ValueError(f"{name}: tensors on {w.device} and {x.device}")
    if x.dtype not in _DTYPE_CODE or w.dtype != x.dtype:
        raise ValueError(f"{name}: dtypes {x.dtype} / {w.dtype}; the kernel "
                         "takes f32 or bf16, the same for both")
    if x.dim() != 3 or w.dim() != 3 or w.shape[0] != x.shape[0] \
            or w.shape[1] != x.shape[2]:
        raise ValueError(f"{name}: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} are not [G, M, K] and [G, K, N]")
    g, m, k = x.shape
    n = w.shape[2]
    if (x.stride(-1) != 1 and k > 1) or (w.stride(-1) != 1 and n > 1):
        raise ValueError(f"{name}: the last dim must be dense")
    out = torch.empty((g, m, n), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    tm = tile_rows(m)
    tiles = -(-n // 128) * -(-m // tm) * g
    splits, per = split_plan(tiles, k, SLAB[tm],
                             CTAS_PER_SM[tm] * _build.sm_count(x.device))
    if g * splits > 65535 or -(-m // tm) > 65535 or max(m, n, k) >= 2 ** 31:
        raise ValueError(f"{name}: grid too large")
    partial = torch.empty((splits, g, m, n), dtype=torch.float32,
                          device=x.device) if splits > 1 else None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = _fn()(_DTYPE_CODE[x.dtype], tm, x.data_ptr(), w.data_ptr(),
                   out.data_ptr(),
                   None if partial is None else partial.data_ptr(), splits,
                   per, g, m, k, n, x.stride(0), x.stride(1), w.stride(0),
                   w.stride(1), int(_vec_ok(x)), int(_vec_ok(w)), stream)
    if rc != 0:
        raise RuntimeError(f"{name} failed with CUDA error {rc}")
    return out
