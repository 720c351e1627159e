"""Argument checks, path, tile and split choice, and the ctypes launch of
the grouped GEMM (``csrc/grouped_matmul.cu``), which serves both
``block_diag_matmul`` and ``moe_gmm``.  :func:`launch` takes CUDA tensors
only: the wrappers route CPU tensors to their plain versions before
reaching it.  :func:`path_for` and the planning helpers are pure Python,
and :func:`wgmma_emulated` is plain PyTorch on any device."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_I, _LL, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
_ARGTYPES = {
    "grouped_matmul_launch": [_I, _I, _P, _P, _P, _P] + [_I] * 6
    + [_LL] * 4 + [_I, _I, _P],
    "grouped_matmul_wgmma_launch": [_I, _P, _P, _P, _P] + [_I] * 6
    + [_LL] * 4 + [_P],
}
#: rows at or below which the skinny 8-row tile is used
SKINNY_M = 32
#: contraction slab depth of each CUDA-core tile (csrc/grouped_matmul.cu)
SLAB = {8: 32, 64: 16, 128: 16}
#: contraction slab depth of the tensor-core tile
WGMMA_SLAB = 64
#: CTAs per SM a call aims for before it splits the contraction: the skinny
#: tile is small (several fit an SM); the tiled kernel fits two
CTAS_PER_SM = {8: 4, 64: 2, 128: 2}
#: the same for the tensor-core tile, by consumer warpgroups: one consumer
#: (96 KB of ring) fits two CTAs on an SM, two or three (128 / 160 KB) one
WGMMA_CTAS_PER_SM = {1: 2, 2: 1, 3: 1}
#: launches by path since import (``wgmma``: bf16 tensor-core tile;
#: ``tiled``: CUDA-core tile; ``skinny``: the 8-row tile), so a run can show
#: which path its calls took
PATH_LAUNCHES = {"wgmma": 0, "tiled": 0, "skinny": 0}
_FNS = {}


def _fn(name: str):
    if name not in _FNS:
        fn = getattr(_build.load("grouped_matmul"), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return _FNS[name]


def tile_rows(m: int) -> int:
    """Output rows per CTA of the CUDA-core paths (f32 calls and the bf16
    calls that :func:`path_for` keeps off the tensor cores): 8 at
    decode-sized M, else 128, or 64 where 64-row tiles pad M less (M = 171:
    192 rows instead of 256)."""
    if m <= SKINNY_M:
        return 8
    return 128 if -(-m // 128) * 128 <= -(-m // 64) * 64 else 64


def wgmma_consumers(m: int) -> int:
    """Consumer warpgroups (64 rows each) per CTA of the tensor-core tile:
    the count whose tile pads M least, the larger on a tie (the weight
    tile is then read by fewer CTAs): M = 171 takes 3 (192 rows, one CTA
    per expert), M = 2048 and M = 200 take 2, M = 33-64 takes 1."""
    return min((-(-m // (64 * c)) * 64 * c, -c, c) for c in (1, 2, 3))[2]


def _aligned16(t: torch.Tensor) -> bool:
    """Pointer and group/row strides 16-byte aligned, strides positive."""
    size = t.element_size()
    return t.data_ptr() % 16 == 0 and all(
        s > 0 and s * size % 16 == 0 for s in _strides(t))


def path_for(x: torch.Tensor, w: torch.Tensor) -> str:
    """The path a call takes, from dtype, shape and alignment alone:
    ``skinny`` for M <= 32; ``wgmma`` for bf16 with M > 32, K >= 1 and x's
    and w's pointers and group and row strides 16-byte aligned (what the
    tensor maps of the copy engine need); ``tiled`` otherwise (every f32
    call with M > 32, and the bf16 calls the tensor-core tile cannot
    take)."""
    m, k = x.shape[1], x.shape[2]
    if m <= SKINNY_M:
        return "skinny"
    if x.dtype == torch.bfloat16 and k >= 1 and _aligned16(x) \
            and _aligned16(w):
        return "wgmma"
    return "tiled"


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


def _strides(t: torch.Tensor):
    """(group, row) strides, the group stride of a single group taken as
    the rows' extent (a size-1 dim's stride is arbitrary in PyTorch)."""
    g, rows = t.shape[0], t.shape[1]
    sg, sr = t.stride(0), t.stride(1)
    return (sg if g > 1 else max(rows, 1) * sr), sr


def launch(x: torch.Tensor, w: torch.Tensor, name: str) -> torch.Tensor:
    """x [G, M, K] @ w [G, K, N] on one CUDA device, both f32 or both bf16,
    the last dim dense (any group and row strides).  Returns a dense
    [G, M, N] in x's dtype.  The path is :func:`path_for`'s, counted in
    ``PATH_LAUNCHES``; a build or launch error raises."""
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
    path = path_for(x, w)
    if path == "wgmma":
        nc = wgmma_consumers(m)
        tm, slab, per_sm = 64 * nc, WGMMA_SLAB, WGMMA_CTAS_PER_SM[nc]
    else:
        tm = tile_rows(m)
        slab, per_sm = SLAB[tm], CTAS_PER_SM[tm]
    tiles = -(-n // 128) * -(-m // tm) * g
    splits, per = split_plan(tiles, k, slab,
                             per_sm * _build.sm_count(x.device))
    if g * splits > 65535 or -(-m // tm) > 65535 or max(m, n, k) >= 2 ** 31:
        raise ValueError(f"{name}: grid too large")
    partial = torch.empty((splits, g, m, n), dtype=torch.float32,
                          device=x.device) if splits > 1 else None
    sxg, sxm = _strides(x)
    swg, swk = _strides(w)
    pp = None if partial is None else partial.data_ptr()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if path == "wgmma":
            rc = _fn("grouped_matmul_wgmma_launch")(
                nc, x.data_ptr(), w.data_ptr(), out.data_ptr(), pp, splits,
                per, g, m, k, n, sxg, sxm, swg, swk, stream)
        else:
            rc = _fn("grouped_matmul_launch")(
                _DTYPE_CODE[x.dtype], tm, x.data_ptr(), w.data_ptr(),
                out.data_ptr(), pp, splits, per, g, m, k, n, sxg, sxm, swg,
                swk, int(_vec_ok(x)), int(_vec_ok(w)), stream)
    if rc != 0:
        raise RuntimeError(f"{name} failed with CUDA error {rc} on the "
                           f"{path} path")
    PATH_LAUNCHES[path] += 1
    return out


def wgmma_emulated(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The tensor-core path's numerics in plain PyTorch: the contraction
    walked in ``WGMMA_SLAB``-deep slabs, each slab's bf16 products summed
    into an f32 accumulator, the result cast once to x's dtype (the CPU
    evidence that the chip check's tolerance fits the design)."""
    g, m, k = x.shape
    acc = torch.zeros((g, m, w.shape[2]), dtype=torch.float32,
                      device=x.device)
    for k0 in range(0, k, WGMMA_SLAB):
        acc += torch.bmm(x[:, :, k0:k0 + WGMMA_SLAB].float(),
                         w[:, k0:k0 + WGMMA_SLAB].float())
    return acc.to(x.dtype)
