"""Argument checks, path and split choice, and the ctypes launch of the quant
GEMM kernel (``csrc/quant_matmul.cu``).  :func:`launch` takes CUDA tensors
only: the wrapper routes CPU tensors to the plain version before reaching
this module.  :func:`path_for`, :func:`mma_plan` and :func:`split_count`
are pure Python."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_I, _P = ctypes.c_int, ctypes.c_void_p
_ARGTYPES = {
    "quant_matmul_launch": [_I, _I, _P, _P, _P, _P, _P] + [_I] * 6 + [_P],
    "quant_matmul_mma_launch": [_I, _I, _P, _P, _P, _P] + [_I] * 7 + [_P],
}
#: rows at or below which a call is decode-sized: the simt path's 8 x 32
#: tile that may split its groups, and the tensor-core ``mma_skinny`` path
DECODE_T, DECODE_BT, DECODE_BE = 32, 8, 32
#: CTAs per SM a decode-sized simt call aims for when it splits its groups
CTAS_PER_SM = 2
#: output columns per CTA of the tensor-core paths
MMA_BE = 128
#: output rows per CTA of ``mma_tile`` (128, or 64 where 128-row tiles
#: would leave more than half the SMs idle), and the splits of one cluster
MMA_TILE_T, MMA_TILE_T_SMALL, MAX_SPLITS = 128, 64, 8
#: launches by path since import (``mma_skinny`` / ``mma_tile``: bf16 x on
#: the tensor cores, T <= 32 / T > 32; ``simt``: CUDA-core f32 FMAs), so a
#: run can show which path its calls took
PATH_LAUNCHES = {"mma_skinny": 0, "mma_tile": 0, "simt": 0}
_FNS = {}


def _fn(name: str):
    if name not in _FNS:
        fn = getattr(_build.load("quant_matmul"), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return _FNS[name]


def path_for(x_dtype, t: int, d: int, e: int, group: int, bits: int,
             aligned: bool = True) -> str:
    """The path a call takes, from dtype, shape and alignment alone: bf16 x
    runs on the tensor cores (``mma_skinny`` for T <= 32, ``mma_tile``
    above) when a group is whole steps of 16 stored code rows (group a
    multiple of 16 for int8, of 32 for int4, at most 128) and its copies
    can be 16-byte ``cp.async`` (E % 16 == 0, D % 8 == 0, ``aligned``
    pointers); every other call (f32 x, and bf16 shapes the tensor-core
    paths cannot take) keeps the CUDA-core ``simt`` path."""
    step = 32 if bits == 4 else 16
    if x_dtype == torch.bfloat16 and aligned and group <= 128 \
            and group % step == 0 and e % 16 == 0 and d % 8 == 0:
        return "mma_skinny" if t <= DECODE_T else "mma_tile"
    return "simt"


def skinny_rows(t: int) -> int:
    """Rows per CTA of ``mma_skinny``: T padded to 8, 16 or 32."""
    return next(n for n in (8, 16, 32) if t <= n)


def mma_plan(g: int, t: int, e: int, n_groups: int, n_sm: int):
    """(tile_rows, splits, groups_per_split) of a tensor-core call.  At
    decode-sized T the groups are split over up to ``MAX_SPLITS`` CTAs of a
    cluster, enough for about one CTA per SM; splits cover the groups in
    order, every split non-empty.  ``mma_tile`` does not split: 128-row
    tiles, or 64 when 128-row tiles give fewer CTAs than half the SMs (on
    an H100, ``scripts/time_quant_decode_plans.py``: T 200 at E 2048, 32
    CTAs, runs about a quarter faster on 64-row tiles; T 1024, 128 CTAs,
    about 40% slower)."""
    tiles = -(-e // MMA_BE) * g
    if t > DECODE_T:
        rows = MMA_TILE_T if 2 * -(-t // MMA_TILE_T) * tiles >= n_sm \
            else MMA_TILE_T_SMALL
        return rows, 1, n_groups
    want = max(1, min(n_groups, MAX_SPLITS, -(-n_sm // tiles)))
    per = -(-n_groups // want)
    return skinny_rows(t), -(-n_groups // per), per


def split_count(g: int, t: int, e: int, n_groups: int, n_sm: int) -> int:
    """Group splits of a simt call: 1 at prefill-sized T; at decode-sized T
    enough to give ~``CTAS_PER_SM`` CTAs per SM, every split non-empty."""
    if t > DECODE_T:
        return 1
    tiles = -(-e // DECODE_BE) * -(-t // DECODE_BT) * g
    want = max(1, min(n_groups, -(-CTAS_PER_SM * n_sm // tiles)))
    per = -(-n_groups // want)
    return -(-n_groups // per)


def _aligned16(*ts) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def launch(x: torch.Tensor, q: torch.Tensor,
           scales: torch.Tensor) -> torch.Tensor:
    """Check the arguments and launch one kernel on the current stream (the
    simt path's decode-sized split adds its ordered reduce).

    ``x``: [G, T, D] contiguous f32/bf16; ``q``: int8 [G, D, E] or
    nibble-packed [G, D/2, E]; ``scales``: f32 [G, D/g, E]; all contiguous
    on x's device.  Returns [G, T, E] in x's dtype.  The path is
    :func:`path_for`'s, counted in ``PATH_LAUNCHES``."""
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
    path = path_for(x.dtype, t, d, e, group, bits,
                    _aligned16(x, q, scales, out))
    n_sm = _build.sm_count(dev)
    partial = None
    if path == "simt":
        splits = split_count(g, t, e, n_g, n_sm)
        if g * splits > 65535 or -(-t // DECODE_BT) > 65535:
            raise ValueError(f"{name}: grid too large")
        if splits > 1:
            partial = torch.empty((splits, g, t, e), dtype=torch.float32,
                                  device=dev)
    else:
        rows_per, splits, per = mma_plan(g, t, e, n_g, n_sm)
        if g * -(-t // rows_per) > 65535:
            raise ValueError(f"{name}: grid too large")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if path == "simt":
            rc = _fn("quant_matmul_launch")(
                _DTYPE_CODE[x.dtype], bits, x.data_ptr(), q.data_ptr(),
                scales.data_ptr(), out.data_ptr(),
                None if partial is None else partial.data_ptr(), splits, g,
                t, d, e, group, stream)
        else:
            rc = _fn("quant_matmul_mma_launch")(
                bits, rows_per, x.data_ptr(), q.data_ptr(), scales.data_ptr(),
                out.data_ptr(), splits, per, g, t, d, e, group, stream)
    if rc != 0:
        raise RuntimeError(f"{name} failed with CUDA error {rc} on the "
                           f"{path} path")
    PATH_LAUNCHES[path] += 1
    return out
