"""Argument checks, the walk rule, path choice and the ctypes launch of the
flash-attention forward (``csrc/flash_attention.cu``).  :func:`launch`
takes CUDA tensors only: the wrapper routes CPU tensors to the plain
version before reaching it, and meta tensors to :func:`dry_launch`, which
runs the same checks and counts the launch and its work without one.
:func:`flash_plan` is the kernels' walk in pure Python, shared by the
emulation and the tests."""
from __future__ import annotations

import ctypes
import math
from typing import List, NamedTuple, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.cost import add_dryrun, flash_cost

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)

#: key tokens per tile and query rows per CTA (every kernel)
KEY_TILE = 64
QUERY_TILE = 128
#: launches by path since import, so a run can show which path its calls
#: took
PATH_LAUNCHES = {"mma": 0, "simt": 0}
#: the same for the launches the dry run predicts on meta tensors
DRY_PATH_LAUNCHES = {"mma": 0, "simt": 0}

_I, _LL, _F, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_float, \
    ctypes.c_void_p
_ARGTYPES = [_I, _I] + [_P] * 4 + [_I] * 5 + [_LL] * 9 + \
    [_I, _I, _F, _F, _P]


class QueryTile(NamedTuple):
    """One CTA's walk: query rows [q0, q1), key tiles [kt0, kt1) of
    ``KEY_TILE`` tokens in order, and for each walked tile whether it holds
    a masked (query, key) pair (else the kernel takes its unmasked
    branch)."""
    q0: int
    q1: int
    kt0: int
    kt1: int
    masked: Tuple[bool, ...]


def path_for(dtype) -> str:
    """The kernel a launch takes, from the dtype alone: bf16 on the tensor
    cores (``wgmma`` at hd 64 and 128, ``mma.sync`` at hd 32, chosen in
    ``csrc/flash_attention.cu``), f32 on the CUDA cores."""
    return "mma" if dtype == torch.bfloat16 else "simt"


def flash_plan(sq: int, sk: int, *, causal: bool,
               window: int) -> List[QueryTile]:
    """The kernels' walk (``csrc/flash_attention.cu``, ``walk_of`` and
    ``tile_masked``) for queries at positions sk - sq .. sk - 1: query tiles
    of ``QUERY_TILE`` rows; each walks the key tiles from the one holding its
    first row's window start (0 without a window) up to the one holding
    its last row's causal frontier (the last key without ``causal``); a
    walked tile needs a mask when it crosses sk, the causal frontier of the
    tile's first row or the window edge of its last row."""
    plan = []
    off = sk - sq
    for q0 in range(0, sq, QUERY_TILE):
        q1 = min(q0 + QUERY_TILE, sq)
        qa, qb = off + q0, off + q1 - 1
        k_end = min(sk, qb + 1) if causal else sk
        k_begin = max(0, qa - window + 1) if window > 0 else 0
        kt0, kt1 = k_begin // KEY_TILE, -(-k_end // KEY_TILE)
        masked = tuple(
            k0 + KEY_TILE > sk or (causal and k0 + KEY_TILE - 1 > qa)
            or (window > 0 and k0 <= qb - window)
            for k0 in range(kt0 * KEY_TILE, kt1 * KEY_TILE, KEY_TILE))
        plan.append(QueryTile(q0, q1, kt0, kt1, masked))
    return plan


def _fn():
    fn = _build.load("flash_attention").flash_attention_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def check(q, k, v, *, causal: bool, window: int, softcap: float) -> None:
    """The launch's argument checks (raising ``ValueError``): q [N, Sq,
    H, hd], k/v [N, Sk, KH, hd] on one device, one of f32 or bf16, with a
    dense head dim and 16-byte aligned rows (any batch, sequence and head
    strides)."""
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
    if n > 65535 or -(-sq // QUERY_TILE) > 65535:
        raise ValueError(f"{name}: grid too large")


def dry_launch(q, k, v, *, causal: bool, window: int, softcap: float):
    """A launch on meta tensors: the checks, the output allocated on meta,
    the predicted launch counted under its path in ``DRY_PATH_LAUNCHES``
    and its work added to ``cost.DRYRUN``.  Returns the output."""
    check(q, k, v, causal=causal, window=window, softcap=softcap)
    n, sq, h, hd = q.shape
    out = torch.empty((n, sq, h, hd), dtype=q.dtype, device=q.device)
    if out.numel():
        DRY_PATH_LAUNCHES[path_for(q.dtype)] += 1
        add_dryrun(flash_cost(n, sq, k.shape[1], h, k.shape[2], hd,
                              q.element_size(), causal=causal,
                              window=window))
    return out


def launch(q, k, v, *, causal: bool, window: int, softcap: float):
    """q [N, Sq, H, hd], k/v [N, Sk, KH, hd] on one CUDA device, as
    :func:`check` takes them.  Returns a dense [N, Sq, H, hd] in q's
    dtype."""
    name = "flash_attention"
    check(q, k, v, causal=causal, window=window, softcap=softcap)
    dev = q.device
    n, sq, h, hd = q.shape
    sk, kh = k.shape[1], k.shape[2]
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
    path = path_for(q.dtype)
    if rc != 0:
        raise RuntimeError(f"{name} failed with CUDA error {rc} on the "
                           f"{path} path")
    PATH_LAUNCHES[path] += 1
    return out
