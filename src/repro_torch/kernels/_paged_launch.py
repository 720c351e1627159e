"""Argument checks, path choice and the ctypes launch shared by the two
paged-attention wrappers (``csrc/paged_attention.cu``).  :func:`launch`
takes CUDA tensors only: the wrappers route CPU tensors to their plain
versions before reaching it."""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
HEAD_DIMS = (32, 64, 128)

#: query rows per CTA of each prefill path (csrc/paged_attention.cu)
PREFILL_ROWS = {"prefill_mma": 64, "prefill_simt": 32}
#: launches by path since import: the bf16-q prefill on tensor cores
#: (``prefill_mma``), the f32-q prefill on CUDA cores (``prefill_simt``) and
#: every decode step (``decode_split``: the lanes' lengths split over the
#: CTAs of a cluster), so a run can show which path its calls took
PATH_LAUNCHES = {"prefill_mma": 0, "prefill_simt": 0, "decode_split": 0}
#: decode_split: query rows per CTA at most, pieces (CTAs of one cluster)
#: at most, the CTAs per SM a call aims for before it splits the walk, and
#: warps per CTA
DECODE_ROWS, MAX_PIECES, DECODE_CTAS_PER_SM, DECODE_WARPS = 8, 8, 2, 4

_I, _LL, _F, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_float, \
    ctypes.c_void_p
_ARGTYPES = {
    "paged_decode_attention_launch":
        [_I, _I, _I] + [_P] * 8 + [_I] * 10 + [_LL, _LL, _F, _F, _P],
    "paged_prefill_attention_launch":
        [_I, _I, _I] + [_P] * 8 + [_I] * 7 + [_LL, _LL, _F, _F, _P],
}


def _fn(name: str):
    lib = _build.load("paged_attention")
    fn = getattr(lib, name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def path_for(q_dtype, chunk: bool) -> str:
    """The kernel a launch takes, from q's dtype alone: every decode step
    takes ``decode_split``; a bf16-q prefill chunk runs on the tensor cores,
    an f32-q one on the CUDA cores."""
    if not chunk:
        return "decode_split"
    return "prefill_mma" if q_dtype == torch.bfloat16 else "prefill_simt"


def decode_plan(*, h: int, kh: int, hd: int, kv_item: int, b: int, g: int,
                nb: int, bs: int, n_sm: int):
    """(hg, rt, pieces, piece) of a ``decode_split`` launch.

    ``rt``: query heads per kv head in a CTA, the largest of 8, 4, 2, 1
    dividing rep = H / K.  A load is VEC elements (:func:`load_elements`),
    so a kv head's row is ``hd / VEC`` lanes.  ``hg``: kv heads
    per CTA, the largest power of two dividing K with hg * hd / VEC <= 32
    lanes and hg * rt <= ``DECODE_ROWS``.  The table's NB * bs tokens are
    cut into ``pieces`` (<= ``MAX_PIECES``, enough for about
    ``DECODE_CTAS_PER_SM`` CTAs per SM) of ``piece`` tokens, a whole number
    of blocks, every piece non-empty."""
    rep = h // kh
    rt = next(r for r in (8, 4, 2, 1) if rep % r == 0)
    lanes = hd // load_elements(kv_item)
    hg = 1
    while kh % (2 * hg) == 0 and 2 * hg * lanes <= 32 \
            and 2 * hg * rt <= DECODE_ROWS:
        hg *= 2
    ctas = (kh // hg) * (rep // rt) * b * g
    want = max(1, min(MAX_PIECES, nb, -(-DECODE_CTAS_PER_SM * n_sm // ctas)))
    piece = max(1, -(-nb // want)) * bs
    return hg, rt, max(1, -(-nb * bs // piece)), piece


def load_elements(kv_item: int) -> int:
    """Pool elements per load of a ``decode_split`` lane (csrc ``KvLoad``):
    16 bytes of f32 or bf16, 8 int8 codes."""
    return 4 if kv_item == 4 else 8


def tokens_in_flight(rt: int) -> int:
    """Tokens each ``decode_split`` token group loads at once (csrc ``U``):
    8, or 4 when a CTA carries 4 or 8 query heads per kv head."""
    return 8 if rt <= 2 else 4


def token_groups(hg: int, hd: int, kv_item: int) -> int:
    """Token groups of a ``decode_split`` CTA (``DECODE_WARPS`` warps of 32
    lanes, a token row taking hg * hd / VEC lanes)."""
    return DECODE_WARPS * 32 // (hg * hd // load_elements(kv_item))


def _inner_contiguous(t: torch.Tensor) -> bool:
    """True when every dim but the leading (branch) one is dense row-major."""
    expect = 1
    for size, stride in zip(reversed(t.shape[1:]), reversed(t.stride()[1:])):
        if size != 1 and stride != expect:
            return False
        expect *= size
    return True


def _lead(t, n: int):
    """Add the leading branch dim when the caller passed a single branch."""
    return t if t is None or t.dim() == n else t.unsqueeze(0)


def launch(name: str, q, k_pool, v_pool, block_tables, qpos, *, k_scale,
           v_scale, softcap: float, chunk: bool):
    """Check the arguments and launch one kernel on the current stream.

    ``q``: [G, B, (C,) H, hd] contiguous, f32 or bf16; ``k/v_pool``:
    [G, P, bs, K, hd] with dense inner dims (a leading-dim stride is fine),
    q's dtype or int8 with f32 ``k/v_scale`` [G, P, bs, K]; ``block_tables``
    [B, NB] int32; ``qpos`` int32 lengths [B] (decode) or positions [B, C]
    (prefill).  Returns ``out`` shaped like ``q``."""
    k_pool, v_pool = _lead(k_pool, 5), _lead(v_pool, 5)
    k_scale, v_scale = _lead(k_scale, 4), _lead(v_scale, 4)
    dev = q.device
    tensors = [q, k_pool, v_pool, block_tables, qpos]
    quantized = k_scale is not None
    if (v_scale is not None) != quantized:
        raise ValueError("k_scale and v_scale come together")
    if quantized:
        tensors += [k_scale, v_scale]
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
    g, b = q.shape[0], q.shape[1]
    c = q.shape[2] if chunk else 1
    h, hd = q.shape[-2], q.shape[-1]
    gp, p_blocks, bs, kh, hd_p = k_pool.shape
    if q.dtype not in (torch.float32, torch.bfloat16) or not q.is_contiguous():
        raise ValueError(f"{name}: q must be contiguous f32/bf16, got "
                         f"{q.dtype}")
    if hd not in HEAD_DIMS or hd_p != hd:
        raise ValueError(f"{name}: head dim {hd} (pool {hd_p}); the kernel "
                         f"takes {HEAD_DIMS}")
    if gp != g or h % kh:
        raise ValueError(f"{name}: {g} query branches vs {gp} pool branches, "
                         f"{h} heads vs {kh} kv heads")
    if v_pool.shape != k_pool.shape or v_pool.stride() != k_pool.stride():
        raise ValueError(f"{name}: k/v pools differ in shape or strides")
    want_kv = torch.int8 if quantized else q.dtype
    if k_pool.dtype != want_kv or v_pool.dtype != want_kv:
        raise ValueError(f"{name}: pool dtype {k_pool.dtype}, expected "
                         f"{want_kv} for q {q.dtype}")
    if not _inner_contiguous(k_pool):
        raise ValueError(f"{name}: pool inner dims must be dense")
    item = k_pool.element_size()
    if (k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16
            or (g > 1 and k_pool.stride(0) * item % 16)):
        raise ValueError(f"{name}: pools must be 16-byte aligned")
    scale_gstride = 0
    if quantized:
        for s in (k_scale, v_scale):
            if (s.dtype != torch.float32 or tuple(s.shape) != (
                    g, p_blocks, bs, kh) or not _inner_contiguous(s)):
                raise ValueError(f"{name}: scales must be f32 [G, P, bs, K] "
                                 "with dense inner dims")
        if v_scale.stride() != k_scale.stride():
            raise ValueError(f"{name}: k/v scales differ in strides")
        scale_gstride = k_scale.stride(0) if g > 1 else 0
    nb = block_tables.shape[1]
    want_pos = (b, c) if chunk else (b,)
    for t, shape in ((block_tables, (b, nb)), (qpos, want_pos)):
        if (t.dtype != torch.int32 or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"{name}: index tensors must be contiguous int32 "
                             f"{shape}, got {t.dtype} {tuple(t.shape)}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    path = path_for(q.dtype, chunk)
    if chunk:
        row_tiles = -(-(h // kh) * c // PREFILL_ROWS[path])
        if kh > 65535 or g * row_tiles > 65535:
            raise ValueError(f"{name}: grid too large")
        shape_args = [g, b, c, h, kh, bs, nb]
    else:
        hg, rt, pieces, piece = decode_plan(
            h=h, kh=kh, hd=hd, kv_item=item, b=b, g=g, nb=nb, bs=bs,
            n_sm=_build.sm_count(dev))
        if (kh // hg) * (h // kh // rt) > 65535 or g * b > 65535:
            raise ValueError(f"{name}: grid too large")
        shape_args = [g, b, h, kh, bs, nb, hg, rt, pieces, piece]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _fn(name)(
            _DTYPE_CODE[q.dtype], _DTYPE_CODE[k_pool.dtype], hd,
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            k_scale.data_ptr() if quantized else None,
            v_scale.data_ptr() if quantized else None,
            block_tables.data_ptr(), qpos.data_ptr(), out.data_ptr(),
            *shape_args, k_pool.stride(0) if g > 1 else 0, scale_gstride,
            1.0 / math.sqrt(hd), float(softcap), stream)
    if rc != 0:
        raise RuntimeError(f"{name} failed with CUDA error {rc} on the "
                           f"{path} path")
    PATH_LAUNCHES[path] += 1
    return out
