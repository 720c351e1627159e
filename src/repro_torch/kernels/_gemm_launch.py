"""Argument checks, path, tile and split choice, and the ctypes launch of
the grouped GEMM (``csrc/grouped_matmul.cu``), which serves both
``block_diag_matmul`` and ``moe_gmm``.  :func:`launch` takes CUDA tensors
only: the wrappers route CPU tensors to their plain versions before
reaching it, and meta tensors to :func:`dry_launch`, which runs the same
checks, path and plan (on an H100's SM count) without a launch.
:func:`path_for` and the planning helpers are pure Python, and
:func:`wgmma_emulated`, :func:`tiled_emulated` and :func:`skinny_emulated`
are plain PyTorch on any device.  The ragged entry (``moe_gmm_ragged``)
has its own checks, path rule, launch and emulation at the end
(:func:`ragged_launch`, :func:`ragged_emulated`)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.cost import add_dryrun, gemm_cost, ragged_gemm_cost

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_I, _LL, _P = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p


class _SkinnyArgs(ctypes.Structure):
    """``SkinnyArgs`` of csrc/grouped_matmul.cu, field for field."""
    _fields_ = [(f, ctypes.c_int) for f in (
        "dtype", "mma", "rows", "cols", "splits", "per_split", "G", "M", "K",
        "N")] + [(f, ctypes.c_longlong) for f in ("sxg", "sxm", "swg",
                                                  "swk")] \
        + [("vec_x", ctypes.c_int), ("vec_w", ctypes.c_int)]


_ARGTYPES = {
    "grouped_matmul_launch": [_I, _I, _P, _P, _P, _P] + [_I] * 6
    + [_LL] * 4 + [_I, _I, _P],
    "grouped_matmul_wgmma_launch": [_I, _P, _P, _P, _P] + [_I] * 6
    + [_LL] * 4 + [_P],
    "grouped_matmul_skinny_launch": [ctypes.POINTER(_SkinnyArgs)] + [_P] * 4,
    "grouped_matmul_ragged_launch": [_I] * 3 + [_P] * 4 + [_I] * 4
    + [_LL] * 3 + [_I, _I, _P],
}
#: rows at or below which a call takes a decode-sized tile
SKINNY_M = 32
#: contraction slab depth of each CUDA-core tile of M > 32
#: (csrc/grouped_matmul.cu)
SLAB = {64: 16, 128: 16}
#: contraction slab depth of the tensor-core tile
WGMMA_SLAB = 64
#: CTAs per SM a call of M > 32 aims for before it splits the contraction
#: (the tiled kernel fits two on an SM)
CTAS_PER_SM = {64: 2, 128: 2}
#: the same for the tensor-core tile, by consumer warpgroups: one consumer
#: (96 KB of ring) fits two CTAs on an SM, two or three (128 / 160 KB) one
WGMMA_CTAS_PER_SM = {1: 2, 2: 1, 3: 1}
#: decode-sized tiles: the CTAs of one cluster at most (the portable
#: size), the contraction rows a split is whole steps of (``mma_skinny``:
#: the k16 step; ``skinny``: 32 rows, its shallowest slab), and the CTAs
#: per SM a call aims for
MAX_SPLITS = 8
SKINNY_STEP = {"mma_skinny": 16, "skinny": 32}
SKINNY_CTAS_PER_SM = 4
#: SMs of the port's card (an H100 SXM5), the plan's SM count on meta
H100_SMS = 132
#: launches by path since import (``wgmma``: bf16 tensor-core tile;
#: ``tiled``: CUDA-core tile; ``mma_skinny``: bf16 decode-sized tile on
#: ``mma.sync``; ``skinny``: the CUDA-core decode-sized tile; the ragged
#: entry's two tilings, ``ragged_decode`` and ``ragged_prefill``), so a run
#: can show which path its calls took
PATH_LAUNCHES = {"wgmma": 0, "tiled": 0, "mma_skinny": 0, "skinny": 0,
                 "ragged_decode": 0, "ragged_prefill": 0}
#: the same for the launches the dry run predicts on meta tensors
DRY_PATH_LAUNCHES = dict.fromkeys(PATH_LAUNCHES, 0)
_FNS = {}
#: call plans by argument key (:func:`launch`), at most ``_MAX_PLANS``
_PLANS = {}
_MAX_PLANS = 4096


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


def skinny_rows(m: int) -> int:
    """x rows per CTA of ``mma_skinny``: M padded to 8, 16 or 32."""
    return next(r for r in (8, 16, 32) if m <= r)


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
    """The path a call takes, from dtype, shape and alignment alone.  bf16
    with x's and w's pointers and group and row strides 16-byte aligned
    (what 16-byte ``cp.async`` copies and the copy engine's tensor maps
    need) runs on the tensor cores: ``mma_skinny`` for M <= 32, ``wgmma``
    above (K >= 1).  Every other call keeps the CUDA cores: ``skinny`` for
    M <= 32, ``tiled`` above (every f32 call, and the bf16 calls the
    tensor-core tiles cannot take)."""
    m, k = x.shape[1], x.shape[2]
    tc = x.dtype == torch.bfloat16 and _aligned16(x) and _aligned16(w)
    if m <= SKINNY_M:
        return "mma_skinny" if tc else "skinny"
    return "wgmma" if tc and k >= 1 else "tiled"


def split_plan(tiles: int, k: int, slab: int, want_ctas: int):
    """(splits, k_per_split) of a call of M > 32: split the contraction, in
    whole slabs, until ``tiles`` output tiles give about ``want_ctas``
    CTAs; every split is non-empty."""
    slabs = -(-k // slab)
    want = max(1, min(slabs, -(-want_ctas // tiles)))
    per = -(-slabs // want) * slab
    return -(-k // per) if k else 1, max(per, slab)


def skinny_plan(path: str, g: int, m: int, k: int, n: int, n_sm: int,
                cols: int | None = None):
    """(rows, cols, splits, per_split) of a decode-sized call: ``rows`` x
    ``cols`` outputs per CTA and the contraction cut into ``splits`` <=
    ``MAX_SPLITS`` slices of ``per_split`` rows, the CTAs of one cluster.
    Slices are whole ``SKINNY_STEP`` steps, in order, every one non-empty,
    enough of them for about ``SKINNY_CTAS_PER_SM`` CTAs per SM.
    ``mma_skinny`` pads M to 8, 16 or 32 rows, ``skinny`` takes 8-row
    tiles.  Both take 128 columns, or 64 where 128-column tiles in clusters
    of 8 give fewer CTAs than that and every slice would still be longer
    than 128 rows (K > 1024): more CTAs then keep more of w in flight,
    while shorter slices are bound by latency and narrower tiles only add
    CTAs (``scripts/time_skinny_gemm.py`` on an H100, both dtypes: the
    mLSTM's 4 x 384 and the semantic up-projection at K 1024 ran faster at
    128 columns, the down-projection at K 2816 at 64).  ``cols`` forces
    the width."""
    step = SKINNY_STEP[path]
    rows = skinny_rows(m) if path == "mma_skinny" else tile_rows(m)
    target = SKINNY_CTAS_PER_SM * n_sm
    row_tiles = -(-m // rows) * g
    if cols is None:
        cols, narrowest = 128, 64 if path == "mma_skinny" else 32
        while cols > narrowest and n > cols // 2 and k > 128 * MAX_SPLITS \
                and -(-n // cols) * row_tiles * MAX_SPLITS < target:
            cols //= 2
    tiles = -(-n // cols) * row_tiles
    steps = max(1, -(-k // step))
    per = -(-steps // max(1, min(steps, MAX_SPLITS, -(-target // tiles))))
    return rows, cols, -(-steps // per), per * step


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


def check(x: torch.Tensor, w: torch.Tensor, name: str):
    """The launch's argument checks (raising ``ValueError``); returns
    (G, M, K, N)."""
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
    if g * m * n and max(m, n, k) >= 2 ** 31:
        raise ValueError(f"{name}: grid too large")
    return g, m, k, n


def _tiling(path: str, g: int, m: int, k: int, n: int, n_sm: int, name: str):
    """The plan of a call of M > 32: (consumer warpgroups or None, tile
    rows, splits, contraction rows a split), checked against the grid."""
    if path == "wgmma":
        nc = wgmma_consumers(m)
        tm, slab, per_sm = 64 * nc, WGMMA_SLAB, WGMMA_CTAS_PER_SM[nc]
    else:
        nc, tm = None, tile_rows(m)
        slab, per_sm = SLAB[tm], CTAS_PER_SM[tm]
    tiles = -(-n // 128) * -(-m // tm) * g
    splits, per = split_plan(tiles, k, slab, per_sm * n_sm)
    if g * splits > 65535 or -(-m // tm) > 65535:
        raise ValueError(f"{name}: grid too large")
    return nc, tm, splits, per


def _skinny_tiling(path: str, g: int, m: int, k: int, n: int, n_sm: int,
                   name: str):
    """:func:`skinny_plan`, checked against the grid."""
    rows, cols, splits, per = skinny_plan(path, g, m, k, n, n_sm)
    if g * -(-m // rows) > 65535 or -(-n // cols) > 65535:
        raise ValueError(f"{name}: grid too large")
    return rows, cols, splits, per


def dry_launch(x: torch.Tensor, w: torch.Tensor, name: str) -> torch.Tensor:
    """A launch on meta tensors: the checks, path and plan (on
    ``H100_SMS`` SMs), the output and the split-K workspace allocated on
    meta, the predicted launch counted under its path in
    ``DRY_PATH_LAUNCHES`` and its work added to ``cost.DRYRUN``.  Returns
    the output."""
    g, m, k, n = check(x, w, name)
    out = torch.empty((g, m, n), dtype=x.dtype, device=x.device)
    if g * m * n == 0:
        return out
    path = path_for(x, w)
    if path in SKINNY_STEP:
        _skinny_tiling(path, g, m, k, n, H100_SMS, name)
    else:
        splits = _tiling(path, g, m, k, n, H100_SMS, name)[2]
        if splits > 1:
            torch.empty((splits, g, m, n), dtype=torch.float32,
                        device=x.device)
    DRY_PATH_LAUNCHES[path] += 1
    add_dryrun(gemm_cost(g, m, k, n, x.element_size()))
    return out


def _plan(x: torch.Tensor, w: torch.Tensor, name: str):
    """(path, out shape, device index, call) for a call on x and w: the
    argument checks (raising ``ValueError``), the path, tile and split, and
    ``call(x, w, out, stream) -> rc`` with every argument that the call's
    key fixes bound.  Path None: nothing to launch (an empty output)."""
    g, m, k, n = check(x, w, name)
    index, shape = x.device.index, (g, m, n)
    if g * m * n == 0:
        return None, shape, index, None
    path = path_for(x, w)
    sxg, sxm = _strides(x)
    swg, swk = _strides(w)
    n_sm = _build.sm_count(x.device)
    code = _DTYPE_CODE[x.dtype]
    if path in SKINNY_STEP:
        rows, cols, splits, per = _skinny_tiling(path, g, m, k, n, n_sm, name)
        args = _SkinnyArgs(code, int(path == "mma_skinny"), rows, cols,
                           splits, per, g, m, k, n, sxg, sxm, swg, swk,
                           int(_vec_ok(x)), int(_vec_ok(w)))
        fn, ptr = _fn("grouped_matmul_skinny_launch"), ctypes.pointer(args)

        def call(x, w, out, stream):
            return fn(ptr, x.data_ptr(), w.data_ptr(), out.data_ptr(), stream)
        return path, shape, index, call
    nc, tm, splits, per = _tiling(path, g, m, k, n, n_sm, name)
    dev = x.device
    if path == "wgmma":
        fn = _fn("grouped_matmul_wgmma_launch")
        lead, tail = (nc,), (splits, per, g, m, k, n, sxg, sxm, swg, swk)
    else:
        fn = _fn("grouped_matmul_launch")
        lead = (code, tm)
        tail = (splits, per, g, m, k, n, sxg, sxm, swg, swk,
                int(_vec_ok(x)), int(_vec_ok(w)))

    def call(x, w, out, stream):
        partial = torch.empty((splits, g, m, n), dtype=torch.float32,
                              device=dev) if splits > 1 else None
        return fn(*lead, x.data_ptr(), w.data_ptr(), out.data_ptr(),
                  None if partial is None else partial.data_ptr(), *tail,
                  stream)
    return path, shape, index, call


def launch(x: torch.Tensor, w: torch.Tensor, name: str) -> torch.Tensor:
    """x [G, M, K] @ w [G, K, N] on one CUDA device, both f32 or both bf16,
    the last dim dense (any group and row strides).  Returns a dense
    [G, M, N] in x's dtype.  The path is :func:`path_for`'s, counted in
    ``PATH_LAUNCHES``; a build or launch error raises.

    The checks, the path and the plan are a function of the arguments'
    dtypes, devices, shapes, strides and pointer alignment, so they run
    once per such key and are cached: a call with a known key has passed
    them, and does only the output's allocation, the launch and the
    launch-error check."""
    key = (x.dtype, w.dtype, x.device, w.device, x.shape, w.shape,
           x.stride(), w.stride(), x.data_ptr() % 16, w.data_ptr() % 16)
    plan = _PLANS.get(key)
    if plan is None:
        plan = _plan(x, w, name)
        if len(_PLANS) >= _MAX_PLANS:
            _PLANS.clear()
        _PLANS[key] = plan
    path, shape, index, call = plan
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    if path is None:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if torch.cuda.current_device() == index:
        rc = call(x, w, out, stream)
    else:
        with torch.cuda.device(index):
            rc = call(x, w, out, stream)
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


def tiled_emulated(x: torch.Tensor, w: torch.Tensor, n_sm: int = 132, *,
                   drop_tile=None, drop_split=None) -> torch.Tensor:
    """The CUDA-core tile's numerics (``tiled``: M > 32, every f32 call and
    the bf16 calls the tensor cores cannot take) in plain PyTorch, walking
    :func:`_tiling`'s plan on a card of ``n_sm`` SMs: for each split, each
    (64 MH) x 128 output tile sums its products over the split's
    contraction rows a 16-deep slab at a time into an f32 accumulator (x
    and w widened to f32, as the kernel stages them) and writes it to the
    split's f32 partial sums; the partials are then added in split order
    from 0 (``splitk_reduce_kernel``; one split is the tile itself) and
    cast once to x's dtype.  ``drop_tile`` ((group, row tile, column
    tile)) leaves that output tile out of every split, ``drop_split`` (an
    index) that split out of every tile, as a faulty kernel would."""
    g, m, k = x.shape
    n = w.shape[2]
    if path_for(x, w) != "tiled":
        raise ValueError(f"x {tuple(x.shape)} {x.dtype}: not a call of the "
                         "tiled path")
    _, tm, splits, per = _tiling("tiled", g, m, k, n, n_sm, "tiled_emulated")
    slab, xf, wf = SLAB[tm], x.float(), w.float()
    partial = torch.zeros((splits, g, m, n), dtype=torch.float32,
                          device=x.device)
    for s in range(splits):
        if s == drop_split:
            continue
        k_end = min(k, (s + 1) * per)
        for r0 in range(0, m, tm):
            for c0 in range(0, n, 128):
                acc = partial[s, :, r0:r0 + tm, c0:c0 + 128]
                for k0 in range(s * per, k_end, slab):
                    k1 = min(k_end, k0 + slab)
                    acc += torch.bmm(xf[:, r0:r0 + tm, k0:k1],
                                     wf[:, k0:k1, c0:c0 + 128])
    if drop_tile is not None:
        gi, ri, ci = drop_tile
        partial[:, gi, ri * tm:(ri + 1) * tm, ci * 128:(ci + 1) * 128] = 0.0
    out = torch.zeros((g, m, n), dtype=torch.float32, device=x.device)
    for s in range(splits):
        out += partial[s]
    return out.to(x.dtype)


def skinny_emulated(x: torch.Tensor, w: torch.Tensor,
                    n_sm: int = 132) -> torch.Tensor:
    """The decode-sized paths' numerics in plain PyTorch, walking
    :func:`skinny_plan` on a card of ``n_sm`` SMs: each cluster rank's
    slice of the contraction in the kernel's steps (``mma_skinny``'s k16
    steps, ``skinny``'s 32-deep slabs), every step's products summed into
    the rank's f32 tile; then the ranks' tiles added in rank order from 0
    (the in-cluster merge) and the sum cast once to x's dtype."""
    g, m, k = x.shape
    n = w.shape[2]
    path = path_for(x, w)
    if path not in SKINNY_STEP:
        raise ValueError(f"M = {m}: not a decode-sized call")
    _, _, splits, per = skinny_plan(path, g, m, k, n, n_sm)
    step = SKINNY_STEP[path]
    out = torch.zeros((g, m, n), dtype=torch.float32, device=x.device)
    for rank in range(splits):
        tile = torch.zeros_like(out)
        end = min(k, (rank + 1) * per)
        for k0 in range(rank * per, end, step):
            k1 = min(end, k0 + step)
            tile += torch.bmm(x[:, :, k0:k1].float(), w[:, k0:k1].float())
        out += tile
    return out.to(x.dtype)


# ------------------------------------------------------------ ragged entry
#: R at or below which a ragged call takes the decode-sized tiling (a
#: decode step's assignments: LAYER 8 lanes x top 4, SEMANTIC twice that)
RAGGED_DECODE_R = 64
#: the decode-sized ragged tiling: rows a pass and columns a CTA
#: (csrc ``RG_BN``, ``RG_BC``)
RAGGED_PASS_ROWS, RAGGED_COLS = 8, 128


def ragged_path_for(x: torch.Tensor, w: torch.Tensor) -> str:
    """The ragged entry's tiling, from R = x.shape[0] alone (never the
    offsets): ``ragged_decode`` at R <= ``RAGGED_DECODE_R``, else
    ``ragged_prefill``; the dtype picks the cores (bf16 the tensor cores,
    f32 the CUDA cores, no TF32)."""
    return "ragged_decode" if x.shape[0] <= RAGGED_DECODE_R \
        else "ragged_prefill"


def ragged_tile_rows(r: int, g: int, dtype) -> int:
    """Rows of a prefill-sized ragged tile: the average segment, ceil(R /
    G) rows, rounded up to the tile's step, so a typical expert's rows take
    one tile and its weight tile is read once: bf16 64 a consumer
    warpgroup, at most 3; f32 64 or 128."""
    avg = -(-r // max(g, 1))
    if dtype == torch.bfloat16:
        return 64 * min(3, max(1, -(-avg // 64)))
    return 64 if avg <= 64 else 128


def ragged_slots(r: int, g: int, bm: int) -> int:
    """Row-tile slots of a prefill-sized launch: enough for every group's
    ceil(rows / bm) tiles and the zero tail's, whatever the offsets."""
    return -(-r // bm) + g + 1


def ragged_walk(offsets, r: int, n: int, path: str, dtype):
    """The output tiles a ragged launch writes, in launch order, as
    (group, row0, row1, col0, col1) on host ``offsets`` (a list; G + 1
    entries, clamped to [0, R]); group G writes zeros over rows
    [offsets[G], R).  Decode-sized: each group's rows in passes of
    ``RAGGED_PASS_ROWS`` per column tile of ``RAGGED_COLS``, the tail a
    tile a column tile.  Prefill-sized: slot s is the s-th
    ``ragged_tile_rows`` block of group 0's rows, group 1's, ..., the
    tail's (csrc ``ragged_tile``), over 128-column tiles."""
    off = [min(max(int(o), 0), r) for o in offsets]
    g = len(off) - 1
    seg = [(gi, off[gi], off[gi + 1] if gi < g else r) for gi in range(g + 1)]
    tiles = []
    if path == "ragged_decode":
        cols = range(0, n, RAGGED_COLS)
        for c0 in cols:
            for gi, lo, hi in seg[:-1]:
                tiles += [(gi, r0, min(r0 + RAGGED_PASS_ROWS, hi), c0,
                           min(c0 + RAGGED_COLS, n))
                          for r0 in range(lo, hi, RAGGED_PASS_ROWS)]
            if seg[-1][1] < r:
                tiles.append((g, seg[-1][1], r, c0, min(c0 + RAGGED_COLS, n)))
        return tiles
    bm = ragged_tile_rows(r, g, dtype)
    blocks = [(gi, r0, min(r0 + bm, hi)) for gi, lo, hi in seg
              for r0 in range(lo, hi, bm)]
    if len(blocks) > ragged_slots(r, g, bm):
        raise AssertionError("more tiles than slots")
    return [(gi, r0, r1, c0, min(c0 + 128, n)) for gi, r0, r1 in blocks
            for c0 in range(0, n, 128)]


def ragged_check(x: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor,
                 name: str):
    """The ragged launch's argument checks (raising ``ValueError``);
    returns (G, R, K, N)."""
    if w.device != x.device or offsets.device != x.device:
        raise ValueError(f"{name}: tensors on {x.device}, {w.device} and "
                         f"{offsets.device}")
    if x.dtype not in _DTYPE_CODE or w.dtype != x.dtype:
        raise ValueError(f"{name}: dtypes {x.dtype} / {w.dtype}; the kernel "
                         "takes f32 or bf16, the same for both")
    if x.dim() != 2 or w.dim() != 3 or w.shape[1] != x.shape[1]:
        raise ValueError(f"{name}: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} are not [R, K] and [G, K, N]")
    g, (r, k), n = w.shape[0], x.shape, w.shape[2]
    if offsets.dtype != torch.int32 or tuple(offsets.shape) != (g + 1,) \
            or offsets.stride(0) != 1:
        raise ValueError(f"{name}: offsets {offsets.dtype} "
                         f"{tuple(offsets.shape)}; want a dense int32 "
                         f"[{g + 1}]")
    if k < 1 or (x.stride(-1) != 1 and k > 1) or (w.stride(-1) != 1
                                                  and n > 1):
        raise ValueError(f"{name}: K {k} (at least 1) and dense last dims")
    if x.dtype == torch.bfloat16 and not (_aligned16(x[None])
                                          and _aligned16(w)):
        raise ValueError(f"{name}: bf16 pointers and strides must be "
                         "16-byte aligned")
    path = ragged_path_for(x, w)
    rows = g + 1 if path == "ragged_decode" else ragged_slots(
        r, g, ragged_tile_rows(r, g, x.dtype))
    if max(r, k, n) >= 2 ** 31 or rows > 65535:
        raise ValueError(f"{name}: grid too large")
    return g, r, k, n


def ragged_dry_launch(x: torch.Tensor, w: torch.Tensor,
                      offsets: torch.Tensor, name: str) -> torch.Tensor:
    """A ragged launch on meta tensors: the checks and path, the output on
    meta, the predicted launch under its path in ``DRY_PATH_LAUNCHES`` and
    its worst-case work (``cost.ragged_gemm_cost``: the offsets are not
    known on meta) in ``cost.DRYRUN``."""
    g, r, k, n = ragged_check(x, w, offsets, name)
    out = torch.empty((r, n), dtype=x.dtype, device=x.device)
    if r * n:
        DRY_PATH_LAUNCHES[ragged_path_for(x, w)] += 1
        add_dryrun(ragged_gemm_cost(g, r, k, n, x.element_size()))
    return out


def _ragged_plan(x: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor,
                 name: str):
    """(path, out shape, device index, call) of a ragged call, as
    :func:`_plan`'s; ``call(x, w, offsets, out, stream) -> rc``."""
    g, r, k, n = ragged_check(x, w, offsets, name)
    index, shape = x.device.index, (r, n)
    if r * n == 0:
        return None, shape, index, None
    path = ragged_path_for(x, w)
    tiling = int(path == "ragged_prefill")
    tile = ragged_tile_rows(r, g, x.dtype) if tiling else 0
    if tiling and x.dtype == torch.bfloat16:
        tile //= 64                      # consumer warpgroups
    sxm = x.stride(0) if r > 1 else k
    swg, swk = _strides(w)
    vec = (int(_vec_ok(x[None])), int(_vec_ok(w)))
    fn, code = _fn("grouped_matmul_ragged_launch"), _DTYPE_CODE[x.dtype]

    def call(x, w, offsets, out, stream):
        return fn(code, tiling, tile, x.data_ptr(), w.data_ptr(),
                  offsets.data_ptr(), out.data_ptr(), g, r, k, n, sxm, swg,
                  swk, *vec, stream)
    return path, shape, index, call


def ragged_launch(x: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor,
                  name: str) -> torch.Tensor:
    """out [R, N] = rows offsets[g] .. offsets[g + 1] of x [R, K] times w[g]
    of w [G, K, N], rows at or past offsets[G] zero, on one CUDA device;
    x, w both f32 or both bf16 (bf16 16-byte aligned), their last dims
    dense; offsets a dense int32 [G + 1] on the same device, non-decreasing
    from 0, never read on the host.  One CUDA kernel on
    :func:`ragged_path_for`'s tiling, counted in ``PATH_LAUNCHES``; a build
    or launch error raises.  Plans are cached as :func:`launch`'s (the
    offsets' values are not in the key: no plan depends on them)."""
    key = ("ragged", x.dtype, w.dtype, x.device, w.device, offsets.device,
           offsets.dtype, x.shape, w.shape, offsets.shape, x.stride(),
           w.stride(), offsets.stride(), x.data_ptr() % 16,
           w.data_ptr() % 16)
    plan = _PLANS.get(key)
    if plan is None:
        plan = _ragged_plan(x, w, offsets, name)
        if len(_PLANS) >= _MAX_PLANS:
            _PLANS.clear()
        _PLANS[key] = plan
    path, shape, index, call = plan
    out = torch.empty(shape, dtype=x.dtype, device=x.device)
    if path is None:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if torch.cuda.current_device() == index:
        rc = call(x, w, offsets, out, stream)
    else:
        with torch.cuda.device(index):
            rc = call(x, w, offsets, out, stream)
    if rc != 0:
        raise RuntimeError(f"{name} failed with CUDA error {rc} on the "
                           f"{path} path")
    PATH_LAUNCHES[path] += 1
    return out


def ragged_emulated(x: torch.Tensor, w: torch.Tensor, offsets, *,
                    drop_tile=None) -> torch.Tensor:
    """The ragged entry's numerics in plain PyTorch, walking
    :func:`ragged_walk`'s tiles on host ``offsets``: each tile's rows of x
    (its segment's, masked at the segment's end) times its group's column
    tile of w, the contraction in the kernel's steps (decode-sized:
    ``mma_skinny``'s k16 steps in bf16, ``skinny``'s 32-deep slabs in f32;
    prefill-sized: ``wgmma``'s 64-deep slabs in bf16, ``tiled``'s 16-deep
    slabs in f32) summed in f32 and cast once; the tail's tiles zero.
    ``drop_tile`` (an index into the walk) leaves that tile unwritten (0),
    as a faulty kernel would."""
    g = w.shape[0]
    r, k = x.shape
    n = w.shape[2]
    path = ragged_path_for(x, w)
    bf = x.dtype == torch.bfloat16
    if path == "ragged_decode":
        step = SKINNY_STEP["mma_skinny" if bf else "skinny"]
    else:
        step = WGMMA_SLAB if bf else SLAB[ragged_tile_rows(r, g, x.dtype)]
    out = torch.zeros((r, n), dtype=torch.float32, device=x.device)
    for i, (gi, r0, r1, c0, c1) in enumerate(
            ragged_walk(list(offsets), r, n, path, x.dtype)):
        if i == drop_tile or gi == g:
            continue
        acc = out[r0:r1, c0:c1]
        for k0 in range(0, k, step):
            acc += x[r0:r1, k0:k0 + step].float() \
                @ w[gi, k0:k0 + step, c0:c1].float()
    return out.to(x.dtype)
