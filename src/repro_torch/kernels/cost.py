"""The work of one kernel call: the flops and the bytes of the bound
formulas (``PERF.md`` §6), which ``chip_smoke.py``'s bounds and the dry run
(``repro_torch.launch.dryrun``) both read, and the dry run's counter.

- flash attention: 4 hd flops (QK^T and PV) per unmasked (query, key)
  pair; q, k, v read once and the output written once;
- decode attention: 4 hd flops per query head and valid key; each valid
  key's K and V rows read once, q and length read, the output (and with
  the log-sum-exp entry, the f32 lse) written;
- the grouped GEMM (``block_diag_matmul``, ``moe_gmm``): 2 M K N flops per
  group; x and w read once, the output written once;
- its ragged entry (``moe_gmm_ragged``): 2 K N flops a kept row, the
  weights of the groups that have rows, the kept rows of x and every
  output row (on meta, where the offsets are unknown, the worst case).

On the meta device the kernels' wrappers add each call's work to
:data:`DRYRUN` (the plain versions' aten ops are what ``FlopCounterMode``
counts; the kernels' launches are not aten ops).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

#: the kernels' work traced on the meta device since :func:`reset_dryrun`
DRYRUN: Dict[str, float] = {"flops": 0.0, "bytes": 0.0}


def reset_dryrun() -> None:
    DRYRUN.update(flops=0.0, bytes=0.0)


def add_dryrun(cost: Tuple[float, float]) -> None:
    DRYRUN["flops"] += cost[0]
    DRYRUN["bytes"] += cost[1]


def flash_pairs(sq: int, sk: int, *, causal: bool, window: int) -> float:
    """Unmasked (query, key) pairs of one head: queries at positions
    sk - sq .. sk - 1, keys up to the query (``causal``) and after its
    window's start."""
    qpos = np.arange(sq) + sk - sq
    hi = np.minimum(qpos + 1, sk) if causal else np.full(sq, sk)
    lo = np.maximum(qpos - window + 1, 0) if window else np.zeros(sq)
    return float(np.maximum(hi - lo, 0).sum())


def flash_cost(n: int, sq: int, sk: int, h: int, kh: int, hd: int,
               itemsize: int, *, causal: bool,
               window: int) -> Tuple[float, float]:
    """(flops, bytes) of one flash forward on q [n, sq, h, hd] and k, v
    [n, sk, kh, hd]."""
    pairs = flash_pairs(sq, sk, causal=causal, window=window) * n * h
    nbytes = (2 * n * sq * h * hd + 2 * n * sk * kh * hd) * itemsize
    return 4.0 * hd * pairs, float(nbytes)


def decode_cost(b: int, h: int, kh: int, hd: int, keys: int, itemsize: int,
                *, return_lse: bool = False) -> Tuple[float, float]:
    """(flops, bytes) of one decode call on q [b, h, hd] over ``keys``
    valid slots in all (the sum of the lanes' lengths)."""
    out_item = 4 if return_lse else itemsize
    nbytes = 2 * keys * kh * hd * itemsize + b * h * hd * itemsize \
        + b * h * hd * out_item + b * 4 + (b * h * 4 if return_lse else 0)
    return 4.0 * h * hd * keys, float(nbytes)


def gemm_cost(g: int, m: int, k: int, n: int,
              itemsize: int) -> Tuple[float, float]:
    """(flops, bytes) of one grouped GEMM [g, m, k] @ [g, k, n]."""
    return 2.0 * g * m * k * n, float((g * m * k + g * k * n + g * m * n)
                                      * itemsize)


def ragged_gemm_cost(g: int, r: int, k: int, n: int,
                     itemsize: int) -> Tuple[float, float]:
    """(flops, bytes) of one ragged grouped GEMM (x [r, k], w [g, k, n])
    at its worst case, for the dry run, where the offsets are not known:
    every row multiplied, min(g, r) groups' weights read, x read and the
    output written once."""
    return 2.0 * r * k * n, float((min(g, r) * k * n + r * k + r * n)
                                  * itemsize)


def ragged_data_cost(offsets, r: int, k: int, n: int,
                     itemsize: int) -> Tuple[float, float]:
    """(flops, bytes) that one ragged call on host ``offsets`` needs: the
    kept rows (below offsets[-1]) multiplied, the weights of the groups
    with rows read once, the kept rows of x read and every output row
    written."""
    off = [min(max(int(o), 0), r) for o in offsets]
    kept = max(off[-1] - off[0], 0)
    used = sum(hi > lo for lo, hi in zip(off, off[1:]))
    return 2.0 * kept * k * n, float((used * k * n + kept * k + r * n)
                                     * itemsize)
