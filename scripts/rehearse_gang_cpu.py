"""Rehearse ``chip_smoke.py``'s gang-path phases (``legacy``,
``recurrent``, ``window``) and its ``zoo`` phase on the CPU.

    PYTHONPATH=src python scripts/rehearse_gang_cpu.py

Runs the phases' own functions on ``reduced()`` configs (stablelm-1.6b,
xlstm-125m, gemma2-27b; the zoo's whisper-base, internvl2-26b, jamba and
xlstm mixers) with their gates.  The CUDA calls the phases make
(synchronize, peak-memory stats) become no-ops, and each call of
``decode_attention``'s or ``block_diag_matmul``'s plain version counts as
the launch its CUDA wrapper would count (the grouped GEMM on the path the
card would take), so the launch gates run too.  No time it prints is a
device time.
"""
from __future__ import annotations

import json
import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as CS  # noqa: E402
from repro_torch.configs import base as CB  # noqa: E402
from repro_torch.kernels import _gemm_launch as GL  # noqa: E402
from repro_torch.kernels import block_diag_matmul as BDM  # noqa: E402
from repro_torch.kernels import decode_attention as DEC  # noqa: E402


def _count_plain():
    """Count each plain-version call as its wrapper's launch."""
    dec_plain, bdm_plain = DEC.decode_attention_plain, \
        BDM.block_diag_matmul_plain

    def dec(q, *a, **kw):
        DEC.decode_attention.launches += 1
        return dec_plain(q, *a, **kw)

    def bdm(x, w):
        BDM.block_diag_matmul.launches += 1
        GL.PATH_LAUNCHES[GL.path_for(x, w)] += 1
        return bdm_plain(x, w)
    DEC.decode_attention_plain = dec
    BDM.block_diag_matmul_plain = bdm


def main() -> int:
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        setattr(torch.cuda, name, lambda *a, **k: None)
    torch.cuda.max_memory_allocated = lambda *a, **k: 0
    _count_plain()
    get = CB.get_config
    CB.get_config = lambda name: get(name).reduced()
    dev = torch.device("cpu")
    out = {}
    stablelm = get("stablelm-1.6b").reduced()
    out["legacy"] = CS.gang_and_check(
        dev, stablelm, tag="legacy", decode="legacy", bandit="ucb", waves=3,
        reqs=CS.gang_requests(stablelm.vocab_size, 9, seed=2, plen=(8, 33),
                              max_new=(4, 9)))
    xlstm = get("xlstm-125m").reduced()
    out["recurrent"] = CS.gang_and_check(
        dev, xlstm, tag="recurrent", decode="auto", bandit="thompson",
        waves=3, reqs=CS.gang_requests(xlstm.vocab_size, 9, seed=3,
                                       plen=(4, 9), max_new=(4, 9)))
    gemma2 = get("gemma2-27b").reduced()
    out["window"] = CS.gang_and_check(
        dev, gemma2, tag="window", decode="auto", bandit="egreedy", waves=3,
        reqs=CS.gang_requests(gemma2.vocab_size, 6, seed=4, plen=(8, 17),
                              max_new=(8, 17)))
    out["ring_kernel"] = CS.window_kernel_check(dev, gemma2)
    out["zoo"] = CS.zoo_phase(dev)
    print(json.dumps({k: v if k in ("ring_kernel", "zoo") else {
        "launches": v[0]["launches"], "decode_steps": v[0]["decode_steps"],
        "bdm_paths": v[0]["bdm_paths"], "models": v[1]}
        for k, v in out.items()}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
