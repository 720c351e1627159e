"""Rehearse ``chip_smoke.py``'s ``fleet`` phase on the CPU.

    PYTHONPATH=src python scripts/rehearse_fleet_cpu.py

Runs ``chip_smoke.fleet_phase`` on a tiny stablelm-1.6b (d 64, 2 heads,
vocab 128, f32) with the phase's own trace, pools and gates.  The CUDA
calls the phase makes (synchronize, peak-memory stats) become no-ops, and
each call of a paged kernel's plain version counts as the launch its CUDA
wrapper would count, on the path the card would take, so the launch gates
run too.  Routing does not read the weights: the hit rates and routes it
prints are the ones the card's run must give.  No time it prints is a
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
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels import _paged_launch as PL  # noqa: E402
from repro_torch.kernels import paged_decode_attention as PD  # noqa: E402
from repro_torch.kernels import paged_prefill_attention as PP  # noqa: E402


def _count_plain(mod, plain_name, wrapper, path, top_dim):
    """Count a call of ``mod.<plain_name>`` as one launch of ``wrapper``
    when q has the wrapper's leading dims (the plain version recurses over
    a branch dim)."""
    plain = getattr(mod, plain_name)

    def counted(q, *a, **kw):
        if q.dim() == top_dim:
            wrapper.launches += 1
            PL.PATH_LAUNCHES[path] += 1
        return plain(q, *a, **kw)
    setattr(mod, plain_name, counted)


def main() -> int:
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        setattr(torch.cuda, name, lambda *a, **k: None)
    torch.cuda.max_memory_allocated = lambda *a, **k: 0
    _count_plain(PP, "paged_prefill_attention_plain",
                 PP.paged_prefill_attention, "prefill_mma", 5)
    _count_plain(PD, "paged_decode_attention_plain",
                 PD.paged_decode_attention, "decode_split", 4)
    cfg = get_config("stablelm-1.6b").reduced().replace(
        d_model=64, n_heads=2, n_kv_heads=2, head_dim=32, d_ff=128,
        vocab_size=128, dtype="float32")
    out = CS.fleet_phase(torch.device("cpu"), cfg)
    print(json.dumps({
        "launches": out["launches"], "paths": out["paths"],
        **{f"{name}_{p}": {k: out[name][p][k] for k in (
            "prefix_hit_rate", "routed_per_replica", "prefill_chunks")}
           for name in ("routed", "random") for p in ("warm", "measured")}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
