"""Rehearse ``chip_smoke.py``'s ``pipeline`` and ``placement`` phases on
the CPU.

    PYTHONPATH=src python scripts/rehearse_pipeline_cpu.py

Runs the phases' own functions with their gates: the pipeline phase on
stablelm-1.6b ``reduced()`` (2 layers, d 256) at the train phase's shape
(B 2 x S 2048, so every attention layer takes the flash path), the
placement phase as on the card with its networks on the CPU.  The CUDA
calls the phases make (synchronize, peak-memory stats) become no-ops, and
each call of the flash forward's plain version counts as the launch its
CUDA wrapper would count (on ``simt``, the f32 path), so the launch gates
run too.  The placement phase's card-against-CPU episode check compares
the CPU with itself here.  No time it prints is a device time.
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
from repro_torch.kernels import _flash_launch as FL  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.launch import train as TR  # noqa: E402
from repro_torch.models import attention as MA  # noqa: E402


def main() -> int:
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        setattr(torch.cuda, name, lambda *a, **k: None)
    torch.cuda.max_memory_allocated = lambda *a, **k: 0
    plain = FA.flash_attention_plain

    def counted(q, k, v, **kw):
        FA.flash_attention.launches += 1
        FL.PATH_LAUNCHES["simt"] += 1
        return plain(q, k, v, **kw)
    MA.flash_attention = counted
    main_ = TR.main
    TR.main = lambda argv, **kw: main_(
        [a.removesuffix("-smoke") for a in argv]
        + ["--reduced", "--device", "cpu"], **kw)
    dev = torch.device("cpu")
    stablelm = get_config("stablelm-1.6b").reduced()
    out = {"pipeline": CS.pipeline_phase(dev, stablelm),
           "placement": CS.placement_phase(dev)}
    print(json.dumps(out, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
