"""Rehearse ``chip_smoke.py``'s ``multi`` phase on the CPU.

    PYTHONPATH=src python scripts/rehearse_multi_cpu.py

Runs the phase's own code with its gates: two ranks of ``chip_smoke.py``
(``--multi-rank``) in a gloo world on the CPU, on stablelm-1.6b and
qwen2-moe-a2.7b ``reduced()`` at the train phase's shape (B 2 x S 2048, so
every attention layer takes the flash path): fsdp on (2, 1), 1f1b and
gpipe on (1, 2), expert parallel on (1, 2), each rank's first step held to
a one-process run, its parameter bytes to the specs' arithmetic and its
flash launches to the count the phase wants (each call of the flash
forward's plain version counts as the launch its CUDA wrapper would make).
Then the phase's ``serve_multi`` part on the same two ranks at reduced
depth, after this process has run the one-process references: flash-
decoding on (2, 1) (stablelm ``reduced()``, a 512-slot cache, a 250-token
prompt and 16 steps across the slab boundary; gemma2 ``reduced()``, a
64-slot cache seeded to position 48 with its 16-slot rings wrapped, 16
steps) and the LAYER (stage layout) and SEMANTIC arms on (1, 2) (B 8,
16-32-token prompts, 8 steps), with the same gates (each plain
``decode_attention`` call counts as a launch).  No time it prints is a
device time, and no collective it counts is staged.
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


def main() -> int:
    out = CS.multi_phase(torch.device("cpu"), reduced=True)
    print(json.dumps({"multi": out}, default=str)[:4000])
    return 0


if __name__ == "__main__":
    sys.exit(main())
