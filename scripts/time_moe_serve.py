"""Time the qwen2-moe serve of a tree's ``chip_smoke.py`` on the card.

    python scripts/time_moe_serve.py ROOT LABEL

Runs ``ROOT``'s ``chip_smoke.serve_phase`` (its own gates included) on
full-width qwen2-moe-a2.7b with int8 attention weights, 8 requests in 4
waves, twice in one process, and prints ``CMP LABEL`` and both runs'
decode ms a step, prefill ms a chunk, tokens/s, steps and chunks.  To
compare two commits on one card, unpack the other one into an ignored
directory (``git archive <commit> | tar -x -C build/parent``) and run
parent, change, change, parent in one chip call, each in its own
process: each tree builds and loads its own kernels.
"""
import json
import pathlib
import sys

import torch

root = pathlib.Path(sys.argv[1]).resolve()
sys.path.insert(0, str(root))
sys.path.insert(0, str(root / "src"))
import chip_smoke as CS  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

_build.build_all()
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda")
out = []
for _ in range(2):
    backend, r = CS.serve_phase(dev, get_config("qwen2-moe-a2.7b"),
                                kv_dtype="f32", weight_quant="int8",
                                n_requests=8, waves=4, max_new=(16, 33),
                                every_arm_first=True)
    del backend
    CS._free()
    out.append({k: r[k] for k in ("decode_ms_per_step", "prefill_ms_per_chunk",
                                  "tokens_per_s", "decode_steps",
                                  "prefill_chunks", "wall_s", "per_mode")})
print("CMP", sys.argv[2], json.dumps(out), flush=True)
