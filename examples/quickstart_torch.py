"""Quickstart on the PyTorch port: the paper's pieces in 60 lines.

1. Build an assigned architecture (reduced) and run a forward pass.
2. Construct its layer-split and semantic-split plans.
3. Let the MAB decision engine pick a split per SLA deadline.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.core.decision import SplitDecisionEngine
from repro_torch.core.splitter import fragments_for, mode_for_decision
from repro_torch.models.model import build_model

ap = argparse.ArgumentParser()
ap.add_argument("--device", default="cuda")
dev = torch.device(ap.parse_args().device)

# -- 1. a model from the assigned pool -------------------------------------
cfg = get_config("gemma2-27b").reduced()
model = build_model(cfg, device=dev)
model.reset_parameters(torch.Generator(device=dev).manual_seed(0))
tokens = torch.zeros(2, 32, dtype=torch.int32, device=dev)
with torch.no_grad():
    logits, _ = model.forward(model.param_tree(), {"tokens": tokens})
print(f"gemma2 (reduced) on {dev}: logits {tuple(logits.shape)}, "
      f"params {cfg.param_count()/1e6:.1f}M")

# -- 2. the two split plans (paper §III-A) ----------------------------------
full = get_config("gemma2-27b")
layer = fragments_for(full, decision=0, n=4)
sem = fragments_for(full, decision=1, n=4)
print(f"layer split : {len(layer)} sequential fragments, "
      f"{sum(f.param_bytes for f in layer)/1e9:.1f} GB total")
print(f"semantic    : {len(sem)} parallel branches,   "
      f"{sum(f.param_bytes for f in sem)/1e9:.1f} GB total "
      f"(SplitNet parameter reduction)")

# -- 3. the MAB decision engine (paper §III-B, Fig. 2) ----------------------
eng = SplitDecisionEngine(n_apps=1, bandit="ucb", c=0.3, ema_init_values=[2.0])
state = eng.init(1)
rng = np.random.default_rng(0)
for i in range(300):                       # online learning on a workload mix
    sla = float(rng.choice([0.9, 4.0]))
    arm, ctx, state = eng.decide(state, 0, sla)
    rt = 2.0 if int(arm) == 0 else 0.7     # layer slower, more accurate
    acc = 0.93 if int(arm) == 0 else 0.89
    state = eng.observe(state, 0, ctx, int(arm), rt, sla, acc)

for sla in (0.9, 4.0):
    arm, _, state = eng.decide(state, 0, sla)
    print(f"SLA {sla:.1f}s -> {mode_for_decision(int(arm))} "
          f"({'semantic' if int(arm) else 'layer'} split)")
