"""Serving launcher: the placement engine over a chosen architecture (MAB
policy + TorchBackend: EDF continuous batching on the paged path, or the
gang path for recurrent, local-window, enc-dec and VLM models).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-1.6b \
        --batches 8 --reduced
    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-125m \
        --bandit thompson

``--bandit`` is ucb, thompson or egreedy; ``--no-reduced`` serves the full
model; ``--device cpu`` runs the plain PyTorch path without a card.
``--mesh D,M`` shapes the arms' runners as the reference's mesh does (the
semantic arm serves max(2, M) branches); the backend serves on its one
device.
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch.configs.base import get_config
from repro_torch.core.mab import BANDITS
from repro_torch.engine import (MABPolicy, PlacementEngine, Request,
                                TorchBackend)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--mesh", default="1,1",
                    help="(data, model) shape of the arms' runners")
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=64)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--bandit", default="ucb", choices=sorted(BANDITS))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    eng = PlacementEngine(
        MABPolicy(bandit=args.bandit, ema_init_values=None, n_ctx=8),
        TorchBackend(cfg, mesh=args.mesh, cache_len=args.cache_len,
                     max_batch=args.max_batch, device=args.device))
    rng = np.random.default_rng(0)
    rid = 0
    for _ in range(args.batches):
        reqs = []
        for _ in range(args.batch_size):
            tight = rng.random() < 0.5
            reqs.append(Request(
                rid=rid, app_id=int(rng.integers(3)),
                tokens=rng.integers(0, cfg.vocab_size, 8).astype(np.int32),
                sla_s=float(0.05 if tight else 5.0), max_new=4))
            rid += 1
        eng.submit(reqs)
        eng.drain()
    summary = eng.summary()
    print(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main()
