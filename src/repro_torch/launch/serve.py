"""Serving launcher: the placement engine over a chosen architecture (MAB
policy + TorchBackend: EDF continuous batching on the paged path, or the
gang path for recurrent, local-window, enc-dec and VLM models).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-1.6b \
        --batches 8 --reduced
    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-125m \
        --bandit thompson

    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 2 \
        -m repro_torch.launch.serve --mesh 2,1 --device cpu \
        --backend gloo --batches 2

``--bandit`` is ucb, thompson or egreedy; ``--no-reduced`` serves the full
model; ``--device cpu`` runs the plain PyTorch path without a card.

In one process, ``--mesh D,M`` shapes the arms' runners as the reference's
mesh does (the semantic arm serves max(2, M) branches); the backend serves
on its one device.  Under ``torch.distributed.run`` with D x M ranks it
lays a ``(data, model)`` mesh over them on ``--backend`` (gloo, or nccl
with a card per rank; each rank on card ``LOCAL_RANK`` modulo the card
count), as ``launch/train.py`` does, and the backend serves across the
ranks: rank 0 runs the engine and alone prints the summary, the other ranks
follow its calls.  Either way the backend serves ``decode="auto"``, as the
reference's launcher does: the paged path where it applies (pure global
attention: each rank holds its stages' or branches' slice of the paged
pool), the gang path for recurrent, local-window, enc-dec and VLM models.

    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 2 \
        -m repro_torch.launch.serve --mesh 1,2 --device cpu --backend gloo
"""
from __future__ import annotations

import argparse
import json
import math
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import get_config
from repro_torch.core.mab import BANDITS
from repro_torch.engine import (MABPolicy, PlacementEngine, Request,
                                TorchBackend)
from repro_torch.launch.mesh import init_mesh


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--mesh", default="1,1",
                    help="(data, model) shape of the arms' runners (more "
                         "than one rank: run under torch.distributed.run)")
    ap.add_argument("--backend", default="gloo", choices=["gloo", "nccl"],
                    help="process-group backend of a mesh of several ranks")
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
    dims = tuple(int(x) for x in args.mesh.split(","))
    mesh, device = args.mesh, args.device
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        if device == "cuda":
            local = int(os.environ.get("LOCAL_RANK", "0"))
            device = f"cuda:{local % torch.cuda.device_count()}"
            torch.cuda.set_device(device)
        mesh = init_mesh(dims, backend=args.backend, device=device)
    across = math.prod(dims) > 1 and dist.is_initialized()
    backend = TorchBackend(
        cfg, mesh=mesh, cache_len=args.cache_len, max_batch=args.max_batch,
        decode="auto", device=device)
    if across and dist.get_rank() > 0:
        return backend.follow()
    try:
        summary = _serve(args, cfg, backend)
    finally:
        backend.close()
    print(json.dumps(summary, indent=2))
    return summary


def _serve(args, cfg, backend) -> dict:
    """The request waves through the MAB-routed engine; its summary."""
    eng = PlacementEngine(
        MABPolicy(bandit=args.bandit, ema_init_values=None, n_ctx=8),
        backend)
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
    return eng.summary()


if __name__ == "__main__":
    main()
    if dist.is_initialized():
        dist.destroy_process_group()
