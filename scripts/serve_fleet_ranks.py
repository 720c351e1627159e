"""A routed ``FleetBackend`` across the ranks of a process-group mesh.

    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 2 \
        scripts/serve_fleet_ranks.py --mesh 1,2 --device cpu
    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 2 \
        scripts/serve_fleet_ranks.py --mesh 1,2 --device cpu \
        --fleet-devices 1,0

Every rank builds the same fleet of ``--replicas`` replicas of the
reduced stablelm-1.6b, the LAYER arm only, on a ``(data, model)`` mesh
laid over the ranks (``--backend`` gloo, or nccl with a card a rank; on
the card drop ``--device cpu``).  Rank 0 routes each request under
``PrefixAwareRouter``, runs every replica's engine and relays each
replica's device calls; the other ranks follow.  With ``--fleet-devices``
each replica serves disaggregated (``fleet="disagg"``), its prefill and
decode workers pinned whole to the two ranks named (ranks of the world,
each standing for its device), the KV ship crossing between them.  Rank 0
prints the engine's summary.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import get_config
from repro_torch.engine import (LAYER, FixedPolicy, FleetBackend,
                                PlacementEngine, PrefixAwareRouter, Request)
from repro_torch.launch.mesh import init_mesh


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="1,2")
    ap.add_argument("--backend", default="gloo", choices=["gloo", "nccl"])
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--fleet-devices", default=None,
                    help="comma-separated ranks: (prefill, decode) pairs")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = args.device
    if device == "cuda":
        local = int(os.environ.get("LOCAL_RANK", "0"))
        device = f"cuda:{local % torch.cuda.device_count()}"
        torch.cuda.set_device(device)
    dims = tuple(int(x) for x in args.mesh.split(","))
    mesh = init_mesh(dims, backend=args.backend, device=device)
    kw = dict(arms=(LAYER,), cache_len=64, max_batch=4, decode="paged",
              block_size=8)
    if args.fleet_devices:
        kw.update(fleet="disagg", fleet_devices=tuple(
            int(r) for r in args.fleet_devices.split(",")))
    fleet = FleetBackend(get_config("stablelm-1.6b").reduced(), mesh=mesh,
                         n_replicas=args.replicas, device=device, **kw)
    if mesh.rank > 0:
        fleet.follow()
        return 0
    try:
        rng = np.random.default_rng(0)
        vocab = fleet.replicas[0].cfg.vocab_size
        heads = rng.integers(0, vocab, (3, 24)).astype(np.int32)
        eng = PlacementEngine(FixedPolicy(
            LAYER, placement=PrefixAwareRouter(fleet.board)), fleet)
        reqs = [Request(rid=i, app_id=i % 3, sla_s=5.0, max_new=4,
                        tokens=np.concatenate([heads[i % 3], rng.integers(
                            0, vocab, 4).astype(np.int32)]))
                for i in range(args.requests)]
        half = len(reqs) // 2        # the second half finds cached heads
        for wave in (reqs[:half], reqs[half:]):
            eng.submit(wave)
            eng.drain()
    finally:
        fleet.close()
    print(json.dumps({k: v for k, v in eng.summary().items()
                      if not isinstance(v, dict)}, indent=2))
    return 0


if __name__ == "__main__":
    rc = main()
    dist.destroy_process_group()
    sys.exit(rc)
