"""Serve a (reduced) model through the placement engine on the PyTorch
port: the paper's MAB policy (UCB) driving ``TorchBackend``, whose arms
run the layer-split model and the semantic split's block-diagonal
branches.  On pure global-attention configs the backend runs the paged
continuous-batching decode path (``repro_torch.decode``): deadline-ordered
(EDF) in-flight joins with prefix-cache hits on the shared block pool,
chunked tail prefill and K-token decode dispatches; on recurrent mixers
the gang path.  Observed latencies feed the bandit.

    PYTHONPATH=src python examples/serve_splitplace_torch.py --arch stablelm-1.6b
    PYTHONPATH=src python examples/serve_splitplace_torch.py --device cpu
"""
import argparse

import numpy as np

from repro_torch.configs.base import get_config
from repro_torch.engine import (MABPolicy, PlacementEngine, Request,
                                TorchBackend)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--batches", type=int, default=8)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).reduced()
    policy = MABPolicy(bandit="ucb", seed=0, ema_init_values=None, n_ctx=8)
    backend = TorchBackend(cfg, cache_len=64, max_batch=args.max_batch,
                           device=args.device)
    eng = PlacementEngine(policy, backend)
    rng = np.random.default_rng(0)

    rid = 0
    for b in range(args.batches):
        reqs = []
        for _ in range(args.batch_size):
            tight = rng.random() < 0.5
            reqs.append(Request(
                rid=rid, app_id=int(rng.integers(3)),
                tokens=rng.integers(0, cfg.vocab_size, 8).astype(np.int32),
                sla_s=float(0.05 if tight else 5.0), max_new=4))
            rid += 1
        eng.submit(reqs)        # admit -> MAB decide -> per-arm EDF queues
        eng.drain()
        print(f"batch {b}: {[f'{r.rid}:{r.decision}' for r in reqs]}")
    s = eng.summary()
    print("summary:", s)
    if "join_waves" in s:                  # paged continuous-batching path
        assert s["prefill_chunks"] >= s["join_waves"], \
            "every join wave commits at least one prefill chunk"
        assert s["decoded_tokens"] >= s["decode_dispatches"], \
            "the K-token decode must amortize dispatches over tokens"
        assert s["used_blocks"] == 0, \
            "retired sequences must drop all their block references"
        print(f"paged decode: {s['join_waves']} join waves, "
              f"{s['prefill_chunks']} prefill chunks, "
              f"{s['decode_dispatches']} decode dispatches for "
              f"{s['decoded_tokens']} decoded tokens "
              f"(occupancy {s['batch_occupancy']}, "
              f"prefix hit rate {s['prefix_hit_rate']})")
    else:                                  # recurrent mixers: gang path
        print(f"legacy decode: {s['prefill_calls']} prefills, "
              f"{s['decode_steps']} decode steps over {s['batches']} batches")
    return s


if __name__ == "__main__":
    main()
