"""Where a decode step of the PyTorch port spends its time on the card.

    python3 scripts/profile_torch_serve.py [--arch stablelm-1.6b]
        [--steps 16] [--arm 0|1] [--weight-quant none|int8|int4]
        [--kv bf16|int8] [--out trace.json]

Builds a full-width model (``--arch``: stablelm-1.6b by default, or
qwen2-moe-a2.7b; bf16) on one arm, its attention projections in bf16 or
quantized (``--weight-quant``, served through ``quant_matmul``) and its KV
pool in bf16 or int8 (``--kv``), seats 8 lanes with 512-token prompts,
times ``--steps`` single-token decode dispatches unprofiled, then runs as
many under ``torch.profiler``: prints the host wall time per step (both),
the device busy time per step (sum of CUDA kernel time), the CUDA kernels
per step, and the CUDA kernels and host ops ranked by their own total
time.  Needs a CUDA device.  A copy placed in an unpacked parent tree
(``git archive``) profiles that tree's code on the same card.
"""
from __future__ import annotations

import argparse
import heapq
import pathlib
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--arm", type=int, default=0, help="0 layer, 1 semantic")
    ap.add_argument("--weight-quant", default="none",
                    choices=("none", "int8", "int4"))
    ap.add_argument("--kv", default="bf16", choices=("bf16", "int8"),
                    help="KV pool: the model's dtype (bf16) or int8")
    ap.add_argument("--out", default=None, help="Chrome trace path")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch_serve: no CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import get_config
    from repro_torch.engine import Request, TorchBackend

    cfg = get_config(args.arch)
    wq = None if args.weight_quant == "none" else args.weight_quant
    tb = TorchBackend(cfg, cache_len=1024, max_batch=8, block_size=16,
                      prefill_chunk=128, scan_tokens=1, arms=(args.arm,),
                      kv_dtype="int8" if args.kv == "int8" else "f32",
                      weight_quant=wq)
    sched = tb._paged[args.arm]
    rng = np.random.default_rng(0)
    q = []
    for rid in range(8):
        req = Request(rid=rid, app_id=0, sla_s=60.0,
                      max_new=2 * args.steps + 8,
                      arrival_s=0.0, tokens=rng.integers(
                          0, cfg.vocab_size, 512).astype(np.int32))
        heapq.heappush(q, (60.0, rid, 0.0, req))
    sched.try_join(q, 0.0)
    while sched.prefill_left.max() > 0:
        sched.prefill_step(0.0)
    for _ in range(3):                      # warm-up dispatches
        sched.dispatch(0.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        sched.dispatch(0.0)
    bare = time.perf_counter() - t0

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            sched.dispatch(0.0)             # ends in a host read: synced
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    dev_us = sum(e.self_device_time_total for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    n_kernels = sum(e.count for e in events
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    print(f"{args.arch} arm {args.arm}, weights {args.weight_quant}, kv "
          f"{args.kv}: {args.steps} decode steps, 8 lanes at "
          f"~{512 + 3 + args.steps * 3 // 2} tokens")
    print(f"host wall per step: {1e3 * wall / args.steps:.3f} ms "
          f"(unprofiled: {1e3 * bare / args.steps:.3f} ms)")
    print(f"device busy per step: {dev_us / 1e3 / args.steps:.3f} ms "
          f"({n_kernels / args.steps:.0f} CUDA kernels per step)")
    print(events.table(sort_by="self_device_time_total", row_limit=15))
    print(events.table(sort_by="self_cpu_time_total", row_limit=15))
    if args.out:
        prof.export_chrome_trace(args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
