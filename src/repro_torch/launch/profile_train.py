"""Where a training step of the PyTorch port spends its time on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_train \
        [--mode fsdp] [--steps 2] [--out trace.json]

Builds full-width stablelm-1.6b in f32 (B 2, S 2048, remat, as
``repro_torch.launch.train`` runs it), takes one warm-up step, then runs
``--steps`` steps under ``torch.profiler``.  Prints the host wall time per
step, the device busy time per step (sum of CUDA kernel time) and the idle
share, the device time per step of each part of the step (the flash
kernel; the chunked-attention backward; the chunked cross-entropy; the
AdamW update; everything else, which is the blocks' matmuls and
elementwise ops with their backward), the GEMM share, and the CUDA kernels
ranked by their own total time.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

#: the parts of a step, each a ``record_function`` range around one function
PARTS = ("chunked_attention_bwd", "cross_entropy", "adamw")


def _ranged(name, fn):
    def wrapped(*a, **k):
        with torch.profiler.record_function(name):
            return fn(*a, **k)
    return wrapped


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="fsdp", choices=["fsdp", "semantic"])
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--out", default=None, help="Chrome trace path")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_train: no CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import batches_for
    from repro_torch.dist import api as A
    from repro_torch.models import attention as MA
    from repro_torch.models import model as MM
    from repro_torch.optim.adamw import adamw_init

    torch.backends.cuda.matmul.allow_tf32 = False
    MA.chunked_attention = _ranged("chunked_attention_bwd",
                                   MA.chunked_attention)
    MM._chunked_ce = _ranged("cross_entropy", MM._chunked_ce)
    A.adamw_update = _ranged("adamw", A.adamw_update)

    cfg = get_config("stablelm-1.6b").replace(dtype="float32")
    runner = A.build_runner(cfg, args.mode, device="cuda")
    params = runner.init(seed=0)
    opt = adamw_init(params)
    step = A.make_train_step(runner, lr=3e-4, remat=True)
    data = batches_for(runner.cfg, seq_len=2048, global_batch=2)

    def one():
        nonlocal params, opt
        batch = {k: torch.from_numpy(v).cuda() for k, v in next(data).items()}
        params, opt, loss = step(params, opt, batch)
        return float(loss)

    one()                                   # warm-up step
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            one()                           # ends in a host read: synced
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    # kernels only: a record_function range also shows up on the device
    # timeline, as a user annotation spanning its kernels
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation]
    dev_us = sum(e.self_device_time_total for e in kernels)
    n = args.steps
    per = lambda us: us / 1e3 / n
    gemm_us = sum(e.self_device_time_total for e in kernels
                  if "gemm" in e.key.lower() or "cutlass" in e.key.lower())
    flash_us = sum(e.self_device_time_total for e in kernels
                   if "flash_attention_kernel" in e.key)
    # a part's device time: its range's span on the device timeline
    spans = {e.key: e.self_device_time_total for e in events
             if e.is_user_annotation
             and e.device_type == torch.autograd.DeviceType.CUDA}
    parts = {p: spans[p] for p in PARTS if p in spans}
    print(f"{args.mode}: {n} steps of B 2 x S 2048, f32, remat; "
          f"{torch.cuda.get_device_name(0)}")
    print(f"host wall per step: {1e3 * wall / n:.3f} ms")
    print(f"device busy per step: {per(dev_us):.3f} ms (idle share "
          f"{1 - dev_us / 1e6 / wall:.4f}; "
          f"{sum(e.count for e in kernels) / n:.0f} CUDA kernels per step)")
    print(f"  flash_attention kernel: {per(flash_us):.3f} ms")
    for p, us in parts.items():
        print(f"  {p}: {per(us):.3f} ms")
    rest = dev_us - flash_us - sum(parts.values())
    print(f"  the rest (blocks' matmuls and elementwise, fwd + bwd): "
          f"{per(rest):.3f} ms")
    print(f"  GEMM kernels (all parts): {per(gemm_us):.3f} ms")
    print(events.table(sort_by="self_device_time_total", row_limit=20))
    if args.out:
        prof.export_chrome_trace(args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
