"""Host and device time of one MoE layer's serving call on the card.

    python3 scripts/time_moe_layer.py [--tokens 8,1024] [--reps 200]

One full-width qwen2-moe-a2.7b MoE FFN (seeded random bf16 weights, 60
experts, top 4, the shared expert) through ``models.moe.moe_apply`` under
``torch.no_grad()`` at each token count: the host's enqueue time a call
(``--reps`` calls back to back, then one synchronize: the host wall of the
calls alone, as a host-bound serve sees them), the device time a call
(CUDA events around the same calls), the CUDA kernels a call, and the host
ops ranked by their own CPU time under ``torch.profiler``.  Run a copy in
an unpacked parent tree (``git archive``) to time that tree's path on the
same card.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import math
import pathlib
import sys
import time

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tokens", default="8,1024")
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_moe_layer: no CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import get_config
    from repro_torch.models import moe as MOE
    cfg = get_config("qwen2-moe-a2.7b")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(37)

    def draw(tree):
        return {k: draw(v) if isinstance(v, dict) else (
            torch.randn((1,) + tuple(v), generator=gen, device=dev)
            / math.sqrt(v[-2])).bfloat16() for k, v in tree.items()}
    params = draw(MOE.moe_shapes(cfg))
    for t in (int(v) for v in args.tokens.split(",")):
        x = torch.randn(1, t, cfg.d_model, generator=gen,
                        device=dev).bfloat16()
        call = lambda: MOE.moe_apply(params, x, cfg)
        with torch.no_grad():
            for _ in range(10):
                call()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            for _ in range(args.reps):
                call()
            host = time.perf_counter() - t0
            end.record()
            end.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(20):
                    call()
                torch.cuda.synchronize()
        events = prof.key_averages()
        kernels = sum(e.count for e in events if e.device_type
                      == torch.autograd.DeviceType.CUDA) / 20
        print(f"T {t}: host enqueue {1e6 * host / args.reps:.1f} us a call, "
              f"events {1e3 * start.elapsed_time(end) / args.reps:.1f} us "
              f"a call, {kernels:.0f} CUDA kernels a call")
        print(events.table(sort_by="self_cpu_time_total", row_limit=12))
    return 0


if __name__ == "__main__":
    sys.exit(main())
