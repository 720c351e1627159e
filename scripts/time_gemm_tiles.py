"""Time the grouped GEMM (``repro_torch.kernels.moe_gmm``) at the MoE
dispatch buffer of qwen2-moe-a2.7b (60 experts, capacity 171 for one
2048-token sequence) with each tiled kernel's row count forced in turn.

    PYTHONPATH=src python scripts/time_gemm_tiles.py [--out tiles.json]

Needs one CUDA card.  For each projection (gate/up, down) and dtype it
times every tile row count the launcher knows above the skinny tile, in the
order a, b, b, a over several rounds (CUDA events, mean of 10 calls per
round), and prints each tile's median and its spread (max - min over
rounds), then one JSON line.  The card's name and power limit are printed
beside them.
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import statistics
import subprocess
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))


def _ms(fn, reps: int = 10) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import _gemm_launch as GL
    from repro_torch.kernels.moe_gmm import moe_gmm, moe_gmm_plain
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    cfg = get_config("qwen2-moe-a2.7b")
    m = cfg.moe
    cap = int(max(m.top_k, math.ceil(2048 * m.top_k * m.capacity_factor
                                     / m.n_experts)))
    tiles = sorted(t for t in GL.SLAB if t > GL.SKINNY_M)
    choose = GL.tile_rows
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    try:
        for proj, k, n in (("gate_up", cfg.d_model, m.d_ff),
                           ("down", m.d_ff, cfg.d_model)):
            for dt in (torch.float32, torch.bfloat16):
                x = torch.randn(m.n_experts, cap, k, generator=gen,
                                device=dev).to(dt)
                w = (torch.randn(m.n_experts, k, n, generator=gen,
                                 device=dev) / math.sqrt(k)).to(dt)
                want = moe_gmm_plain(x, w).float()
                times = {t: [] for t in tiles}
                for t in tiles:                      # warm-up and check
                    GL.tile_rows = lambda _m, t=t: t
                    got = moe_gmm(x, w).float()
                    err = float((got - want).abs().max())
                    assert err <= 2e-2 * (1 + float(want.abs().max())), err
                for r in range(args.rounds):
                    order = tiles if r % 2 == 0 else tiles[::-1]
                    for t in order + order[::-1]:
                        GL.tile_rows = lambda _m, t=t: t
                        times[t].append(_ms(lambda: moe_gmm(x, w)))
                GL.tile_rows = choose
                row = dict(proj=proj, dtype=str(dt)[6:], C=cap, K=k, N=n,
                           chosen=choose(cap),
                           ms={t: statistics.median(v)
                               for t, v in times.items()},
                           spread_ms={t: max(v) - min(v)
                                      for t, v in times.items()})
                rows.append(row)
                print(f"{proj} {row['dtype']} C {cap}: " + ", ".join(
                    f"tile {t}: {row['ms'][t]:.4f} ms (spread "
                    f"{row['spread_ms'][t]:.4f})" for t in tiles)
                    + f"; chosen {row['chosen']}", flush=True)
                del x, w, want
    finally:
        GL.tile_rows = choose
    result = dict(card=card, rows=rows)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(result, indent=1))
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
