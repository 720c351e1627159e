"""Time the grouped GEMM (``repro_torch.kernels``: ``block_diag_matmul`` and
``moe_gmm``) at the op layer's main shapes with each path and tile forced
in turn, so the dispatch rule of ``_gemm_launch`` rests on a measurement.

    PYTHONPATH=src python scripts/time_gemm_tiles.py [--out tiles.json]

Needs one CUDA card.  Shapes: the semantic branch MLP up-projection of
stablelm-1.6b ``.semantic(2)`` at T 2048 and T 200 (2 x [T, 1024] @
[1024, 2816]) and the MoE dispatch buffer of qwen2-moe-a2.7b (60 experts,
capacity 171 for one 2048-token sequence) through gate/up and down.  In
bf16 it forces the tensor-core tile with 1, 2 and 3 consumer warpgroups
(64-192 rows) and the CUDA-core tile with 64 and 128 rows; in f32 the two
CUDA-core tiles.  Each variant is first checked against the plain version
(tol (1 + |plain|): 2e-2 bf16, 2e-4 f32), then timed in the order a, b,
..., ..., b, a over several rounds (device time per call from
``torch.profiler`` over 10 calls, ``chip_smoke.device_ms``: the wrapper's
host work, longer than the T 200 kernels, is left out); its median, its
spread (max - min over rounds) and the variant the launcher picks are
printed, then one JSON line.  The card's name and power limit are printed
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

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from chip_smoke import device_ms  # noqa: E402

TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}


def shapes():
    """(label, op, G, M, K, N) at the op layer's main shapes."""
    from repro_torch.configs.base import get_config
    sem = get_config("stablelm-1.6b").semantic(2)
    out = [(f"bdm up T{t}", "block_diag_matmul", 2, t, sem.d_model,
            sem.d_ff) for t in (2048, 200)]
    cfg = get_config("qwen2-moe-a2.7b")
    m = cfg.moe
    cap = int(max(m.top_k, math.ceil(2048 * m.top_k * m.capacity_factor
                                     / m.n_experts)))
    out += [(f"moe gate_up C{cap}", "moe_gmm", m.n_experts, cap,
             cfg.d_model, m.d_ff),
            (f"moe down C{cap}", "moe_gmm", m.n_experts, cap, m.d_ff,
             cfg.d_model)]
    return out


def variants(dt):
    """(name, path, rows per CTA) to force for ``dt``."""
    tiled = [(f"tiled/{r}", "tiled", r) for r in (64, 128)]
    if dt == torch.float32:
        return tiled
    return [(f"wgmma/{64 * c}", "wgmma", c) for c in (1, 2, 3)] + tiled


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    import importlib

    from repro_torch.kernels import _gemm_launch as GL
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    saved = GL.path_for, GL.tile_rows, GL.wgmma_consumers
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []

    def force(path, r):
        GL.path_for = lambda x, w: path
        if path == "wgmma":
            GL.wgmma_consumers = lambda m: r
        else:
            GL.tile_rows = lambda m: r
        GL._PLANS.clear()             # plans are cached by argument key

    try:
        for label, op, g, m, k, n in shapes():
            kern = getattr(importlib.import_module(
                f"repro_torch.kernels.{op}"), op)
            plain = getattr(importlib.import_module(
                f"repro_torch.kernels.{op}"), f"{op}_plain")
            for dt in (torch.float32, torch.bfloat16):
                x = torch.randn(g, m, k, generator=gen, device=dev).to(dt)
                w = (torch.randn(g, k, n, generator=gen, device=dev)
                     / math.sqrt(k)).to(dt)
                want = plain(x, w).float()
                path = saved[0](x, w)
                chosen = (f"wgmma/{64 * saved[2](m)}" if path == "wgmma"
                          else f"{path}/{saved[1](m)}")
                names = variants(dt)
                for name, p, r in names:             # warm-up and check
                    force(p, r)
                    got = kern(x, w).float()
                    ok = bool(((got - want).abs()
                               <= TOL[dt] * (1 + want.abs())).all())
                    assert ok, (label, name, float((got - want).abs().max()))
                times = {name: [] for name, _, _ in names}
                for rnd in range(args.rounds):
                    order = names if rnd % 2 == 0 else names[::-1]
                    for name, p, r in order + order[::-1]:
                        force(p, r)
                        times[name].append(device_ms(lambda: kern(x, w),
                                                     reps=10))
                GL.path_for, GL.tile_rows, GL.wgmma_consumers = saved
                GL._PLANS.clear()
                row = dict(shape=label, dtype=str(dt)[6:], G=g, M=m, K=k,
                           N=n, chosen=chosen,
                           ms={v: statistics.median(t)
                               for v, t in times.items()},
                           spread_ms={v: max(t) - min(t)
                                      for v, t in times.items()})
                rows.append(row)
                print(f"{label} {row['dtype']}: " + ", ".join(
                    f"{v} {row['ms'][v]:.4f} ms (spread "
                    f"{row['spread_ms'][v]:.4f})" for v in times)
                    + f"; chosen {chosen}", flush=True)
                del x, w, want
    finally:
        GL.path_for, GL.tile_rows, GL.wgmma_consumers = saved
        GL._PLANS.clear()
    result = dict(card=card, rows=rows)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(result, indent=1))
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
