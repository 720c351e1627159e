"""Time the grouped GEMM's decode-sized calls (``block_diag_matmul`` at M <=
32) on one CUDA card, so the decode tile's design and plan rest on a
measurement.

    PYTHONPATH=src python scripts/time_skinny_gemm.py [--src DIR] [--plans]
        [--out FILE]

Cases: the mLSTM q/k/v projection of xlstm-125m on the gang path (4 heads
of 384, T 8: 4 x [8, 384] @ [384, 384]) and the semantic branch MLP of
stablelm-1.6b ``.semantic(2)`` at T 8 (up 2 x [8, 1024] @ [1024, 2816],
down 2 x [8, 2816] @ [2816, 1024]), in f32 and bf16.  Each is first
checked against the plain version (tol (1 + |plain|): 2e-2 bf16, 2e-4
f32), then read as: device ms per call and CUDA kernels per call
(``chip_smoke.device_profile``), call ms (CUDA events over back-to-back
calls, the wrapper's host work included: ``chip_smoke.time_ms``),
``torch.bmm``'s device ms on the same inputs, and the bound (each input
read once and the output written once over 3.35 TB/s, against the flops
over the dtype's peak).

``--src DIR`` imports ``repro_torch`` from another tree (an unpacked
parent commit, say), so that two trees are compared on one card in one
call.  ``--plans`` (this tree only) forces the decode tile's plan in turn:
``SKINNY_CTAS_PER_SM`` 1 and 4 and the column width (64 and 128, and 32
on the CUDA-core tile); each
variant checked, then timed in the order a, b, ..., ..., b, a over several
rounds; medians, spreads (max - min over rounds) and the plan the launcher
picks.  The card's name and power limit are
printed; the last line is one JSON object.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import (_bound, device_ms, device_profile,  # noqa: E402
                        gpu_name_and_limit, time_ms)

TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}


def shapes():
    """(label, G, M, K, N) of the decode-sized main-path calls."""
    from repro_torch.configs.base import get_config
    xl = get_config("xlstm-125m")
    hd = xl.ssm_expand * xl.d_model // xl.n_heads
    sem = get_config("stablelm-1.6b").semantic(2)
    return [("mlstm/T8", xl.n_heads, 8, hd, hd),
            ("up/T8", 2, 8, sem.d_model, sem.d_ff),
            ("down/T8", 2, 8, sem.d_ff, sem.d_model)]


def inputs(g, m, k, n, dt, gen, dev):
    x = torch.randn(g, m, k, generator=gen, device=dev).to(dt)
    w = (torch.randn(g, k, n, generator=gen, device=dev) / k ** 0.5).to(dt)
    return x, w


def check(kern, plain, x, w, dt, tag):
    got, want = kern(x, w).float(), plain(x, w).float()
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not bool(((got - want).abs() <= TOL[dt] * (1 + want.abs())).all()):
        raise AssertionError(f"{tag}: max |kernel - plain| {err}")
    return err


def read_cases(dev):
    """Every case read once in this tree (``--src`` picks the tree)."""
    from repro_torch.kernels.block_diag_matmul import (
        block_diag_matmul, block_diag_matmul_plain)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for label, g, m, k, n in shapes():
        for dt in (torch.float32, torch.bfloat16):
            x, w = inputs(g, m, k, n, dt, gen, dev)
            tag = f"{label}/{str(dt)[6:]}"
            err = check(block_diag_matmul, block_diag_matmul_plain, x, w,
                        dt, tag)
            size = x.element_size()
            bnd, by = _bound((g * m * k + g * k * n + g * m * n) * size,
                             2.0 * g * m * k * n, dt)
            ms, per_call = device_profile(lambda: block_diag_matmul(x, w))
            row = dict(case=tag, G=g, M=m, K=k, N=n, max_abs_err=err, ms=ms,
                       kernels_per_call=per_call,
                       call_ms=time_ms(lambda: block_diag_matmul(x, w),
                                       reps=50),
                       bmm_ms=device_ms(lambda: torch.bmm(x, w)),
                       bound_ms=bnd, bound_by=by)
            rows.append(row)
            print(f"{tag}: {ms:.4f} ms ({per_call} kernel(s) per call), "
                  f"call {row['call_ms']:.4f} ms, torch.bmm "
                  f"{row['bmm_ms']:.4f} ms, bound {bnd:.4f} ms ({by}), "
                  f"max_abs_err {err:.3g}", flush=True)
    return rows


def read_plans(dev, rounds):
    """Each decode-tile plan forced in turn (this tree's launcher)."""
    from repro_torch.kernels import _gemm_launch as GL
    from repro_torch.kernels.block_diag_matmul import (
        block_diag_matmul, block_diag_matmul_plain)
    saved = GL.SKINNY_CTAS_PER_SM, GL.skinny_plan
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(1)
    rows = []

    def force(per_sm, cols):
        GL.SKINNY_CTAS_PER_SM = per_sm
        GL.skinny_plan = lambda *a: saved[1](*a, cols=cols)
        GL._PLANS.clear()

    try:
        for label, g, m, k, n in shapes():
            for dt in (torch.float32, torch.bfloat16):
                x, w = inputs(g, m, k, n, dt, gen, dev)
                path = GL.path_for(x, w)
                widths = (64, 128) if path == "mma_skinny" else (32, 64, 128)
                names = [(f"per_sm{p}/cols{c}", p, c) for p in (1, 4)
                         for c in widths]
                GL.SKINNY_CTAS_PER_SM = saved[0]
                chosen = saved[1](path, g, m, k, n, n_sm)
                plans = {}
                for name, p, c in names:
                    force(p, c)
                    plans[name] = GL.skinny_plan(path, g, m, k, n, n_sm)
                    check(block_diag_matmul, block_diag_matmul_plain, x, w,
                          dt, f"{label} {name}")
                times = {name: [] for name, *_ in names}
                for rnd in range(rounds):
                    order = names if rnd % 2 == 0 else names[::-1]
                    for name, p, c in order + order[::-1]:
                        force(p, c)
                        times[name].append(device_ms(
                            lambda: block_diag_matmul(x, w), reps=20))
                GL.SKINNY_CTAS_PER_SM, GL.skinny_plan = saved
                GL._PLANS.clear()
                row = dict(case=f"{label}/{str(dt)[6:]}", path=path,
                           chosen=chosen, plans=plans,
                           ms={v: statistics.median(t)
                               for v, t in times.items()},
                           spread_ms={v: max(t) - min(t)
                                      for v, t in times.items()})
                rows.append(row)
                print(f"{row['case']} ({path}): " + ", ".join(
                    f"{v} {plans[v]} {row['ms'][v]:.4f} ms (spread "
                    f"{row['spread_ms'][v]:.4f})" for v in times)
                    + f"; chosen {chosen}", flush=True)
    finally:
        GL.SKINNY_CTAS_PER_SM, GL.skinny_plan = saved
        GL._PLANS.clear()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the tree whose repro_torch is timed")
    ap.add_argument("--plans", action="store_true")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    dev = torch.device("cuda")
    card = gpu_name_and_limit()
    result = dict(card=card, src=args.src, cases=read_cases(dev))
    if args.plans:
        result["plans"] = read_plans(dev, args.rounds)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(result, indent=1))
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
