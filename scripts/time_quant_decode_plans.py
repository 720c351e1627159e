"""Time ``quant_matmul``'s tensor-core paths and ``paged_decode_attention``'s
split walk at the main path's shapes with each launch plan forced in turn,
so the plans of ``_quant_launch.mma_plan`` and ``_paged_launch.decode_plan``
rest on a measurement.

    PYTHONPATH=src python scripts/time_quant_decode_plans.py [--out plans.json]

Needs one CUDA card.  Cases, all bf16:

- ``quant_matmul`` ``mma_skinny`` at T 8 (the decode step) with the groups
  split over 1, 2, 4 and 8 CTAs of a cluster, and ``mma_tile`` at T 200 and
  T 1024 (prefill chunks) on 64- and 128-row tiles; the LAYER projection
  (D = E = 2048) and the SEMANTIC one (two branches, D = E = 1024), int8
  and int4 codes in groups of 128.
- ``paged_decode_attention`` over ``chip_smoke.kernel_case`` (8 lanes,
  ragged lengths up to 1024, bs 16) at the widths of stablelm-1.6b (H = K
  = 32, hd 64) and qwen2-moe-a2.7b (H = K = 16, hd 128), bf16 and int8
  pools, with the walk cut into the pieces that 1, 2 and 4 CTAs per SM
  give.

Each variant is first checked against the plain version (quant: 2e-2 (1 +
|plain|); decode: 2e-2 of each output row's max |plain|), then timed in the
order a, b, ..., ..., b, a over several rounds (device time per call from
``torch.profiler``, ``chip_smoke.device_ms``); its median, its spread (max
- min over rounds) and the variant the launcher picks are printed, then the
card's name and power limit and one JSON line.
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import statistics
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as C  # noqa: E402

TOL = 2e-2


def timed(variants, run, rounds):
    """{name: [ms, ...]}: each variant's device time per call, measured in
    the order a, b, ..., ..., b, a once per round."""
    times = {name: [] for name, _ in variants}
    for rnd in range(rounds):
        order = variants if rnd % 2 == 0 else variants[::-1]
        for name, force in order + order[::-1]:
            force()
            times[name].append(C.device_ms(run, reps=10))
    return times


def summary(label, times, chosen):
    row = dict(case=label, chosen=chosen,
               ms={v: statistics.median(t) for v, t in times.items()},
               spread_ms={v: max(t) - min(t) for v, t in times.items()})
    print(f"{label}: " + ", ".join(
        f"{v} {row['ms'][v]:.4f} ms (spread {row['spread_ms'][v]:.4f})"
        for v in times) + f"; chosen {chosen}", flush=True)
    return row


def quant_rows(dev, rounds):
    from repro_torch.kernels import _quant_launch as QL
    from repro_torch.kernels import quant_matmul as Q
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(7)
    saved = QL.mma_plan
    rows = []
    try:
        for arm, g, d, e in C.QUANT_SHAPES:
            w = torch.randn(g, d, e, generator=gen, device=dev) / math.sqrt(d)
            for bits in (8, 4):
                q, sc = Q.quantize_blockwise(w, bits=bits)
                n_g = sc.shape[1]
                for t in (8, 200, 1024):
                    x = torch.randn(g, t, d, generator=gen,
                                    device=dev).bfloat16()
                    want = Q.quant_matmul_plain(x, q, sc).float()
                    rows_c, splits_c, _ = saved(g, t, e, n_g, n_sm)
                    if t <= QL.DECODE_T:
                        plans = [(f"splits {s}", (rows_c, s, -(-n_g // s)))
                                 for s in (1, 2, 4, 8) if s <= n_g]
                        chosen = f"splits {splits_c}"
                    else:
                        plans = [(f"rows {r}", (r, 1, n_g)) for r in (64, 128)]
                        chosen = f"rows {rows_c}"
                    variants = [(name, (lambda p=p: setattr(
                        QL, "mma_plan", lambda *a: p))) for name, p in plans]
                    for name, force in variants:        # warm-up and check
                        force()
                        got = Q.quant_matmul(x, q, sc).float()
                        ok = bool(((got - want).abs()
                                   <= TOL * (1 + want.abs())).all())
                        assert ok, (arm, bits, t, name)
                    times = timed(variants, lambda: Q.quant_matmul(x, q, sc),
                                  rounds)
                    QL.mma_plan = saved
                    rows.append(summary(
                        f"quant {arm} int{bits} T{t}", times, chosen))
    finally:
        QL.mma_plan = saved
    return rows


def decode_rows(dev, rounds):
    from repro_torch.kernels import _paged_launch as PL
    from repro_torch.kernels import paged_decode_attention as D
    saved = PL.DECODE_CTAS_PER_SM
    rows = []
    try:
        for h, kh, hd in C.PAGED_HEADS:
            for label, kv in (("bf16", "bf16"), ("int8-bf16q", "int8")):
                cs = C.kernel_case(dev, kv=kv, qdt=torch.bfloat16, h=h,
                                   kh=kh, hd=hd)
                args = (cs["q"], cs["k"], cs["v"], cs["tables"],
                        cs["lengths"])
                kw = dict(k_scale=cs["k_scale"], v_scale=cs["v_scale"])
                want = D.paged_decode_attention_plain(*args, **kw)
                limit = C.paged_limit(want, TOL)

                def plan_name(per_sm):
                    PL.DECODE_CTAS_PER_SM = per_sm
                    _, _, pieces, piece = PL.decode_plan(
                        h=h, kh=kh, hd=hd, kv_item=cs["k"].element_size(),
                        b=cs["q"].shape[0], g=1, nb=cs["tables"].shape[1],
                        bs=cs["k"].shape[1],
                        n_sm=torch.cuda.get_device_properties(
                            dev).multi_processor_count)
                    return f"{pieces} pieces of {piece}"
                chosen = plan_name(saved)
                variants = [(plan_name(p), (lambda p=p: setattr(
                    PL, "DECODE_CTAS_PER_SM", p))) for p in (1, 2, 4)]
                for name, force in variants:
                    force()
                    got = D.paged_decode_attention(*args, **kw)
                    assert bool(((got.float() - want.float()).abs()
                                 <= limit).all()), (hd, label, name)
                times = timed(
                    variants, lambda: D.paged_decode_attention(*args, **kw),
                    rounds)
                PL.DECODE_CTAS_PER_SM = saved
                rows.append(summary(f"decode hd{hd} {label}", times, chosen))
    finally:
        PL.DECODE_CTAS_PER_SM = saved
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", default=None, help="write the rows as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_quant_decode_plans: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = C.gpu_name_and_limit()
    rows = quant_rows(dev, args.rounds) + decode_rows(dev, args.rounds)
    result = dict(card=card, rows=rows)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(result, indent=1))
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
