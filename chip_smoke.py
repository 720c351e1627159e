"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py [--out report.json]

Needs one CUDA card and the CUDA toolkit; exits non-zero (printing no
result) without them or outside a checkout of the repository.  Phases, each
raising on failure:

1. build    every hand-written kernel from ``src/repro_torch/kernels/csrc``.
2. kernels  each kernel against its plain PyTorch version on the same CUDA
            tensors at the full-width shapes of stablelm-1.6b (H = K = 32,
            hd = 64, bs = 16; decode B = 8, prefill C = 128; ragged lengths
            up to 1024, blocks aliased across lanes, a length-0 pad row;
            f32, bf16 and int8 pools), with kernel, plain and library
            (``scaled_dot_product_attention`` on the pre-gathered dense
            cache, a yardstick the port never calls) times and the bound.
3. serve    full-width stablelm-1.6b in bf16 through ``PlacementEngine(
            MABPolicy(bandit="ucb"))`` and ``TorchBackend`` on both arms:
            24 requests over 3 apps, 128-512-token prompts from 3
            shared-prefix families, 32-64 new tokens.  The kernels' launch
            counters are zeroed just before and read just after, and must
            equal 24 launches per prefill chunk and per decode step (one per
            layer; the semantic arm's two branches fold into one launch).
4. int8     a shorter serve with ``kv_dtype="int8"``.
5. model    the served models' bf16 logits are finite; an f32 copy of each
            arm gives the same logits through the kernels as through the
            plain versions on a small input (1e-3 of the largest logit).

The last lines are one JSON object per kernel line, the card's name and
power limit, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12                    # H100 SXM device memory
PEAK_FLOPS = {torch.bfloat16: 989e12,        # dense tensor-core bf16
              torch.float32: 67e12}          # f32 outside the tensor cores
TOL = {"f32": 1e-4, "bf16": 2e-2, "int8-f32q": 1e-3, "int8-bf16q": 2e-2}
N_LAYERS = 24


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_limit() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 10, rounds: int = 5) -> float:
    """Median over ``rounds`` of the mean per-call time of ``reps`` calls,
    from CUDA events, after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return statistics.median(out)


# ------------------------------------------------------------------ kernels
def kernel_case(dev, *, kv: str, qdt, seed: int = 0):
    """Full-width paged inputs: 8 lanes over a 513-block pool, ragged
    lengths up to 1024 with a length-0 pad row (null table), lanes 1-3
    aliasing lane 1's first 8 blocks, and one prefill lane whose chunk
    runs past the table."""
    from repro_torch.decode.paged_cache import quantize_kv
    g = torch.Generator(device=dev).manual_seed(seed)
    b, h, kh, hd, bs, nb, c = 8, 32, 32, 64, 16, 64, 128
    p_blocks = 1 + b * nb
    kf = torch.randn(p_blocks, bs, kh, hd, generator=g, device=dev)
    vf = torch.randn(p_blocks, bs, kh, hd, generator=g, device=dev)
    rng = np.random.default_rng(seed)
    tables = rng.permutation(np.arange(1, p_blocks)).reshape(b, nb)
    tables[2:4, :8] = tables[1, :8]
    tables[0] = 0
    lengths = np.asarray([0, 1024, 700, 513, 129, 1000, 64, 300], np.int32)
    starts = np.maximum(lengths - c, 0)
    starts[5] = 960                              # 960 + 127 > NB * bs
    positions = (starts[:, None] + np.arange(c)).astype(np.int32)
    case = dict(
        tables=torch.from_numpy(tables.astype(np.int32)).to(dev),
        lengths=torch.from_numpy(lengths).to(dev),
        positions=torch.from_numpy(positions).to(dev),
        q=torch.randn(b, h, hd, generator=g, device=dev).to(qdt),
        qc=torch.randn(b, c, h, hd, generator=g, device=dev).to(qdt))
    if kv == "int8":
        (k, ks), (v, vs) = quantize_kv(kf), quantize_kv(vf)
        case.update(k=k, v=v, k_scale=ks, v_scale=vs)
    else:
        case.update(k=kf.to(qdt), v=vf.to(qdt), k_scale=None, v_scale=None)
    return case


def _needed_slots(tables, last_pos, bs):
    """Unique physical (block, slot) pairs the lanes attend: keys
    0..last_pos[b] (clipped to the table) of each lane, aliases once."""
    slots = set()
    nb = tables.shape[1]
    for b, last in enumerate(last_pos):
        for pos in range(min(int(last) + 1, nb * bs)):
            slots.add((int(tables[b, pos // bs]), pos % bs))
    return len(slots)


def bound(case, *, chunk: bool):
    """(bound_ms, bound_by): the larger of the bytes this run's data needs
    over the memory rate and its flops over the peak for q's type."""
    q = case["qc"] if chunk else case["q"]
    tables = case["tables"].cpu().numpy()
    bs, kh, hd = case["k"].shape[1:]
    h = q.shape[-2]
    if chunk:
        qpos = case["positions"].cpu().numpy()
        last = qpos.max(axis=1)
        keys = np.minimum(qpos + 1, tables.shape[1] * bs).sum()
    else:
        lengths = case["lengths"].cpu().numpy()
        last = lengths - 1
        keys = lengths.sum()
    slots = _needed_slots(tables, last, bs)
    per_slot = 2 * kh * hd * case["k"].element_size()
    if case["k_scale"] is not None:
        per_slot += 2 * kh * 4
    nbytes = slots * per_slot + 2 * q.numel() * q.element_size() \
        + tables.nbytes + (case["positions"] if chunk
                           else case["lengths"]).numel() * 4
    flops = 4.0 * h * hd * float(keys)           # QK^T and PV
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[q.dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def library_call(case, *, chunk: bool):
    """``scaled_dot_product_attention`` over the dense cache gathered
    beforehand (a yardstick; the port never calls it)."""
    import torch.nn.functional as F
    from repro_torch.kernels.ref import dequant_pool_ref
    tables = case["tables"].long()
    qdt = case["q"].dtype
    k = dequant_pool_ref(case["k"], case["k_scale"]).to(qdt)[tables]
    v = dequant_pool_ref(case["v"], case["v_scale"]).to(qdt)[tables]
    b, nb, bs, kh, hd = k.shape
    k = k.reshape(b, nb * bs, kh, hd).transpose(1, 2).contiguous()
    v = v.reshape(b, nb * bs, kh, hd).transpose(1, 2).contiguous()
    kpos = torch.arange(nb * bs, device=k.device)
    if chunk:
        q = case["qc"].transpose(1, 2).contiguous()          # [B, H, C, hd]
        mask = kpos[None, None, None, :] <= \
            case["positions"][:, None, :, None]
    else:
        q = case["q"][:, :, None, :]                          # [B, H, 1, hd]
        mask = kpos[None, None, None, :] < case["lengths"][:, None, None, None]
        mask = mask | (case["lengths"] == 0)[:, None, None, None]
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)


def kernel_phase(dev):
    from repro_torch.kernels import paged_decode_attention as D
    from repro_torch.kernels import paged_prefill_attention as P
    results = {}
    cases = (("f32", "f32", torch.float32), ("bf16", "bf16", torch.bfloat16),
             ("int8-f32q", "int8", torch.float32),
             ("int8-bf16q", "int8", torch.bfloat16))
    specs = (
        ("paged_decode_attention", D.paged_decode_attention,
         D.paged_decode_attention_plain, "q", "lengths", False,
         "src/repro/kernels/paged_decode_attention.py:33"),
        ("paged_prefill_attention", P.paged_prefill_attention,
         P.paged_prefill_attention_plain, "qc", "positions", True,
         "src/repro/kernels/paged_prefill_attention.py:35"))
    for name, kern, plain, qkey, pkey, chunk, replaces in specs:
        per = {}
        for label, kv, qdt in cases:
            cs = kernel_case(dev, kv=kv, qdt=qdt)
            args = (cs[qkey], cs["k"], cs["v"], cs["tables"], cs[pkey])
            kw = dict(k_scale=cs["k_scale"], v_scale=cs["v_scale"])
            got = kern(*args, **kw)
            want = plain(*args, **kw)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            if not math.isfinite(err) or err > TOL[label]:
                raise AssertionError(f"{name} [{label}]: max |kernel - "
                                     f"plain| {err} > {TOL[label]}")
            if not chunk and bool((got[0] != 0).any()):
                raise AssertionError(f"{name} [{label}]: pad row not 0")
            bnd, by = bound(cs, chunk=chunk)
            row = dict(max_abs_err=err, tol=TOL[label],
                       ms=time_ms(lambda: kern(*args, **kw)),
                       plain_ms=time_ms(lambda: plain(*args, **kw), reps=3),
                       library_ms=time_ms(library_call(cs, chunk=chunk)),
                       bound_ms=bnd, bound_by=by)
            per[label] = row
            log(f"[kernels] {name} {label}: max_abs_err={err:.3g} "
                f"(tol {TOL[label]}) kernel {row['ms']:.4f} ms, plain "
                f"{row['plain_ms']:.4f} ms, sdpa {row['library_ms']:.4f} "
                f"ms, bound {bnd:.4f} ms ({by})")
            del cs, got, want
        results[name] = dict(replaces=replaces, per_dtype=per)
    return results


# -------------------------------------------------------------------- serve
def make_requests(vocab: int, n: int, seed: int):
    """``n`` requests over 3 apps: prompts of 128-512 tokens whose heads
    (100, 150 and 230 tokens: not block multiples, so hits end in a
    copy-on-write block) come from 3 families, 32-64 new tokens, SLAs from
    tight to loose."""
    from repro_torch.engine import Request
    rng = np.random.default_rng(seed)
    heads = [rng.integers(0, vocab, n_h).astype(np.int32)
             for n_h in (100, 150, 230)]
    reqs = []
    for rid in range(n):
        fam = rid % 3
        total = int(rng.integers(max(128, len(heads[fam]) + 8), 513))
        tail = rng.integers(0, vocab, total - len(heads[fam]))
        reqs.append(Request(
            rid=rid, app_id=int(rng.integers(0, 3)),
            tokens=np.concatenate([heads[fam], tail]).astype(np.int32),
            sla_s=float(rng.choice([0.5, 2.0, 8.0, 30.0])),
            max_new=int(rng.integers(32, 65))))
    return reqs


def serve_phase(dev, cfg, *, kv_dtype: str, n_requests: int, waves: int):
    from repro_torch.engine import (MABPolicy, PlacementEngine,
                                    TorchBackend)
    from repro_torch.kernels.paged_decode_attention import \
        paged_decode_attention
    from repro_torch.kernels.paged_prefill_attention import \
        paged_prefill_attention
    from repro_torch.obs import Tracer, set_tracer
    t0 = time.perf_counter()
    backend = TorchBackend(cfg, cache_len=1024, max_batch=8, block_size=16,
                           prefill_chunk=128, kv_dtype=kv_dtype, device=dev)
    eng = PlacementEngine(MABPolicy(bandit="ucb"), backend)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    reqs = make_requests(cfg.vocab_size, n_requests, seed=1)
    per_wave = -(-n_requests // waves)
    tracer = Tracer()
    old = set_tracer(tracer)
    paged_decode_attention.launches = 0
    paged_prefill_attention.launches = 0
    t0 = time.perf_counter()
    try:
        for w in range(waves):
            eng.submit(reqs[w * per_wave:(w + 1) * per_wave])
            eng.drain()
        torch.cuda.synchronize()
    finally:
        set_tracer(old)
    wall = time.perf_counter() - t0
    launches = {"paged_decode_attention": paged_decode_attention.launches,
                "paged_prefill_attention": paged_prefill_attention.launches}
    summary = eng.summary()

    for r in reqs:
        if r.output is None or r.output.shape != (r.max_new,):
            raise AssertionError(f"request {r.rid}: output "
                                 f"{None if r.output is None else r.output.shape}"
                                 f", wanted {r.max_new} tokens")
    if summary["completed"] != n_requests:
        raise AssertionError(f"completed {summary['completed']}")
    if set(summary["per_mode"]) != {"layer", "semantic"}:
        raise AssertionError(f"arms served: {summary['per_mode']}")
    if not summary["prefix_hit_rate"] > 0:
        raise AssertionError("no prefix-cache hits")
    steps = {"prefill": 0, "decode": 0}
    for s in backend._paged.values():
        for bucket, n in s.buckets.items():
            kind, shape = bucket.split(":")
            if kind == "prefill":
                steps["prefill"] += n
            elif kind == "decode":
                steps["decode"] += n * int(shape.split("x")[1])
    want = {"paged_prefill_attention": N_LAYERS * steps["prefill"],
            "paged_decode_attention": N_LAYERS * steps["decode"]}
    for k in launches:
        if not launches[k] > 0 or launches[k] != want[k]:
            raise AssertionError(f"{k}: {launches[k]} launches, dispatches "
                                 f"imply {want[k]}")
    scans = tracer.events("decode_scan")
    decode_s = sum(e[4] for e in scans) / 1e6
    tokens = int(sum(r.max_new for r in reqs))
    out = dict(kv_dtype=kv_dtype, requests=n_requests, tokens=tokens,
               wall_s=wall, setup_s=setup_s, tokens_per_s=tokens / wall,
               decode_dispatches=summary["decode_dispatches"],
               prefill_chunks=summary["prefill_chunks"],
               decode_steps=steps["decode"],
               decode_ms_per_step=1e3 * decode_s / max(steps["decode"], 1),
               prefix_hit_rate=summary["prefix_hit_rate"],
               cow_copies=summary["cow_copies"],
               preemptions=summary["preemptions"],
               per_mode=summary["per_mode"], launches=launches,
               ttft_p50=summary.get("ttft_p50"),
               response_p50=summary.get("response_p50"))
    log(f"[serve {kv_dtype}] {json.dumps(out)}")
    return backend, out


# -------------------------------------------------------------------- model
def model_phase(dev, backend):
    """bf16 logits of the served models are finite; f32 copies give the
    same logits through the kernels and through the plain versions."""
    from repro_torch.decode import paged_model as PM
    from repro_torch.kernels.paged_decode_attention import \
        paged_decode_attention_plain
    from repro_torch.kernels.paged_prefill_attention import \
        paged_prefill_attention_plain
    from repro_torch.models.model import build_model
    rng = np.random.default_rng(3)
    out = {}
    for arm, model in sorted(backend.models.items()):
        cfg = model.cfg
        vocab = backend.cfg.vocab_size
        toks = torch.from_numpy(rng.integers(0, vocab, (2, 128))
                                .astype(np.int32)).to(dev)
        tables = torch.arange(1, 17, dtype=torch.int32,
                              device=dev).reshape(2, 8)
        starts = torch.zeros(2, dtype=torch.int32, device=dev)
        n_tok = torch.tensor([100, 60], dtype=torch.int32, device=dev)

        def run(m):
            pool = m.init_cache(17, 16)
            lc, _ = PM.paged_chunk_logits(m, pool, toks, starts, n_tok,
                                          tables)
            tok = lc.argmax(-1).int()[:, None]
            ld, _ = PM.paged_decode_logits(m, pool, tok, tables, n_tok,
                                           torch.ones(2, dtype=torch.bool,
                                                      device=dev))
            return torch.cat([lc, ld])

        served = run(model)
        if served.shape != (4, vocab) or not bool(served.isfinite().all()):
            raise AssertionError(f"arm {arm}: bf16 logits not finite")
        f32 = build_model(cfg.replace(dtype="float32"), device=dev)
        with torch.no_grad():
            for p32, p in zip(f32.parameters(), model.parameters()):
                p32.copy_(p.float())
        kern = run(f32)
        saved = PM.paged_decode_attention, PM.paged_prefill_attention
        PM.paged_decode_attention = paged_decode_attention_plain
        PM.paged_prefill_attention = paged_prefill_attention_plain
        try:
            ref = run(f32)
        finally:
            PM.paged_decode_attention, PM.paged_prefill_attention = saved
        rel = float((kern - ref).abs().max() / ref.abs().max())
        if not rel <= 1e-3:
            raise AssertionError(f"arm {arm}: f32 kernel vs plain logits "
                                 f"differ by {rel} of the largest")
        out[arm] = dict(rel_err_f32=rel, argmax_equal=bool(
            (kern.argmax(-1) == ref.argmax(-1)).all()))
        log(f"[model] arm {arm}: bf16 logits finite; f32 kernel vs plain "
            f"max diff {rel:.3g} of max |logit|")
        del f32
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write the full report as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import _build

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_name_and_limit()
    log(f"[device] {torch.cuda.get_device_name(0)} | {card} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    libs = _build.build_all()
    build_s = time.perf_counter() - t0
    for name, path in libs.items():
        log(f"[build] {name}: {path.name} in {build_s:.1f} s")
        log(path.with_suffix(".ptxas.txt").read_text().strip()[-2000:])

    kernels = kernel_phase(dev)
    cfg = get_config("stablelm-1.6b")
    backend, serve = serve_phase(dev, cfg, kv_dtype="f32", n_requests=24,
                                 waves=4)
    model = model_phase(dev, backend)
    del backend
    torch.cuda.empty_cache()
    backend8, serve8 = serve_phase(dev, cfg, kv_dtype="int8", n_requests=9,
                                   waves=3)
    del backend8
    torch.cuda.empty_cache()

    line = []
    for name in ("paged_decode_attention", "paged_prefill_attention"):
        main_row = kernels[name]["per_dtype"]["bf16"]
        line.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/paged_attention.cu",
            replaces=kernels[name]["replaces"],
            launches=serve["launches"][name],
            max_abs_err=main_row["max_abs_err"], ms=main_row["ms"],
            plain_ms=main_row["plain_ms"], bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
            library_ms=main_row["library_ms"]))
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(dict(
            card=card, build_s=build_s, kernels=kernels, serve=serve,
            serve_int8=serve8, model=model), indent=1))
    print(json.dumps({"kernels": line}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
