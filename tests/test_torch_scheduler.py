"""Port ``PagedArmScheduler`` against the JAX one on the same seeded traces
and the same (bridged) weights: identical token streams per request and
identical counters (prefix hits, COW copies, preemptions, spilled blocks,
dispatch and bucket counts).  Scenarios follow the JAX parity tests in
tests/test_decode.py: an in-flight join, a prefix hit with a copy-on-write
block on both arms and both KV dtypes, and an undersized pool that forces
preemption and resume.

Exact tokens are a fair demand only away from near-ties: every scenario
checks that the JAX run's smallest top-2 logit margin (recomputed with the
dense forward over each request's history) clears 1e-3, ten times the f32
logit tolerance of tests/test_torch_paged.py.
"""
import heapq

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.decode import PagedArmScheduler as JSched  # noqa: E402
from repro.decode.paged_model import quantize_attn_params  # noqa: E402
from repro.kernels.quant_matmul import dequantize_blockwise  # noqa: E402
from repro.engine import Request as JRequest  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.decode.scheduler import PagedArmScheduler as TSched  # noqa
from repro_torch.engine.types import Request as TRequest  # noqa: E402

from test_torch_paged import np_tree, port_cfg  # noqa: E402

MARGIN = 1e-3
#: one unit of the 6th decimal the weight_quant error gauges round to (plus
#: the float slack of a difference of two rounded decimals)
QUANT_ERR_TOL = 1e-6 * (1 + 1e-6)


def _pump(sched, queue, max_steps=300):
    done = []
    steps = 0
    while queue or sched.has_work():
        sched.try_join(queue, 0.0)
        done.extend(sched.prefill_step(0.0))
        done.extend(sched.dispatch(0.0))
        steps += 1
        assert steps < max_steps, "scheduler made no progress"
    return done


def _arm_models(cfg, arm, seed):
    jcfg = cfg if arm == "layer" else cfg.semantic(2)
    jmodel = jbuild(jcfg)
    params = jmodel.init(jax.random.PRNGKey(seed))
    return jmodel, params, bridge.model_from_params(port_cfg(jcfg),
                                                    np_tree(params))


def _min_margin(jmodel, params, lanes):
    """Smallest top-2 gap of the JAX logits that chose each generated
    token: one dense causal forward over every lane's prompt + generated
    history, right-padded to a common length (padding never reaches the
    earlier positions of a causal model)."""
    hists = [np.concatenate([l.req.tokens, l.out]).astype(np.int32)
             for l in lanes]
    width = max(len(h) for h in hists)
    toks = np.zeros((len(hists), width), np.int32)
    for i, h in enumerate(hists):
        toks[i, :len(h)] = h
    logits, _ = jax.jit(jmodel.forward)(params, {"tokens": toks})
    logits = np.asarray(logits)
    gaps = []
    for i, (lane, h) in enumerate(zip(lanes, hists)):
        lg = logits[i, len(lane.req.tokens) - 1:len(h) - 1]
        top2 = np.sort(lg, axis=-1)[:, -2:]
        gaps.append(float((top2[:, 1] - top2[:, 0]).min()))
    return min(gaps)


def _dequantized(params, bits: int):
    """``params`` with each attention projection replaced by its blockwise
    dequantization: the weights a ``weight_quant`` scheduler serves with
    (its CPU path dequantizes, then multiplies in f32)."""
    qp, _ = quantize_attn_params(params, bits)
    blocks = {pos: {**blk, "mix": {
        k: dequantize_blockwise(v["q"], v["scale"], bits=bits)
        if isinstance(v, dict) else v for k, v in blk["mix"].items()}}
        for pos, blk in qp["blocks"].items()}
    return {**qp, "blocks": blocks}


def _run_both(cfg, arm, seed, kw, script):
    """Run ``script(sched, mk_req)`` on a JAX and a port scheduler; return
    the two (lanes by rid, stats) pairs, checking the JAX margins (with the
    dequantized projections when ``kw`` asks for ``weight_quant``).  The
    weight_quant error gauges are sums in another order, rounded to 6
    decimals: they may differ by one unit of the last one."""
    jmodel, params, tmodel = _arm_models(cfg, arm, seed)
    results = []
    for side in ("jax", "torch"):
        if side == "jax":
            sched = JSched(jmodel, params, **kw)
            mk = JRequest
        else:
            sched = TSched(tmodel, **kw)
            mk = TRequest
        lanes = script(sched, mk)
        results.append(({l.req.rid: l for l in lanes}, sched.stats()))
    (jl, js), (tl, ts) = results
    mparams = params if kw.get("weight_quant") is None else \
        _dequantized(params, int(kw["weight_quant"][3:]))
    assert _min_margin(jmodel, mparams, jl.values()) > MARGIN
    assert sorted(jl) == sorted(tl)
    for rid in jl:
        assert tl[rid].out == jl[rid].out, f"request {rid}"
        assert tl[rid].preemptions == jl[rid].preemptions
    for key, val in js.items():
        if key in ("re_executions", "recovered"):      # fault plane: later
            continue
        if key in ("weight_quant_max_err", "weight_quant_mean_err"):
            assert ts[key] == pytest.approx(val, abs=QUANT_ERR_TOL), key
            continue
        assert ts[key] == val, key
    return jl, js


def _req(mk, rid, toks, m, sla=4.0):
    return mk(rid=rid, app_id=0, tokens=toks, sla_s=sla, max_new=m,
              arrival_s=0.0)


def test_in_flight_join_matches_jax(tiny_cfg):
    rng = np.random.default_rng(9)
    prompt_a = rng.integers(0, tiny_cfg.vocab_size, 5).astype(np.int32)
    prompt_b = rng.integers(0, tiny_cfg.vocab_size, 3).astype(np.int32)

    def script(sched, mk):
        q = [(2.0, 0, 0.0, _req(mk, 1, prompt_b, 12))]
        sched.try_join(q, 0.0)
        sched.prefill_step(0.0)
        done = sched.dispatch(0.0)            # B is mid-flight...
        heapq.heappush(q, (2.0, 1, 0.0, _req(mk, 0, prompt_a, 6)))
        sched.try_join(q, 0.0)                # ...when A joins
        assert sched.n_active == 2
        return done + _pump(sched, q)

    _run_both(tiny_cfg, "layer", 1, dict(n_lanes=4, cache_len=16,
                                         block_size=4, scan_tokens=4), script)


@pytest.mark.parametrize("kv", ["f32", "int8"])
@pytest.mark.parametrize("arm", ["layer", "semantic"])
def test_prefix_hit_cow_matches_jax(tiny_cfg, arm, kv):
    rng = np.random.default_rng(13)
    head = rng.integers(0, tiny_cfg.vocab_size, 10).astype(np.int32)
    donor = np.concatenate([head, rng.integers(0, tiny_cfg.vocab_size, 2)
                            .astype(np.int32)])
    probe = np.concatenate([head, rng.integers(0, tiny_cfg.vocab_size, 3)
                            .astype(np.int32)])

    def script(sched, mk):
        q = [(4.0, 0, 0.0, _req(mk, 1, donor, 4))]
        done = _pump(sched, q)                # donor populates the cache
        q = [(4.0, 1, 0.0, _req(mk, 0, probe, 6))]
        return done + _pump(sched, q)

    _, st = _run_both(tiny_cfg, arm, 2, dict(
        n_lanes=4, cache_len=32, block_size=4, scan_tokens=4,
        prefill_chunk=4, kv_dtype=kv), script)
    assert st["prefix_hit_tokens"] >= 8 and st["cow_copies"] >= 1


def test_undersized_pool_preempts_like_jax(tiny_cfg):
    rng = np.random.default_rng(9)
    victim_p = rng.integers(0, tiny_cfg.vocab_size, 8).astype(np.int32)
    urgent_p = rng.integers(0, tiny_cfg.vocab_size, 8).astype(np.int32)

    def script(sched, mk):
        q = [(9.0, 0, 0.0, _req(mk, 0, victim_p, 12, 9.0))]
        sched.try_join(q, 0.0)
        sched.prefill_step(0.0)
        done = sched.dispatch(0.0)            # victim is mid-decode...
        heapq.heappush(q, (1.0, 1, 0.0, _req(mk, 1, urgent_p, 4, 1.0)))
        return done + _pump(sched, q)

    # 6 allocatable blocks: the victim's 5 and the urgent 3 cannot coexist
    _, st = _run_both(tiny_cfg, "layer", 1, dict(
        n_lanes=2, cache_len=32, block_size=4, scan_tokens=4,
        prefill_chunk=8, num_blocks=7), script)
    assert st["preemptions"] >= 1 and st["spilled_blocks"] >= 5
    assert st["prefix_hit_tokens"] > 0 and st["used_blocks"] == 0
