"""The port's legacy gang path (``TorchBackend(decode="legacy")``, and
``decode="auto"`` on models the paged path does not take) against
``JaxBackend`` on the same weights.

Both backends draw nothing of their own here: ``TorchBackend`` draws each
arm's weights, and the JAX runners' ``init`` is patched to return those
weights through numpy (a JAX init of a Mamba stack takes seconds).  Every
wave fits one gang batch, so the batch, its padding and its decode steps
are known to the test.  Greedy tokens are compared exactly only after
checking that the JAX model's smallest top-2 logit gap over the tokens it
chose clears a margin: ``MARGIN`` (the paged tests' 1e-3), and 1e-2 for
xlstm, whose logits move by ~1e-3 under a one-ulp change of its weights
(``tests/test_torch_zoo.py``); the counters (``batches``,
``decode_steps``, ``prefill_calls``, bucket hits and misses, occupancy)
must be equal.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import get_config  # noqa: E402
from repro.dist import api as JA  # noqa: E402
from repro.engine import FixedPolicy as JFixed  # noqa: E402
from repro.engine import PlacementEngine as JPlacement  # noqa: E402
from repro.engine import Request as JRequest  # noqa: E402
from repro.engine.jax_backend import JaxBackend  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.engine import (LAYER, SEMANTIC, FixedPolicy,  # noqa: E402
                                PlacementEngine, Request, TorchBackend)
from repro_torch.models import layers as TL  # noqa: E402

from test_torch_paged import port_cfg  # noqa: E402

MARGIN = 1e-3
XLSTM_MARGIN = 1e-2
COUNTERS = ("batches", "prefill_calls", "decode_steps",
            "prefill_bucket_misses", "prefill_bucket_hits",
            "prefill_buckets", "batch_occupancy")


def _cfg(name):
    if name == "tiny":
        return get_config("stablelm-1.6b").reduced().replace(
            d_model=64, n_heads=2, n_kv_heads=2, head_dim=32, d_ff=128,
            vocab_size=128)
    cfg = get_config(name).reduced()
    if len(cfg.pattern) > 2:
        cfg = cfg.replace(n_layers=len(cfg.pattern))
    return cfg


def _waves(mk, vocab, n, waves, seed, plen=(3, 9), max_new=(2, 7)):
    rng = np.random.default_rng(seed)
    out = []
    rid = 0
    for _ in range(waves):
        wave = []
        for _ in range(n):
            wave.append(mk(rid=rid, app_id=int(rng.integers(0, 3)),
                           tokens=rng.integers(0, vocab, int(rng.integers(
                               *plen))).astype(np.int32),
                           sla_s=float(rng.uniform(0.5, 4.0)),
                           max_new=int(rng.integers(*max_new))))
            rid += 1
        out.append(wave)
    return out


def _min_margin(jmodel, params, waves):
    """Smallest top-2 gap of the JAX logits behind each generated token:
    per wave (one gang batch) a causal forward over every request's
    zero-padded prompt followed by its output."""
    gaps = []
    for wave in waves:
        plen = max(len(r.tokens) for r in wave)
        width = plen + max(r.max_new for r in wave)
        toks = np.zeros((len(wave), width), np.int32)
        for i, r in enumerate(wave):
            toks[i, :len(r.tokens)] = r.tokens
            toks[i, plen:plen + r.max_new] = r.output
        logits, _ = jax.jit(jmodel.forward)(params, {"tokens": toks})
        logits = np.asarray(logits)
        for i, r in enumerate(wave):
            lg = logits[i, plen - 1:plen - 1 + r.max_new]
            top2 = np.sort(lg, axis=-1)[:, -2:]
            gaps.append(float((top2[:, 1] - top2[:, 0]).min()))
    return min(gaps)


def _run_both(monkeypatch, tiny_mesh, cfg, arm, *, decode, n=3, waves=2,
              seed=5, plen=(3, 9), max_new=(2, 7), **kw):
    kw = dict(cache_len=kw.pop("cache_len", 32), max_batch=4, arms=(arm,),
              decode=decode, **kw)
    tb = TorchBackend(port_cfg(cfg), device="cpu", **kw)
    weights = bridge.tree_to_numpy(tb.models[arm].param_tree())
    monkeypatch.setattr(JA.BaseRunner, "init", lambda self, key: jax.tree.map(
        np.asarray, weights))
    jb = JaxBackend(cfg, tiny_mesh, **kw)
    jwaves = _waves(JRequest, cfg.vocab_size, n, waves, seed, plen, max_new)
    twaves = _waves(Request, cfg.vocab_size, n, waves, seed, plen, max_new)
    for eng, ws in ((JPlacement(JFixed(arm, placement=None), jb), jwaves),
                    (PlacementEngine(FixedPolicy(arm, placement=None), tb),
                     twaves)):
        for wave in ws:
            eng.submit(wave)
            eng.drain()
    return jb, tb, jwaves, twaves


def _check(jb, tb, arm, jwaves, twaves):
    assert arm not in tb._paged and arm not in tb._disagg
    margin = _min_margin(jb.runners[arm].model, jb.params[arm], jwaves)
    assert margin > (XLSTM_MARGIN if "xlstm" in jb.cfg.name else MARGIN), \
        margin
    for jw, tw in zip(jwaves, twaves):
        for j, t in zip(jw, tw):
            assert t.output.shape == (t.max_new,)
            np.testing.assert_array_equal(t.output, j.output)
    jm, tm = jb.extra_metrics(), tb.extra_metrics()
    for key in COUNTERS:
        assert tm[key] == jm[key], key
    assert tb.batches == jb.batches and tb.decode_steps == jb.decode_steps


@pytest.mark.parametrize("arm", [LAYER, SEMANTIC], ids=["layer", "semantic"])
def test_legacy_matches_jax_backend(monkeypatch, tiny_mesh, arm):
    """Tokens and gang counters equal to ``JaxBackend``'s: the tiny
    stablelm under ``decode="legacy"``, one whole-prompt prefill a batch
    (``tests/test_torch_legacy_recurrent.py`` takes the recurrent
    models)."""
    jb, tb, jw, tw = _run_both(monkeypatch, tiny_mesh, _cfg("tiny"), arm,
                               decode="legacy")
    _check(jb, tb, arm, jw, tw)
    assert tb.extra_metrics()["prefill_calls"] == len(jw)


@pytest.mark.parametrize("arm", [LAYER, SEMANTIC], ids=["layer", "semantic"])
def test_gemma2_rings_past_wrap_match_jax_backend(monkeypatch, tiny_mesh,
                                                   arm):
    """Reduced gemma2 (local window 16, softcaps, post norms): prompts of
    12-15 tokens and 6-9 new tokens carry the gang past the local layers'
    16-slot rings."""
    cfg = _cfg("gemma2-27b")
    jb, tb, jw, tw = _run_both(monkeypatch, tiny_mesh, cfg, arm,
                               decode="auto", waves=1, seed=7,
                               plen=(12, 16), max_new=(6, 10))
    _check(jb, tb, arm, jw, tw)
    plen = max(len(r.tokens) for r in tw[0])
    assert plen + max(r.max_new for r in tw[0]) > cfg.sliding_window + 1


def test_paged_tokens_equal_legacy_tokens(tiny_cfg):
    """Equal-length prompts: the paged path and the gang path emit the
    same greedy tokens on both arms (``tests/test_decode.py``'s parity
    held inside the port)."""
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, tiny_cfg.vocab_size, 4).astype(np.int32)
               for _ in range(3)]
    for arm in (LAYER, SEMANTIC):
        outs = {}
        for mode in ("paged", "legacy"):
            tb = TorchBackend(port_cfg(tiny_cfg), device="cpu", cache_len=16,
                              max_batch=4, decode=mode, block_size=4,
                              scan_tokens=4, arms=(arm,))
            eng = PlacementEngine(FixedPolicy(arm, placement=None), tb)
            reqs = [Request(rid=i, app_id=0, tokens=p, sla_s=2.0, max_new=6)
                    for i, p in enumerate(prompts)]
            eng.submit(reqs)
            eng.drain()
            outs[mode] = [r.output for r in reqs]
        for a, b in zip(outs["paged"], outs["legacy"]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("knob", [dict(decode="paged"),
                                  dict(fleet="disagg")])
def test_recurrent_arm_refusals_match_jax(tiny_mesh, knob):
    """``decode="paged"`` and ``fleet="disagg"`` on a recurrent model raise
    the reference's ``ValueError`` before the arm registers."""
    cfg = _cfg("xlstm-125m")
    with pytest.raises(ValueError) as jerr:
        JaxBackend(cfg, tiny_mesh, arms=(LAYER,), **knob)
    with pytest.raises(ValueError) as terr:
        TorchBackend(port_cfg(cfg), device="cpu", arms=(LAYER,), **knob)
    assert str(terr.value) == str(jerr.value)


def test_legacy_disagg_refusal_matches_jax(tiny_cfg, tiny_mesh):
    with pytest.raises(ValueError) as jerr:
        JaxBackend(tiny_cfg, tiny_mesh, decode="legacy", fleet="disagg")
    with pytest.raises(ValueError) as terr:
        TorchBackend(port_cfg(tiny_cfg), device="cpu", decode="legacy",
                     fleet="disagg")
    assert str(terr.value) == str(jerr.value)


def test_cache_write_clamps_as_dynamic_update_slice():
    """A write starting past the cache's end lands where
    ``lax.dynamic_update_slice`` clamps it (the last S slots), and the
    decode step still attends over every slot: a request longer than
    ``cache_len`` gives the reference's result, not an index error."""
    from repro.models import layers as JL
    cfg = _cfg("tiny")
    tcfg = port_cfg(cfg)
    rng = np.random.default_rng(8)
    params = JL.attn_init(jax.random.PRNGKey(2), cfg)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
    L, K, hd = 6, cfg.n_kv_heads, cfg.hd
    cache = rng.normal(size=(2, L, K, hd)).astype(np.float32)
    for s, index in ((1, 9), (1, L), (3, 5)):
        x = rng.normal(size=(2, s, cfg.d_model)).astype(np.float32)
        pos = np.arange(index, index + s)[None]
        jout, jc = JL.attn_apply(params, x, cfg, positions=pos,
                                 kv_cache={"k": cache, "v": cache},
                                 cache_index=index)
        tc = {"k": torch.from_numpy(cache.copy()),
              "v": torch.from_numpy(cache.copy())}
        tout, tc = TL.attn_apply(tp, torch.from_numpy(x), tcfg,
                                 positions=torch.from_numpy(pos),
                                 kv_cache=tc, cache_index=index)
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout),
                                   rtol=1e-5, atol=1e-5)
        for n in ("k", "v"):
            np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]),
                                       rtol=1e-6, atol=1e-6)
        # the write landed in the last s slots, nothing before them moved
        np.testing.assert_array_equal(tc["k"].numpy()[:, :L - s],
                                      cache[:, :L - s])


def test_gang_path_serves_past_cache_len(monkeypatch, tiny_mesh):
    """Prompts + new tokens past ``cache_len``: both backends clamp the
    writes the same way and emit the same tokens."""
    cfg = _cfg("tiny")
    jb, tb, jw, tw = _run_both(monkeypatch, tiny_mesh, cfg, LAYER,
                               decode="legacy", waves=1, seed=11,
                               cache_len=8)
    assert max(len(r.tokens) + r.max_new for r in tw[0]) > 8
    _check(jb, tb, LAYER, jw, tw)
