"""Port MoE FFN against the JAX package.

``moe_apply`` and its load-balance term are held to
``repro.models.moe._moe_apply_dense`` on the same weights and tokens (f32,
1e-5: the same products in another summation order): with capacity drops, with a router whose logits tie (``lax.top_k``
takes the lower expert first, and so must the port), and per branch on the
semantic split (JAX ``vmap``s the branches; the port routes each branch on
its own inside one call).  Then the paged forwards and the scheduler of
reduced qwen2-moe on both arms, with the tolerances of
tests/test_torch_paged.py and tests/test_torch_scheduler.py.  The scheduler
check raises the capacity factor to 2 (no token can drop) so that the dense
forward that measures the top-2 margins routes as the paged calls do.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import get_config  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.engine import LAYER, TorchBackend  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

from test_torch_paged import (check_paged_forwards, np_tree,  # noqa: E402
                              port_cfg)
from test_torch_scheduler import _pump, _req, _run_both  # noqa: E402


def _qwen(capacity_factor=None):
    cfg = get_config("qwen2-moe-a2.7b").reduced()
    if capacity_factor is not None:
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    return cfg


def _moe_case(case):
    """(cfg, JAX params, port params, x [G, B, S, d], JAX's output and
    aux) of a ``moe_apply`` case: ``drops`` (capacity factor 0.5),
    ``ties`` (three equal router columns), ``branches`` (a 2-branch
    semantic split at 0.5), ``gelu`` (the two-projection MLP at 0.5),
    ``unchosen`` (8 experts, 2 tokens: most experts get no token)."""
    cfg = _qwen(None if case == "ties" else 0.5)
    shape = (3, 6)
    if case == "branches":
        cfg = cfg.semantic(2).replace(n_branches=1)
    elif case == "gelu":
        cfg = cfg.replace(mlp_type="gelu")
    elif case == "unchosen":
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, n_experts=8))
        shape = (1, 2)
    g = 2 if case == "branches" else 1
    keys = jax.random.split(jax.random.PRNGKey(3), g)
    params = jax.vmap(lambda k: jmoe.moe_init(k, cfg))(keys)
    if case == "ties":
        # three equal router columns: lax.top_k keeps the lower experts
        r = np.array(params["router"])
        r[..., 1] = r[..., 2] = r[..., 0]
        params["router"] = jnp.asarray(r)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(g, *shape, cfg.d_model)).astype(np.float32)
    want, want_aux = jax.vmap(
        lambda p, xb: jmoe._moe_apply_dense(p, xb, cfg))(
        params, jnp.asarray(x))
    tparams = jax.tree.map(lambda a: torch.from_numpy(np.array(a)),
                           np_tree(params))
    return cfg, params, tparams, x, want, want_aux


@pytest.mark.parametrize("case", ["drops", "ties", "branches"])
def test_moe_apply_matches_jax(case):
    """The training path (a gradient recorded: the capacity slots)."""
    cfg, params, tparams, x, want, want_aux = _moe_case(case)
    g = x.shape[0]
    got, aux = tmoe.moe_apply(tparams, torch.from_numpy(x).reshape(g, 18, -1),
                              port_cfg(cfg))
    np.testing.assert_allclose(got.reshape(x.shape).numpy(),
                               np.asarray(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(aux.numpy(), np.asarray(want_aux), rtol=1e-5)
    if case == "ties":
        logits = torch.from_numpy(x[0].reshape(18, -1)) @ tparams["router"][0]
        _, idx = tmoe.router_topk(logits, cfg.moe.top_k)
        _, jidx = jmoe.router_topk(jnp.asarray(logits.numpy()),
                                   cfg.moe.top_k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        assert (idx[:, 0] == 0).any() and (idx[:, :2] != 2).all()


@pytest.mark.parametrize("case", ["drops", "ties", "branches", "gelu",
                                  "unchosen"])
def test_compact_serving_path_matches_jax(case, monkeypatch):
    """The serving path (``no_grad``: the kept assignments compacted by
    expert, one ragged product a projection) against JAX's
    ``_moe_apply_dense`` within 1e-5; every projection takes R = G T k
    rows.  Its dispatch against the slot path's buffers on the same
    routing, exactly: expert e's rows offsets[e] .. offsets[e + 1] are its
    filled slots (tokens and weights, in slot order), no other slot is
    filled, and the dropped assignments follow at weight 0."""
    cfg, _, tparams, x, want, want_aux = _moe_case(case)
    pcfg, m = port_cfg(cfg), cfg.moe
    g, t = x.shape[0], x.shape[1] * x.shape[2]
    xt = torch.from_numpy(x).reshape(g, t, -1)
    rows = []
    ragged = tmoe.moe_gmm_ragged
    monkeypatch.setattr(tmoe, "moe_gmm_ragged", lambda a, w, off: (
        rows.append(a.shape[0]), ragged(a, w, off))[1])
    with torch.no_grad():
        got, aux = tmoe.moe_apply(tparams, xt, pcfg)
    np.testing.assert_allclose(got.reshape(x.shape).numpy(),
                               np.asarray(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(aux.numpy(), np.asarray(want_aux), rtol=1e-5)
    n_proj = 3 if pcfg.mlp_type == "swiglu" else 2
    assert rows == [g * t * m.top_k] * n_proj

    logits = xt @ tparams["router"]
    weights, idx = tmoe.router_topk(logits, m.top_k)
    buf_tok, buf_w = tmoe._dispatch_buffers(weights, idx, g, t, pcfg.moe)
    tok, w, off = tmoe._dispatch_compact(weights, idx, g, t, pcfg.moe)
    assert off.dtype == torch.int32 and off.shape == (g * m.n_experts + 1,)
    assert tok.shape == w.shape == (g * t * m.top_k,)
    counts = off.diff().tolist()
    for e, n in enumerate(counts):
        lo = int(off[e])
        assert torch.equal(tok[lo:lo + n], buf_tok[e, :n])
        assert torch.equal(w[lo:lo + n], buf_w[e, :n])
        assert (buf_w[e, n:] == 0).all()
    kept = int(off[-1])
    assert (w[kept:] == 0).all()
    # every assignment appears once: its token k times over kept + dropped
    assert torch.equal(torch.bincount(tok, minlength=g * t),
                       torch.full((g * t,), m.top_k))
    if case in ("drops", "branches", "gelu"):
        assert kept < g * t * m.top_k            # assignments dropped
    if case == "unchosen":
        assert counts.count(0) >= m.n_experts - 4


def test_router_topk_ties_take_lower_expert():
    logits = torch.tensor([[1.0, 3.0, 3.0, 3.0, 0.0],
                           [2.0, 2.0, 2.0, 2.0, 2.0]]).bfloat16()
    w, idx = tmoe.router_topk(logits, 2)
    jw, jidx = jmoe.router_topk(jnp.asarray(logits.float().numpy(),
                                            jnp.bfloat16), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(idx.numpy(), [[1, 2], [0, 1]])
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6)


def test_expert_parallel_moe_waits_for_training_slice():
    """The expert-parallel path came with the multi-device training slice:
    on a 1 x 1 mesh (one expert owner, no all-to-all) it is the dense
    dispatch exactly; across ranks ``tests/test_torch_multi.py`` holds it.
    Outside a mesh it raises, as the reference's unbound axis does."""
    from repro_torch.launch.mesh import MeshShape, use_mesh
    cfg = port_cfg(_qwen())
    ep_cfg = cfg.replace(expert_parallel_axis="model")
    rng = np.random.default_rng(3)
    params = {"router": torch.from_numpy(rng.standard_normal(
        (cfg.d_model, cfg.moe.n_experts)).astype(np.float32))}
    shapes = tmoe.moe_shapes(cfg)
    params["experts"] = {k: torch.from_numpy(rng.standard_normal(
        (1,) + v).astype(np.float32) * 0.1)
        for k, v in shapes["experts"].items()}
    if "shared" in shapes:
        params["shared"] = {k: torch.from_numpy(rng.standard_normal(
            (1,) + v).astype(np.float32) * 0.1)
            for k, v in shapes["shared"].items()}
    params["router"] = params["router"][None]
    x = torch.from_numpy(rng.standard_normal((1, 12, cfg.d_model))
                         .astype(np.float32))
    want, want_aux = tmoe.moe_apply(params, x, cfg)
    with use_mesh(MeshShape((1, 1))):
        got, got_aux = tmoe.moe_apply(params, x, ep_cfg)
    assert torch.equal(got, want) and torch.equal(got_aux, want_aux)
    with pytest.raises(NotImplementedError, match="inside a mesh"):
        tmoe.moe_apply(params, x, ep_cfg)


@pytest.mark.parametrize("kv", ["f32", "int8"])
@pytest.mark.parametrize("arm", ["layer", "semantic"])
def test_moe_paged_forwards_match_jax(arm, kv):
    """Reduced qwen2-moe (MoE FFN, head dim 64) through the paged chunk and
    decode forwards: logits, then the decode loop's tokens.  f32 KV: 1e-4.
    int8 KV: 2e-3, since a last-ulp difference in a K/V value can move its
    code by one step (2 of 32768 V codes here), and at d 256 with logits up
    to 3.3 one such step moves a logit by up to 1.4e-3 (the 1e-3 of
    tests/test_torch_paged.py holds a d-64 model with smaller logits)."""
    check_paged_forwards(_qwen(), arm, kv, 1e-4 if kv == "f32" else 2e-3)


@pytest.mark.parametrize("arm", ["layer", "semantic"])
def test_moe_scheduler_matches_jax(arm):
    cfg = _qwen(2.0)
    rng = np.random.default_rng(9)
    prompt_a = rng.integers(0, cfg.vocab_size, 11).astype(np.int32)
    prompt_b = rng.integers(0, cfg.vocab_size, 6).astype(np.int32)

    def script(sched, mk):
        q = [(2.0, 0, 0.0, _req(mk, 1, prompt_b, 9)),
             (3.0, 1, 0.0, _req(mk, 0, prompt_a, 6))]
        return _pump(sched, q)

    _run_both(cfg, arm, 1, dict(n_lanes=4, cache_len=32, block_size=4,
                                scan_tokens=4, prefill_chunk=8), script)


def test_backend_serves_moe_with_weight_quant():
    """TorchBackend on the CPU serves reduced qwen2-moe from int8 attention
    projections: every request gets its tokens and the gauges report."""
    from repro_torch.engine import FixedPolicy, PlacementEngine, Request
    cfg = port_cfg(_qwen())
    tb = TorchBackend(cfg, cache_len=32, max_batch=4, block_size=4,
                      scan_tokens=4, prefill_chunk=8, weight_quant="int8",
                      arms=(LAYER,), device="cpu")
    rng = np.random.default_rng(2)
    reqs = [Request(rid=i, app_id=0, sla_s=5.0, max_new=3 + i,
                    tokens=rng.integers(0, cfg.vocab_size, 5 + i)
                    .astype(np.int32)) for i in range(3)]
    eng = PlacementEngine(FixedPolicy(LAYER, placement=None), tb)
    eng.submit(reqs)
    eng.drain()
    assert [r.output.shape for r in reqs] == [(3,), (4,), (5,)]
    m = tb.extra_metrics()
    assert m["weight_quant_bits"] == 8 and m["weight_quant_max_err"] > 0
