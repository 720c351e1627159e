"""Port fault plane (``repro_torch.faults`` and ``TorchBackend``'s faults=,
max_retries / breaker_cooldown, max_ship_retries and load_shed) against the
JAX package.

The plan and the injector are the reference's copied: the same seed gives
the same plan, and the same advance / take sequence the same answers.  The
chaos plan of tests/test_faults.py against the disagg fleet must lose
nothing and give the clean run's tokens and the JAX chaos run's, on f32 and
int8 pools, with the same injected faults by kind; the other counters hold
the JAX test's invariants, since ship expiry reads the wall clock
(``ship_timeout_s`` 0.05).  Blackouts, the breaker, load shedding and the
ship-failure budget hold the invariants of tests/test_faults.py, with
clean-run token parity where the reference asks for it.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import faults as jfaults  # noqa: E402
from repro.engine import FixedPolicy as JFixed  # noqa: E402
from repro.engine import PlacementEngine as JPlacement  # noqa: E402
from repro.engine import Request as JRequest  # noqa: E402
from repro.engine.jax_backend import JaxBackend  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import faults as tfaults  # noqa: E402
from repro_torch.engine import (LAYER, FixedPolicy,  # noqa: E402
                                PlacementEngine, Request, TorchBackend)

from test_torch_paged import np_tree, port_cfg  # noqa: E402
from test_torch_scheduler import MARGIN, _min_margin  # noqa: E402

KIND_NAMES = ("ARM_BLACKOUT", "DISPATCH_ERROR", "HOST_CRASH", "HOST_STALL",
              "SHIP_DELAY", "SHIP_DROP", "SHIP_DUP")


def _chaos_plan(F):
    """tests/test_faults.py's six-fault plan, built from module ``F``."""
    return F.FaultPlan([
        F.Fault(at=2.0, kind=F.SHIP_DROP),
        F.Fault(at=3.0, kind=F.ARM_BLACKOUT, target=LAYER, duration=3.0),
        F.Fault(at=6.0, kind=F.SHIP_DELAY, magnitude=0.3),
        F.Fault(at=7.0, kind=F.SHIP_DUP),
        F.Fault(at=8.0, kind=F.DISPATCH_ERROR, count=2),
        F.Fault(at=9.0, kind=F.SHIP_DROP),
    ], seed=7)


def _fault_tuple(f):
    return (f.at, f.kind, f.target, f.duration, f.count, f.magnitude, f.site)


# ------------------------------------------------------------ plan/injector
def test_kinds_and_validation_match_jax():
    for name in KIND_NAMES + ("FAULT_KINDS",):
        assert getattr(tfaults, name) == getattr(jfaults, name), name
    for kw in (dict(at=0.0, kind="meteor_strike"),
               dict(at=-1.0, kind="ship_drop"),
               dict(at=0.0, kind="dispatch_error", count=0),
               dict(at=0.0, kind="dispatch_error", site="router")):
        with pytest.raises(ValueError) as je:
            jfaults.Fault(**kw)
        with pytest.raises(ValueError) as te:
            tfaults.Fault(**kw)
        assert str(te.value) == str(je.value)
    assert issubclass(tfaults.TransientDispatchError, RuntimeError)


@pytest.mark.parametrize("seed", range(3))
def test_plan_generate_matches_jax(seed):
    kw = dict(horizon=50.0, n_hosts=8, arms=(0, 1),
              rates={k: 2.0 for k in jfaults.FAULT_KINDS})
    jp = jfaults.FaultPlan.generate(seed, **kw)
    tp = tfaults.FaultPlan.generate(seed, **kw)
    assert [_fault_tuple(f) for f in tp] == [_fault_tuple(f) for f in jp]
    assert tp.counts() == jp.counts() and len(tp) == len(jp)
    assert repr(tp) == repr(jp)


@pytest.mark.parametrize("seed", range(3))
def test_injector_matches_jax(seed):
    """One random advance / take_ship_fault / take_dispatch_error stream
    on both injectors: the same fired faults, charges and stats."""
    rng = np.random.default_rng(seed)
    kw = dict(horizon=40.0, n_hosts=4, arms=(0, 1),
              rates={k: 3.0 for k in jfaults.FAULT_KINDS})
    ji = jfaults.FaultInjector(jfaults.FaultPlan.generate(seed + 10, **kw))
    ti = tfaults.FaultInjector(tfaults.FaultPlan.generate(seed + 10, **kw))
    now = 0.0
    for _ in range(200):
        op = rng.random()
        if op < 0.3:
            now += float(rng.uniform(0.0, 1.0))
            assert [_fault_tuple(f) for f in ti.advance(now)] == \
                [_fault_tuple(f) for f in ji.advance(now)]
        elif op < 0.6:
            assert ti.take_ship_fault() == ji.take_ship_fault()
        else:
            arm = int(rng.integers(0, 2))
            site = ("prefill", "decode")[int(rng.integers(0, 2))]
            assert ti.take_dispatch_error(arm, site) == \
                ji.take_dispatch_error(arm, site)
        assert ti.pending() == ji.pending()
    assert ti.stats() == ji.stats() and ti.consumed == ji.consumed
    assert ti.total_injected == ji.total_injected


# ------------------------------------------------------------ chaos harness
def _mk_reqs(mk, vocab, n, plen, max_new, seed=5, sla=None):
    rng = np.random.default_rng(seed)
    return [mk(rid=i, app_id=int(rng.integers(0, 3)),
               tokens=rng.integers(0, vocab, plen).astype(np.int32),
               sla_s=sla if sla is not None else float(rng.uniform(0.5, 4.0)),
               max_new=max_new, arrival_s=0.0)
            for i in range(n)]


def _kw(kw):
    kw.setdefault("fleet", "disagg")
    kw.setdefault("ship_timeout_s", 0.05)
    kw.setdefault("max_ship_retries", 8)
    return dict(cache_len=32, max_batch=4, block_size=4, scan_tokens=2,
                arms=(LAYER,), **kw)


def _run_jax(cfg, mesh, *, faults, n=5, max_new=10, **kw):
    backend = JaxBackend(cfg, mesh, faults=faults, **_kw(kw))
    eng = JPlacement(JFixed(LAYER, placement=None), backend)
    reqs = _mk_reqs(JRequest, cfg.vocab_size, n, plen=6, max_new=max_new)
    eng.submit(reqs)
    eng.drain()
    return eng, reqs


def _run(cfg, weights, *, faults, n=5, max_new=10, **kw):
    backend = TorchBackend(port_cfg(cfg), device="cpu", faults=faults,
                           **_kw(kw))
    bridge.load_params(backend.models[LAYER], weights)
    eng = PlacementEngine(FixedPolicy(LAYER, placement=None), backend)
    reqs = _mk_reqs(Request, cfg.vocab_size, n, plen=6, max_new=max_new)
    eng.submit(reqs)
    eng.drain()
    return eng, reqs


@pytest.fixture(scope="module")
def jax_layer(tiny_cfg, tiny_mesh):
    """The LAYER arm's JAX backend weights (the init every JaxBackend of
    this config and seed draws) with the backend."""
    jb = JaxBackend(tiny_cfg, tiny_mesh, cache_len=16, arms=(LAYER,))
    return jb, np_tree(jb.params[LAYER])


def _tokens_equal(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.output, y.output)


def _unwound(eng):
    pf, dc, store = eng.backend._disagg[LAYER]
    assert pf.alloc.used_blocks == 0 and dc.alloc.used_blocks == 0
    assert store.backlog == 0


@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_chaos_parity_disagg(tiny_cfg, tiny_mesh, jax_layer, kv):
    """The chaos plan (arm blackout, dropped / delayed / duplicated ship
    waves, transient dispatch errors) against the disagg fleet loses
    nothing; every request's tokens equal the port's clean run and the JAX
    chaos run, and the faults fire as in JAX."""
    jb0, weights = jax_layer
    eng_clean, reqs_clean = _run(tiny_cfg, weights, faults=None, kv_dtype=kv)
    eng, reqs = _run(tiny_cfg, weights, faults=_chaos_plan(tfaults),
                     kv_dtype=kv)
    jeng, jreqs = _run_jax(tiny_cfg, tiny_mesh,
                           faults=_chaos_plan(jfaults), kv_dtype=kv)
    m, jm = eng.summary(), jeng.summary()
    assert m["completed"] == len(reqs) == jm["completed"]
    assert m.get("shed", 0) == 0 and m.get("failed", 0) == 0
    _tokens_equal(reqs_clean, reqs)
    _tokens_equal(jreqs, reqs)
    lanes = [type("L", (), {"req": r, "out": list(r.output)})
             for r in jreqs]
    assert _min_margin(jb0.runners[LAYER].model, jb0.params[LAYER],
                       lanes) > MARGIN
    fault_keys = sorted(k for k in jm if k.startswith("fault"))
    assert fault_keys == sorted(k for k in m if k.startswith("fault"))
    assert {k: m[k] for k in fault_keys} == {k: jm[k] for k in fault_keys}
    assert m["faults_injected"] == 6
    # the recovery machinery engaged, as the JAX test asks of its run
    assert m["retries"] > 0
    assert m["re_executions"] >= 1
    assert m["recovered"] >= 1
    assert m["recovery_latency_p50"] > 0
    assert m["recovery_latency_p99"] >= m["recovery_latency_p50"]
    _unwound(eng)


def test_chaos_replay_deterministic(tiny_cfg, jax_layer):
    """The same plan against the same trace replays: the same tokens and
    the same injected-fault accounting."""
    _, weights = jax_layer
    runs = [_run(tiny_cfg, weights, faults=_chaos_plan(tfaults))
            for _ in range(2)]
    (e0, r0), (e1, r1) = runs
    assert e0.summary()["completed"] == len(r0)
    _tokens_equal(r0, r1)
    keys = ("faults_injected", "fault_arm_blackout", "fault_ship_drop",
            "fault_dispatch_error")
    assert [e0.summary()[k] for k in keys] == [e1.summary()[k] for k in keys]


def test_blackout_spills_and_resumes_colocated(tiny_cfg, jax_layer):
    """On the colocated path a blackout spills every seated lane through
    the preempt/resume path; the window closes under drain and everything
    completes with clean-run tokens."""
    _, weights = jax_layer
    plan = tfaults.FaultPlan([tfaults.Fault(
        at=2.0, kind=tfaults.ARM_BLACKOUT, target=LAYER, duration=2.0)])
    _, reqs_c = _run(tiny_cfg, weights, faults=None, fleet=None)
    eng, reqs = _run(tiny_cfg, weights, faults=plan, fleet=None)
    m = eng.summary()
    assert m["completed"] == len(reqs)
    assert m["fault_arm_blackout"] == 1
    assert m["preemptions"] >= 1
    assert m["recovered"] >= 1
    assert m["recovery_latency_p50"] > 0
    _tokens_equal(reqs_c, reqs)
    sched = eng.backend._paged[LAYER]
    assert sched.alloc.used_blocks == 0


def test_dispatch_breaker_trips_and_recovers(tiny_cfg, jax_layer):
    """More consecutive transient dispatch errors than the retry budget
    trip the arm's breaker; after the cooldown the arm serves again and the
    run completes with clean-run tokens."""
    _, weights = jax_layer
    plan = tfaults.FaultPlan([tfaults.Fault(
        at=2.0, kind=tfaults.DISPATCH_ERROR, target=LAYER, site="decode",
        count=6)])
    _, reqs_c = _run(tiny_cfg, weights, faults=None, fleet=None)
    eng, reqs = _run(tiny_cfg, weights, faults=plan, fleet=None,
                     max_retries=2, breaker_cooldown=3)
    m = eng.summary()
    assert m["completed"] == len(reqs)
    assert m["breaker_trips"] >= 1
    assert m["dispatch_retries"] >= 1
    assert m["retries"] >= m["dispatch_retries"]
    _tokens_equal(reqs_c, reqs)


def test_load_shedding_drops_only_expired_queued(tiny_cfg, jax_layer):
    """Queued past-deadline requests leave with a ``shed`` Outcome (never
    dispatched, never completed); live-SLA requests are untouched."""
    _, weights = jax_layer
    backend = TorchBackend(port_cfg(tiny_cfg), device="cpu", cache_len=32,
                           max_batch=4, block_size=4, scan_tokens=2,
                           arms=(LAYER,), load_shed=True)
    bridge.load_params(backend.models[LAYER], weights)
    eng = PlacementEngine(FixedPolicy(LAYER, placement=None), backend)
    dead = _mk_reqs(Request, tiny_cfg.vocab_size, 3, plen=6, max_new=5,
                    seed=1, sla=1e-6)
    live = _mk_reqs(Request, tiny_cfg.vocab_size, 3, plen=6, max_new=5,
                    seed=2, sla=60.0)
    for i, r in enumerate(live):
        r.rid = 100 + i
    eng.submit(dead + live)
    eng.drain()
    m = eng.summary()
    assert m["completed"] == 3 and m["shed"] == 3
    assert all(r.output is None for r in dead)
    assert all(r.output is not None for r in live)
    assert eng.stats.shed == 3
    assert len(eng.stats.latencies) == 3


def test_ship_failure_budget_is_terminal(tiny_cfg, jax_layer):
    """A request whose every ship wave is dropped exhausts
    ``max_ship_retries`` and leaves with a ``failed`` Outcome."""
    _, weights = jax_layer
    backend = TorchBackend(port_cfg(tiny_cfg), device="cpu", cache_len=32,
                           max_batch=4, block_size=4, scan_tokens=2,
                           arms=(LAYER,), fleet="disagg",
                           ship_timeout_s=0.0, max_ship_retries=2)
    bridge.load_params(backend.models[LAYER], weights)
    eng = PlacementEngine(FixedPolicy(LAYER, placement=None), backend)
    backend._disagg[LAYER][2].drop_filter = lambda rid: True
    reqs = _mk_reqs(Request, tiny_cfg.vocab_size, 2, plen=6, max_new=5)
    eng.submit(reqs)
    eng.drain()
    m = eng.summary()
    assert m["completed"] == 0 and m["failed"] == 2
    assert m["ship_failed"] == 2
    assert m["ship_requeues"] >= 2 * 2
    assert all(r.output is None for r in reqs)
    _unwound(eng)
