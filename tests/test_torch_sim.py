"""Port edge simulator (``sim/``, ``engine/sim_backend.py``, ``engine/
arrivals.py``, ``core/splitter.py``, ``sched/``) against the JAX package.

The simulator is host numpy in both packages and every check runs both on
the same seed: the same placements, fragments, request streams, metrics,
routing summaries and fault recoveries.  The timing fields
(``sched_time_s``, ``sched_ms_per_decision``, ``place_time_s``) read the
host clock and are left out of every comparison.  UCB decisions equal
JAX's exactly; its float state may differ in the last ulp (XLA fuses
multiply-adds that numpy rounds twice, ``test_torch_engine``), which would
move a decision only for an SLA ratio within an ulp of a bucket edge.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core.reward as jreward  # noqa: E402
import repro.core.splitter as jsplit  # noqa: E402
import repro.engine as jeng  # noqa: E402
import repro.faults as jfaults  # noqa: E402
import repro.sched.baselines as jbase  # noqa: E402
import repro.sched.policies as jpol  # noqa: E402
import repro.sim.simulator as jsim  # noqa: E402
import repro.sim.workloads as jwl  # noqa: E402
from repro.configs.base import get_config as jget  # noqa: E402
from repro.configs.base import list_configs  # noqa: E402
from repro.engine.routing import PrefixAwareRouter as JRouter  # noqa: E402
from repro.engine.sim_backend import SimBackend as JSim  # noqa: E402

import repro_torch.core.reward as treward  # noqa: E402
import repro_torch.core.splitter as tsplit  # noqa: E402
import repro_torch.engine as teng  # noqa: E402
import repro_torch.faults as tfaults  # noqa: E402
import repro_torch.sched.baselines as tbase  # noqa: E402
import repro_torch.sched.policies as tpol  # noqa: E402
import repro_torch.sim.simulator as tsim  # noqa: E402
import repro_torch.sim.workloads as twl  # noqa: E402
from repro_torch.configs.base import get_config as tget  # noqa: E402
from repro_torch.engine.routing import \
    PrefixAwareRouter as TRouter  # noqa: E402
from repro_torch.engine.sim_backend import SimBackend as TSim  # noqa: E402

TIMING = {"sched_time_s", "sched_ms_per_decision", "place_time_s"}
PLACEMENTS = ["RandomPlacement", "RoundRobinPlacement",
              "LeastLoadedPlacement"]


def _untimed(m: dict) -> dict:
    return {k: v for k, v in m.items() if k not in TIMING}


# --------------------------------------------------------------- baselines
class _Host:
    def __init__(self, hid, ram_mb, ram_used_mb, n_active):
        self.hid, self.ram_mb = hid, ram_mb
        self.ram_used_mb, self.n_active = ram_used_mb, n_active

    def fits(self, ram_mb):
        return self.ram_used_mb + ram_mb <= self.ram_mb


class _Frag:
    def __init__(self, ram_mb):
        self.ram_mb = ram_mb


@pytest.mark.parametrize("name", PLACEMENTS)
def test_baselines_place_equal(name):
    """``place`` (and least-loaded's ``place_arrays``) pick the same hosts
    over 300 seeded host states, infeasible ones included."""
    rng = np.random.default_rng(0)
    jp, tp = getattr(jbase, name)(), getattr(tbase, name)()
    picks = []
    for _ in range(300):
        n = int(rng.integers(1, 12))
        ram = np.where(np.arange(n) % 2 == 0, 4096.0, 8192.0)
        used = rng.uniform(0, 1, n) * ram
        active = rng.integers(0, 6, n)
        hosts = [_Host(i, ram[i], used[i], int(active[i])) for i in range(n)]
        frag = _Frag(float(rng.uniform(100, 5000)))
        picks.append(tp.place(frag, hosts))
        assert picks[-1] == jp.place(frag, hosts)
        if name == "LeastLoadedPlacement":
            args = (frag.ram_mb, ram - used, active, np.ones(n))
            fast = tp.place_arrays(*args)
            assert fast == jp.place_arrays(*args) == picks[-1]
    assert None in picks and len(set(picks)) > 3


# ---------------------------------------------------------------- splitter
@pytest.mark.parametrize("name", list_configs())
def test_splitter_fragments_equal(name):
    jcfg, tcfg = jget(name), tget(name)
    for decision in (jeng.LAYER, jeng.SEMANTIC):
        for n in (2, 4, 16):
            j = jsplit.fragments_for(jcfg, decision, n)
            t = tsplit.fragments_for(tcfg, decision, n)
            assert [dataclasses.astuple(f) for f in t] == \
                [dataclasses.astuple(f) for f in j]
        assert tsplit.mode_for_decision(decision) == \
            jsplit.mode_for_decision(decision)
    assert tsplit.MODES == jsplit.MODES


def test_batch_reward_equal():
    rng = np.random.default_rng(1)
    rts, slas = rng.uniform(0, 3, 64), rng.uniform(0.5, 2, 64)
    accs = rng.uniform(0.7, 0.95, 64)
    np.testing.assert_allclose(treward.batch_reward(rts, slas, accs),
                               float(jreward.batch_reward(rts, slas, accs)),
                               rtol=1e-6)


# ---------------------------------------------------------------- arrivals
def _fields(reqs):
    return [(r.rid, r.app_id, r.sla_s, r.max_new, r.arrival_s,
             None if r.tokens is None else r.tokens.tolist()) for r in reqs]


@pytest.mark.parametrize("prompt_len", [None, 12])
def test_sources_equal(prompt_len):
    kw = dict(prompt_len=prompt_len, vocab_size=100)
    jp = jeng.PoissonSource(rate=2.5, seed=4, **kw)
    tp = teng.PoissonSource(rate=2.5, seed=4, **kw)
    rng = np.random.default_rng(5)
    trace = np.stack([rng.uniform(0, 10, 40), rng.integers(0, 3, 40),
                      rng.uniform(0.5, 4, 40)], axis=1)
    jt = jeng.TraceSource(trace, seed=6, **kw)
    tt = teng.TraceSource(trace, seed=6, **kw)
    for t in np.arange(0, 12, 0.5):
        assert _fields(tp(t)) == _fields(jp(t))
        assert _fields(tt(t)) == _fields(jt(t))
    assert tt.exhausted and jt.exhausted and len(tt) == len(jt) == 40


# ---------------------------------------------------------------- simulator
def _sim_metrics(sim_mod, sched):
    sim = sim_mod.Simulator(sched, seed=0)
    m = sim.run(400)
    for h in sim.hosts:
        assert -1e-6 <= h.ram_used_mb <= h.ram_mb + 1e-6
    return _untimed(m), [(w.wid, w.decision, w.finish)
                         for w in sim.completed]


@pytest.mark.parametrize("decision", [jsim.LAYER, jsim.SEMANTIC],
                         ids=["layer", "semantic"])
@pytest.mark.parametrize("name", PLACEMENTS)
def test_simulator_fixed_equal(name, decision):
    jm, jdone = _sim_metrics(jsim, jpol.FixedDecisionScheduler(
        getattr(jbase, name)(), decision))
    tm, tdone = _sim_metrics(tsim, tpol.FixedDecisionScheduler(
        getattr(tbase, name)(), decision))
    assert tm == jm and tdone == jdone
    assert tm["completed"] > 50


def test_simulator_compression_equal():
    jm, _ = _sim_metrics(jsim, jpol.CompressionScheduler(
        jbase.LeastLoadedPlacement()))
    tm, _ = _sim_metrics(tsim, tpol.CompressionScheduler(
        tbase.LeastLoadedPlacement()))
    assert tm == jm and tm["completed"] > 50


def test_splitplace_ucb_decisions_equal():
    """The paper's scheduler with UCB: the same decision at every arrival
    (both arms taken) and the same metrics."""
    jm, jdone = _sim_metrics(jsim, jpol.SplitPlaceScheduler(
        jbase.LeastLoadedPlacement(), bandit="ucb"))
    tm, tdone = _sim_metrics(tsim, tpol.SplitPlaceScheduler(
        tbase.LeastLoadedPlacement(), bandit="ucb"))
    assert tdone == jdone and tm == jm
    assert 0 < tm["decisions_semantic_frac"] < 1
    # the sampling bandits run the same simulation (their draws are held
    # in distribution, not bit for bit: tests/test_torch_bandits.py)
    for bandit in ("thompson", "egreedy"):
        tm, _ = _sim_metrics(tsim, tpol.SplitPlaceScheduler(
            tbase.LeastLoadedPlacement(), bandit=bandit))
        assert tm["completed"] > 50
        assert 0 < tm["decisions_semantic_frac"] < 1


def test_simulator_reward_compares_in_float64():
    """A response time above its SLA by less than a float32 ulp: the
    reference tests it in float64 (violated) before its float32 cast, and
    so must the port's metric."""
    sla = 1.0
    rt = sla + 0.25 * float(np.spacing(np.float32(sla)))
    assert np.float32(rt) == np.float32(sla) and rt > sla
    metrics = {}
    for sim_mod, wl, pol, base in ((jsim, jwl, jpol, jbase),
                                   (tsim, twl, tpol, tbase)):
        sim = sim_mod.Simulator(pol.FixedDecisionScheduler(
            base.LeastLoadedPlacement(), sim_mod.LAYER))
        w = wl.Workload(0, wl.APPS[0], 0, 0.0, sla, decision=sim_mod.LAYER,
                        finish=rt, accuracy=0.9)
        sim.completed.append(w)
        metrics[sim_mod] = sim.metrics()
    assert metrics[tsim] == metrics[jsim]
    assert metrics[tsim]["sla_violation"] == 1.0
    assert metrics[tsim]["reward"] == round(float(np.float32(0.9) / 2), 4)


# ------------------------------------------------------------- sim backend
def _sim_run(pkg, backend_cls, placement, n_reqs=2000, seed=0):
    """tests/test_routing.py::_sim_run: 16 hosts with 2 cache slots, 16
    prefix families, COMPRESSED workloads in waves of 128."""
    backend = backend_cls(n_hosts=16, seed=seed, host_cache_slots=2)
    eng = pkg.PlacementEngine(pkg.FixedPolicy(pkg.COMPRESSED,
                                              placement=placement), backend)
    rng = np.random.default_rng(seed)
    done = submitted = 0
    while submitted < n_reqs or backend.pending():
        if submitted < n_reqs and not backend.unplaced \
                and backend.pending() < 400:
            k = min(128, n_reqs - submitted)
            fams = rng.integers(0, 16, k)
            eng.submit([pkg.Request(
                rid=submitted + j, app_id=int(rng.integers(3)), sla_s=30.0,
                prefix_family=int(fams[j]), prefix_frac=0.5)
                for j in range(k)])
            submitted += k
        done += len(eng.step())
    assert done == n_reqs
    return _untimed(eng.summary())


def test_sim_backend_routing_equal():
    jrouter, trouter = JRouter(), TRouter()
    jr = _sim_run(jeng, JSim, jrouter)
    tr = _sim_run(teng, TSim, trouter)
    jl = _sim_run(jeng, JSim, jbase.LeastLoadedPlacement())
    tl = _sim_run(teng, TSim, tbase.LeastLoadedPlacement())
    assert tr == jr and tl == jl
    assert trouter.stats() == jrouter.stats()
    assert trouter.routed == 2000
    assert tr["prefix_hit_rate"] > tl["prefix_hit_rate"] + 0.2


def test_sim_backend_1000_hosts_equal():
    """tests/test_engine.py's 1000-host MAB run."""
    out = []
    for pkg, backend_cls in ((jeng, JSim), (teng, TSim)):
        eng = pkg.PlacementEngine(pkg.MABPolicy(bandit="ucb", seed=0),
                                  backend_cls(n_hosts=1000, seed=1))
        out.append(_untimed(eng.run(pkg.PoissonSource(rate=30, seed=3), 60)))
        out[-1]["_decisions"] = list(eng.stats.decisions)
    assert out[1] == out[0]
    assert out[1]["completed"] > 500 and out[1]["n_hosts"] == 1000


def _fault_run(pkg, backend_cls, fmod, plan_rows, n_hosts, rate, seed,
               intervals):
    plan = fmod.FaultPlan([fmod.Fault(at=at, kind=kind, **kw)
                           for at, kind, kw in plan_rows]) \
        if plan_rows else None
    eng = pkg.PlacementEngine(pkg.FixedPolicy(pkg.LAYER, placement=None),
                              backend_cls(n_hosts=n_hosts, seed=0,
                                          faults=plan))
    eng.run(pkg.PoissonSource(rate=rate, seed=seed), intervals)
    eng.drain()
    b = eng.backend
    assert (b.host_ram_used >= -1e-6).all()
    assert (b.host_ram_used <= b.host_ram_mb + 1e-6).all()
    return _untimed(eng.summary())


#: tests/test_faults.py's two sim plans: (at, kind, fields)
CRASH_AND_STALL = ((2.0, "host_crash", dict(target=0, duration=3.0)),
                   (2.5, "host_crash", dict(target=1, duration=3.0)),
                   (4.0, "host_stall", dict(target=2, duration=5.0,
                                            magnitude=0.25)))
ONE_CRASH = ((3.0, "host_crash", dict(target=0, duration=2.0)),)


@pytest.mark.parametrize("rows,n_hosts,rate,seed,intervals", [
    (CRASH_AND_STALL, 4, 2.0, 3, 200), (ONE_CRASH, 6, 1.5, 4, 150)],
    ids=["crash_and_stall", "one_crash"])
def test_sim_host_faults_equal(rows, n_hosts, rate, seed, intervals):
    args = (rows, n_hosts, rate, seed, intervals)
    jm = _fault_run(jeng, JSim, jfaults, *args)
    tm = _fault_run(teng, TSim, tfaults, *args)
    assert tm == jm
    assert tm["faults_injected"] == len(rows)
    assert tm["re_executions"] >= 1 and tm["recovered"] >= 1
    assert tm["hosts_down"] == 0
    if rows == CRASH_AND_STALL:
        assert tm["recovery_latency_p50"] > 0
    clean = _fault_run(teng, TSim, tfaults, (), n_hosts, rate, seed,
                       intervals)
    assert clean["completed"] == tm["completed"]
