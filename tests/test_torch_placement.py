"""Port placement policies (``repro_torch.sched.a3c``, ``repro_torch.sched.
gobi``) against the JAX package, on the CPU.

Both packages start A3C from JAX's ``a3c_init(PRNGKey(seed))`` weights,
carried through numpy (``bridge.a3c_params_from_numpy``).  The networks,
one update and GOBI's gradient steps are f32 in both and held within 1e-6
(1e-5 after GOBI's ten steps) of each leaf's scale: the same products
summed in another order.  The seeded runs must equal JAX's in every
placement, decision and untimed metric, with the A3C weights within 1e-5
after the run.  As in ``tests/test_torch_sim.py``, tanh and softmax can
differ from XLA's in the last ulp, so a placement drawn from the policy
could differ only for a uniform draw within an ulp of an edge of its CDF;
the runs use UCB, whose decisions are exact, not Thompson, which the port
holds only in distribution.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.engine as jeng  # noqa: E402
import repro.sched.a3c as ja3c  # noqa: E402
import repro.sched.gobi as jgobi  # noqa: E402
import repro.sched.policies as jpol  # noqa: E402
import repro.sim.hosts as jhosts  # noqa: E402
import repro.sim.simulator as jsim  # noqa: E402
from repro.engine.sim_backend import SimBackend as JSim  # noqa: E402

import repro_torch.engine as teng  # noqa: E402
import repro_torch.sched.a3c as ta3c  # noqa: E402
import repro_torch.sched.gobi as tgobi  # noqa: E402
import repro_torch.sched.policies as tpol  # noqa: E402
import repro_torch.sim.hosts as thosts  # noqa: E402
import repro_torch.sim.simulator as tsim  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.engine.sim_backend import SimBackend as TSim  # noqa: E402

TIMING = {"sched_time_s", "sched_ms_per_decision", "place_time_s"}


def _close(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * (1 + float(np.abs(want).max())))


def _bridged(seed=0):
    """JAX's A3C weights for ``seed`` as numpy, and as the port's."""
    jp = ja3c.a3c_init(jax.random.PRNGKey(seed))
    return jp, bridge.a3c_params_from_numpy([np.asarray(x) for x in jp])


# ---------------------------------------------------------------- networks
def _episode(seed, T=5, n=7):
    rng = np.random.default_rng(seed)
    feats = rng.uniform(0, 1.5, (T, n, ta3c.N_FEATURES)).astype(np.float32)
    masks = rng.uniform(0, 1, (T, n)) > 0.4
    masks[:, 0] |= ~masks.any(1)
    actions = np.array([rng.choice(np.flatnonzero(m)) for m in masks],
                       np.int32)
    return feats, actions, masks


def test_a3c_init_surface():
    jp, _ = _bridged()
    tp = ta3c.a3c_init(torch.Generator().manual_seed(0), "cpu")
    assert tp._fields == jp._fields
    for t, j in zip(tp, jp):
        assert tuple(t.shape) == j.shape and t.dtype == torch.float32
    for b in (tp.b1, tp.b2, tp.vb1, tp.vb2):
        assert not b.any()
    again = ta3c.a3c_init(torch.Generator().manual_seed(0), "cpu")
    assert all(torch.equal(a, b) for a, b in zip(tp, again))
    assert 0.2 < float(torch.cat([tp.w1.flatten(), tp.v1.flatten()]).std()) \
        < 0.4


@pytest.mark.parametrize("seed", [0, 1])
def test_a3c_networks_and_update_equal(seed):
    jp, tp = _bridged(seed)
    feats, actions, masks = _episode(seed)
    for f in feats:
        _close(ta3c.policy_logits(tp, torch.from_numpy(f)),
               ja3c.policy_logits(jp, jnp.asarray(f)), 1e-6)
        _close(ta3c.value(tp, torch.from_numpy(f)),
               ja3c.value(jp, jnp.asarray(f)), 1e-6)
    reward = 0.73
    want = ja3c.a3c_update(jp, jnp.asarray(feats), jnp.asarray(actions),
                           jnp.asarray(masks), reward)
    got = ta3c.a3c_update(tp, torch.from_numpy(feats),
                          torch.from_numpy(actions), torch.from_numpy(masks),
                          reward)
    for name, g, w, before in zip(jp._fields,
                                  bridge.a3c_params_to_numpy(got), want, jp):
        _close(g, w, 1e-6)
        # b2 shifts every logit alike: the softmax, so the loss, ignores it
        assert name == "b2" or not np.array_equal(g, before), name


# -------------------------------------------------------------------- GOBI
def test_gobi_gradient_and_steps_equal():
    rng = np.random.default_rng(0)
    for _ in range(5):
        n = int(rng.integers(2, 12))
        feats = np.stack([rng.integers(0, 5, n) / 4.0,
                          1.0 / rng.uniform(0.8, 1.2, n),
                          rng.uniform(0, 1, n),
                          (rng.uniform(0, 1, n) > 0.3).astype(float)],
                         1).astype(np.float32)
        work = np.float32(rng.uniform(0.2, 2.0))
        ram_frac = np.float32(rng.uniform(0.0, 0.5))
        jl = jnp.zeros((n,))
        tl = torch.zeros(n)
        args_j = (jnp.asarray(feats), jnp.asarray(work), jnp.asarray(ram_frac))
        args_t = (torch.from_numpy(feats), torch.tensor(work),
                  torch.tensor(ram_frac))
        _close(tgobi._grad(tl, *args_t), jgobi._grad(jl, *args_j), 1e-6)
        for _ in range(10):
            jl = jl - 1.0 * jgobi._grad(jl, *args_j)
            tl = tl - 1.0 * tgobi._grad(tl, *args_t)
        _close(tl, jl, 1e-5)


def test_gobi_picks_equal():
    """tests/test_perf_paths.py::test_gobi_prefers_fast_idle_hosts in both
    packages, then random containers on loaded testbeds."""
    class C:
        ram_mb = 200.0
        work = 1.0
    picks = {}
    for mod, hosts_mod, kw in ((jgobi, jhosts, {}),
                               (tgobi, thosts, {"device": "cpu"})):
        hosts = hosts_mod.make_testbed(4, seed=0)
        hosts[2].speed = 2.0
        g = mod.GOBIPlacement(**kw)
        out = [g.place(C(), hosts) for _ in range(5)]
        rng = np.random.default_rng(1)
        for _ in range(20):
            hosts = hosts_mod.make_testbed(10, seed=int(rng.integers(100)))
            for h in hosts:
                h.ram_used_mb = float(rng.uniform(0, h.ram_mb))
                h.containers = [None] * int(rng.integers(0, 5))
            c = C()
            c.ram_mb, c.work = float(rng.uniform(100, 3000)), \
                float(rng.uniform(0.2, 2.0))
            out.append(g.place(c, hosts))
        picks[mod] = out
    assert picks[tgobi] == picks[jgobi]
    assert picks[tgobi][:5] == [2] * 5


# ------------------------------------------------------------- seeded runs
class _Recorded:
    """A placement policy whose picks are recorded in order."""

    def __init__(self, inner):
        self.inner, self.picks = inner, []

    def place(self, container, hosts):
        self.picks.append(self.inner.place(container, hosts))
        return self.picks[-1]

    def on_complete(self, w):
        if hasattr(self.inner, "on_complete"):
            self.inner.on_complete(w)


def _a3c(pkg_a3c, seed=0):
    if pkg_a3c is ja3c:
        return ja3c.A3CPlacement(seed=seed)
    p = ta3c.A3CPlacement(seed=seed, device="cpu")
    p.params = _bridged(seed)[1]
    return p


def _sim_case(case, pkg):
    """One seeded run: (untimed metrics, decisions, picks, placement)."""
    a3c, gobi, pol, sim, eng, backend = pkg
    if case == "engine":
        place = _Recorded(_a3c(a3c))
        e = eng.PlacementEngine(eng.MABPolicy(bandit="ucb", placement=place),
                                backend(seed=1))
        m = e.run(eng.PoissonSource(rate=0.6, seed=3, sla_range=(0.5, 3.0)),
                  300)
        b = e.backend
        assert (b.host_ram_used <= b.host_ram_mb + 1e-6).all()
        decisions = list(e.stats.decisions)
    else:
        if case == "splitplace":
            place = _Recorded(_a3c(a3c))
            sched, seed = pol.SplitPlaceScheduler(place, bandit="ucb"), 2
        elif case == "compression":
            place = _Recorded(_a3c(a3c))
            sched, seed = pol.CompressionScheduler(place), 1
        else:
            kw = {} if gobi is jgobi else {"device": "cpu"}
            place = _Recorded(gobi.GOBIPlacement(**kw))
            sched, seed = pol.FixedDecisionScheduler(place, sim.SEMANTIC), 4
        s = sim.Simulator(sched, seed=seed)
        m = s.run(300 if case == "splitplace" else 200)
        for h in s.hosts:
            assert -1e-6 <= h.ram_used_mb <= h.ram_mb + 1e-6
        decisions = [(w.wid, w.decision, w.finish) for w in s.completed]
    m = {k: v for k, v in m.items() if k not in TIMING}
    return m, decisions, place.picks, place.inner


CASES = ("splitplace", "compression", "gobi", "engine")
JAX_PKG = (ja3c, jgobi, jpol, jsim, jeng, JSim)
PORT_PKG = (ta3c, tgobi, tpol, tsim, teng, TSim)


@pytest.fixture(scope="module")
def jax_runs():
    return {}


@pytest.mark.parametrize("case", CASES)
def test_seeded_runs_equal(jax_runs, case):
    if case not in jax_runs:
        jax_runs[case] = _sim_case(case, JAX_PKG)
    jm, jdec, jpicks, jplace = jax_runs[case]
    tm, tdec, tpicks, tplace = _sim_case(case, PORT_PKG)
    assert tpicks == jpicks and tdec == jdec and tm == jm
    assert tm["completed"] > 30 and len(tpicks) > 100
    if case == "splitplace":
        assert 0 < tm["decisions_semantic_frac"] < 1
    if case != "gobi":
        for name, t, j, init in zip(jplace.params._fields, tplace.params,
                                    jplace.params, _bridged()[0]):
            assert torch.isfinite(t).all()
            _close(t.numpy(), j, 1e-5)
            assert name == "b2" or not np.array_equal(t.numpy(), init), name
