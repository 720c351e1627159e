"""The port's Thompson-sampling and epsilon-greedy bandits against
``repro.core.mab``.

These two are held IN DISTRIBUTION, not bit for bit: the reference draws
from JAX's PRNG (threefry key splits, ``jax.random.beta``'s gamma sampler),
the port from an explicit ``numpy.random.Generator`` seeded from the
engine's seed.  Reproducing the reference's bits would be a port of its
PRNG, not of the bandits.  What is exact: the update rules (the same
float32 arithmetic), every deterministic limit (epsilon 0 is the greedy
arm), the draw count (one select per real request, none for padding) and
a seeded replay.  What is statistical: over 20 000 draws, the frequency
with which Thompson picks arm 1 for fixed (alpha, beta) pairs and
epsilon-greedy's explore rate are within 4 sigma of the reference's own
frequencies over 20 000 keys (sigma of a difference of two binomial
means).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import mab as jmab  # noqa: E402
from repro_torch.core import mab as tmab  # noqa: E402
from repro_torch.core.decision import SplitDecisionEngine  # noqa: E402
from repro_torch.engine import (SEMANTIC, MABPolicy, Outcome,  # noqa: E402
                                Request)
from repro_torch.launch import serve  # noqa: E402
from repro_torch.sched.baselines import LeastLoadedPlacement  # noqa: E402
from repro_torch.sched.policies import SplitPlaceScheduler  # noqa: E402

N = 20_000
F32 = np.float32


def _within_4_sigma(p_port, p_ref, n=N):
    p = (p_port + p_ref) / 2
    sigma = max(np.sqrt(p * (1 - p) * 2 / n), 1e-12)
    assert abs(p_port - p_ref) <= 4 * sigma, (p_port, p_ref, sigma)


def _jax_freq(select, state, ctx=0):
    keys = jax.random.split(jax.random.PRNGKey(0), N)
    arms = jax.jit(jax.vmap(lambda k: select(state, ctx, k)))(keys)
    return float(np.mean(np.asarray(arms)))


def _port_freq(select, state, seed=0, ctx=0):
    rng = np.random.default_rng(seed)
    return float(np.mean([select(state, ctx, rng) for _ in range(N)]))


# ------------------------------------------------------------ exact rules
@pytest.mark.parametrize("name", ["thompson", "egreedy"])
def test_updates_equal_jax(name):
    """One random stream of (ctx, arm, reward) updates, rewards outside
    [0, 1] included (Thompson clips them): equal states throughout."""
    jinit, _, jupd = jmab.BANDITS[name]
    tinit, _, tupd = tmab.BANDITS[name]
    js, ts = jinit(4), tinit(4)
    rng = np.random.default_rng(1)
    jupd = jax.jit(jupd)
    for _ in range(200):
        ctx, arm = int(rng.integers(4)), int(rng.integers(2))
        r = F32(rng.uniform(-0.2, 1.2))
        js = jupd(js, ctx, arm, jnp.float32(r))
        ts = tupd(ts, ctx, arm, r)
    for a, b in zip(ts, js):
        if name == "egreedy" and a is ts.means:
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6)
        else:
            np.testing.assert_array_equal(a, np.asarray(b))


def test_egreedy_eps0_is_greedy_eps1_uniform():
    state = tmab.eg_init(2, eps=0.0)
    state = tmab.eg_update(state, 0, 0, 0.9)
    state = tmab.eg_update(state, 0, 1, 0.2)
    rng = np.random.default_rng(0)
    assert all(tmab.eg_select(state, 0, rng) == 0 for _ in range(500))
    # an unseen arm is tried first, as the reference's inf score makes it
    state = tmab.eg_update(tmab.eg_init(2, eps=0.0), 1, 0, 0.9)
    assert all(tmab.eg_select(state, 1, rng) == 1 for _ in range(100))
    uniform = state._replace(eps=F32(1.0))
    _within_4_sigma(_port_freq(tmab.eg_select, uniform, ctx=1), 0.5)
    jstate = jmab.EGState(*(jnp.asarray(x) for x in uniform))
    _within_4_sigma(_port_freq(tmab.eg_select, uniform, ctx=1),
                    _jax_freq(jmab.eg_select, jstate, ctx=1))


# ------------------------------------------------------------ distribution
@pytest.mark.parametrize("alpha,beta", [((1.0, 1.0), (1.0, 1.0)),
                                        ((2.0, 3.0), (3.0, 2.0)),
                                        ((5.5, 2.0), (1.5, 4.0)),
                                        ((30.0, 31.0), (10.0, 10.0))])
def test_thompson_win_frequency_matches_jax(alpha, beta):
    one = lambda v: np.asarray([v], F32)
    tstate = tmab.TSState(one(alpha), one(beta))
    jstate = jmab.TSState(jnp.asarray(tstate.alpha), jnp.asarray(tstate.beta))
    _within_4_sigma(_port_freq(tmab.ts_select, tstate),
                    _jax_freq(jmab.ts_select, jstate))


@pytest.mark.parametrize("eps", [0.1, 0.3])
def test_egreedy_explore_rate_matches_jax(eps):
    """Arm 0 is greedy, so arm 1 comes only from exploration (eps / 2)."""
    tstate = tmab.eg_init(1, eps=eps)
    tstate = tmab.eg_update(tmab.eg_update(tstate, 0, 0, 0.8), 0, 1, 0.3)
    jstate = jmab.EGState(*(jnp.asarray(x) for x in tstate))
    port = _port_freq(tmab.eg_select, tstate)
    _within_4_sigma(port, _jax_freq(jmab.eg_select, jstate))
    _within_4_sigma(port, eps / 2)


# ------------------------------------------------------------ engine state
@pytest.mark.parametrize("bandit", ["thompson", "egreedy"])
def test_seeded_replay_identical(bandit):
    """Two engines from one seed make the same decisions on one
    decide / decide_many / observe stream; another seed does not."""
    def run(seed):
        eng = SplitDecisionEngine(3, bandit=bandit, n_ctx=6,
                                  ema_init_values=[2.6, 0.5, 3.1])
        state = eng.init(seed)
        rng = np.random.default_rng(4)
        arms = []
        for _ in range(40):
            apps = rng.integers(0, 3, 4)
            slas = rng.choice([0.05, 0.5, 2.0, 5.0], 4)
            a, c, state = eng.decide_many(state, apps, slas,
                                          np.ones(4, bool))
            arms += list(a)
            for app, sla, arm, ctx in zip(apps, slas, a, c):
                state = eng.observe(state, int(app), int(ctx), int(arm),
                                    float(rng.gamma(2.0, 0.3 * (1 + arm))),
                                    float(sla), 0.9)
        return arms
    assert run(3) == run(3)
    assert run(3) != run(4)


def test_decide_many_draws_once_per_real_request():
    """Padded rows draw nothing: after a padded wave the generator stands
    where ``n`` sequential decides leave it."""
    eng = SplitDecisionEngine(2, bandit="thompson")
    apps = np.asarray([0, 1, 0, 0, 0, 0, 0, 0])
    slas = np.ones(8, F32)
    valid = np.arange(8) < 3
    s1 = eng.init(7)
    arms, _, s1 = eng.decide_many(s1, apps, slas, valid)
    s2 = eng.init(7)
    seq = []
    for app in apps[:3]:
        arm, _, s2 = eng.decide(s2, int(app), 1.0)
        seq.append(arm)
    assert list(arms[:3]) == seq
    assert s1.rng.random() == s2.rng.random()


# ------------------------------------------------------------------ users
@pytest.mark.parametrize("bandit", ["ucb", "thompson", "egreedy"])
def test_mab_policy_learns_better_arm(bandit):
    """``MABPolicy`` fed outcomes where the semantic split meets the SLA
    and the layer split misses it comes to prefer the semantic arm."""
    policy = MABPolicy(bandit=bandit, seed=0, ema_init_values=[1.0] * 3)
    for i in range(300):
        req = Request(rid=i, app_id=0, sla_s=1.0)
        arm = policy.decide(req)
        lat = 0.5 if arm == SEMANTIC else 2.0
        policy.observe(Outcome(request=req, decision=arm, latency_s=lat,
                               queue_wait_s=0.0, accuracy=0.9,
                               finish_s=float(i)))
    picks = [policy.decide(Request(rid=1000 + i, app_id=0, sla_s=1.0))
             for i in range(50)]
    assert np.mean(np.asarray(picks) == SEMANTIC) > 0.7, picks


@pytest.mark.parametrize("bandit", ["ucb", "thompson", "egreedy"])
def test_splitplace_scheduler_learns_better_arm(bandit):
    """The simulator's ``SplitPlaceScheduler`` with each bandit: the same
    feedback stream as above, through its ``decide`` / ``observe``."""
    class W:
        def __init__(self, i):
            self.wid, self.app_id, self.sla = i, 0, 0.2
    sched = SplitPlaceScheduler(LeastLoadedPlacement(), bandit=bandit,
                                seed=0)
    for i in range(300):
        w = W(i)
        w.decision = sched.decide(w)
        w.response_time = 0.1 if w.decision == SEMANTIC else 5.0
        w.accuracy = 0.9
        sched.observe(w)
    picks = [sched.decide(W(1000 + i)) for i in range(50)]
    assert np.mean(np.asarray(picks) == SEMANTIC) > 0.7, picks


@pytest.mark.parametrize("bandit", ["thompson", "egreedy"])
def test_serve_cli_takes_the_sampling_bandits(bandit):
    out = serve.main(["--device", "cpu", "--bandit", bandit, "--batches",
                      "2", "--batch-size", "3", "--cache-len", "32"])
    assert out["completed"] == 6


def test_serve_cli_serves_xlstm_on_the_gang_path():
    """``--arch xlstm-125m`` (recurrent mixers) falls back to the gang
    path under ``decode="auto"``."""
    out = serve.main(["--device", "cpu", "--arch", "xlstm-125m", "--bandit",
                      "thompson", "--batches", "1", "--batch-size", "2",
                      "--cache-len", "16"])
    assert out["completed"] == 2
    assert out["batches"] >= 1 and out["decode_steps"] > 0
