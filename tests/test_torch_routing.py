"""Port cache-aware fleet routing (``engine/routing.py``, ``engine/fleet.py``
and the fleet-shared built-call cache) against the JAX package.

The routing layer is host numpy in both packages, so everything here is
exact: the ``PrefixIndex`` delta stream, the board's answers, the router's
choices and its learned weights.  The port's ``FleetBackend`` and JAX's, on
the same bridged weights, route the same requests to the same replicas and
emit the same tokens (guarded by the top-2 margin check of
``test_torch_scheduler``), with the same hit rate and sync counters.  The
router reads the clock (an SLA-tight request weighs load over affinity), so
both fleets run on one deterministic clock that each fleet step advances.
No test here launches a kernel.
"""
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.decode import paged_cache as jpc  # noqa: E402
from repro.engine import FixedPolicy as JFixed  # noqa: E402
from repro.engine import PlacementEngine as JPlacement  # noqa: E402
from repro.engine import Request as JRequest  # noqa: E402
from repro.engine import fleet as jfleet  # noqa: E402
from repro.engine import routing as jrouting  # noqa: E402
from repro.engine.jax_backend import JaxBackend  # noqa: E402
from repro.sched import baselines as jbase  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.decode import paged_cache as tpc  # noqa: E402
from repro_torch.engine import (LAYER, FixedPolicy,  # noqa: E402
                                PlacementEngine, Request, TorchBackend)
from repro_torch.engine import fleet as tfleet  # noqa: E402
from repro_torch.engine import routing as trouting  # noqa: E402
from repro_torch.sched import baselines as tbase  # noqa: E402

from test_routing import _assert_board_mirrors_indexes  # noqa: E402
from test_torch_paged import np_tree, port_cfg  # noqa: E402
from test_torch_scheduler import MARGIN, _min_margin  # noqa: E402

#: tests/test_routing.py::_run_fleet's fleet, on the LAYER arm only
FLEET = dict(cache_len=64, max_batch=4, decode="paged", block_size=8,
             scan_tokens=4, prefix_sharing=True, arms=(LAYER,))
TICK = 0.01            # clock advance per fleet step


# ------------------------------------------------------------ delta stream
def _delta_stream(pc, seed):
    """One seeded insert / retire / evict / re-insert / drop sequence over a
    small pool; returns the index's (op, chain_hash) stream."""
    rng = np.random.default_rng(seed)
    bs = 4
    index = pc.PrefixIndex(bs)
    alloc = pc.BlockAllocator(13, bs, on_evict=lambda b, k: index.drop(k))
    seen = []
    index.on_delta = lambda op, h: seen.append((op, h))
    heads = [rng.integers(0, 50, 3 * bs) for _ in range(3)]
    for _ in range(40):
        toks = np.concatenate([heads[int(rng.integers(3))],
                               rng.integers(0, 50, int(rng.integers(0, 9)))])
        n = len(toks) // bs
        ids = alloc.alloc(n)
        if ids is None:
            continue
        index.insert(toks[:n * bs], ids, alloc)
        alloc.free(ids)                 # retire: park evictable
        if rng.random() < 0.2:          # an explicit drop, sometimes twice
            key = (None, tuple(int(t) for t in heads[0][:bs]))
            index.drop(key)
            index.drop(key)
    return seen


@pytest.mark.parametrize("seed", range(3))
def test_delta_stream_equal(seed):
    j, t = _delta_stream(jpc, seed), _delta_stream(tpc, seed)
    assert t == j
    assert {op for op, _ in t} == {"add", "drop"}


# ------------------------------------------------------------------- board
def test_board_answers_equal():
    rng = np.random.default_rng(0)
    jb, tb = jrouting.CacheStatusBoard(4), trouting.CacheStatusBoard(4)
    hashes = [int(h) for h in rng.integers(0, 2 ** 40, 30)]
    for _ in range(400):
        r, h = int(rng.integers(4)), hashes[int(rng.integers(30))]
        op = "add" if rng.random() < 0.6 else "drop"
        jb.apply(r, op, h)
        tb.apply(r, op, h)
    for r in range(4):
        args = (r, int(rng.integers(0, 9)), int(rng.integers(0, 64)), 64)
        jb.update_load(*args)
        tb.update_load(*args)
    for _ in range(50):
        chain = [hashes[int(i)] for i in rng.integers(0, 30, 6)]
        np.testing.assert_array_equal(tb.match_hashes(chain),
                                      jb.match_hashes(chain))
    for h in hashes:
        assert tb.holders(h) == jb.holders(h)
    assert len(tb) == len(jb) and tb.stats() == jb.stats()
    np.testing.assert_array_equal(tb.free_frac, jb.free_frac)


# -------------------------------------------------------------- route math
def test_route_arrays_equal():
    rng = np.random.default_rng(1)
    jr, tr = jrouting.PrefixAwareRouter(), trouting.PrefixAwareRouter()
    picks = []
    for i in range(200):
        n = int(rng.integers(1, 9))
        kw = dict(overlap_frac=rng.uniform(0, 1, n) * (rng.random(n) < 0.5),
                  queue_depth=rng.integers(0, 6, n),
                  free_frac=rng.uniform(0, 1, n),
                  slack_s=float(rng.uniform(-1, 5)),
                  feasible=rng.random(n) < 0.8, wid=i)
        picks.append(tr.route_arrays(**kw))
        assert picks[-1] == jr.route_arrays(**kw)
    assert None in picks and len(set(picks)) > 3
    assert tr.stats() == jr.stats()


def test_learning_router_equal():
    """The UCB weight learner: the same arm sequence and ``route_weights``
    for the same reward stream."""
    rng = np.random.default_rng(2)
    jr = jrouting.PrefixAwareRouter(learn=True, ucb_c=0.5)
    tr = trouting.PrefixAwareRouter(learn=True, ucb_c=0.5)

    class _Out:
        def __init__(self, wid, reward):
            self.wid, self.reward = wid, reward

    for i in range(200):
        kw = dict(overlap_frac=rng.uniform(0, 1, 3),
                  queue_depth=rng.integers(0, 4, 3),
                  free_frac=[0.5] * 3, slack_s=5.0, wid=i)
        idx = tr.route_arrays(**kw)
        assert idx == jr.route_arrays(**kw)
        assert tr._pending_arm[i] == jr._pending_arm[i]
        reward = float(kw["overlap_frac"][idx])
        tr.on_complete(_Out(i, reward))
        jr.on_complete(_Out(i, reward))
    np.testing.assert_array_equal(tr._counts, jr._counts)
    np.testing.assert_array_equal(tr._values, jr._values)
    assert tr.stats() == jr.stats()
    assert tuple(tr.stats()["route_weights"]) in trouting.WEIGHT_GRID


# -------------------------------------------------------------- real fleet
@contextlib.contextmanager
def _step_clock(fleet_cls, backend_cls):
    """One deterministic clock for a fleet and its replicas: ``now`` reads a
    counter that every fleet step advances by ``TICK``."""
    clock = {"t": 0.0}
    step = fleet_cls.step

    def ticking(self, policy=None):
        clock["t"] += TICK
        return step(self, policy)

    now = property(lambda self: clock["t"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fleet_cls, "now", now)
        mp.setattr(backend_cls, "now", now)
        mp.setattr(fleet_cls, "step", ticking)
        yield


def _fleet_reqs(mk, vocab, n, n_families=4, seed=3, head_blocks=6, bs=8):
    """tests/test_routing.py::_fleet_reqs."""
    rng = np.random.default_rng(seed)
    heads = [rng.integers(0, vocab, head_blocks * bs).astype(np.int32)
             for _ in range(n_families)]
    return [mk(rid=i, app_id=int(rng.integers(3)),
               tokens=np.concatenate(
                   [heads[int(rng.integers(n_families))],
                    rng.integers(0, vocab, 3).astype(np.int32)]),
               sla_s=4.0, max_new=2)
            for i in range(n)]


def _drive(fleet, engine_cls, policy, mk, vocab, *, n=12, passes=2,
           check_sync=False):
    """tests/test_routing.py::_run_fleet's load: waves of 3, one step
    after each, then drain; the second pass hits warm caches."""
    eng = engine_cls(policy, fleet)
    for _ in range(passes):
        reqs = _fleet_reqs(mk, vocab, n)
        for i in range(0, n, 3):
            eng.submit(reqs[i:i + 3])
            eng.step()
            if check_sync:
                _assert_board_mirrors_indexes(fleet)
        for _ in range(500):
            if not fleet.pending():
                break
            eng.step()
            if check_sync:
                _assert_board_mirrors_indexes(fleet)
        assert not fleet.pending(), "the fleet made no progress"
    return eng, reqs


def _placement(which, board, mod_routing, mod_base):
    return mod_routing.PrefixAwareRouter(board) if which == "routed" \
        else mod_base.RandomPlacement(3)


SYNC_KEYS = ("completed", "prefix_hit_rate", "sync_deltas", "tracked_hashes",
             "route_expected_overlap", "routed", "prefill_calls",
             "decode_dispatches", "decoded_tokens", "cow_copies")


@pytest.fixture(scope="module")
def jax_fleets(tiny_cfg, tiny_mesh):
    """JAX ``FleetBackend`` runs under the router and under
    ``RandomPlacement(3)`` on the step clock, with the weights every
    replica drew."""
    runs = {}
    with _step_clock(jfleet.FleetBackend, JaxBackend):
        for which in ("routed", "random"):
            fleet = jfleet.FleetBackend(tiny_cfg, tiny_mesh, n_replicas=2,
                                        **FLEET)
            policy = JFixed(LAYER, placement=_placement(
                which, fleet.board, jrouting, jbase))
            eng, reqs = _drive(fleet, JPlacement, policy, JRequest,
                               tiny_cfg.vocab_size)
            runs[which] = (fleet, eng.summary(), reqs)
    rep = runs["routed"][0].replicas[0]
    return runs, rep.runners[LAYER].model, rep.params[LAYER]


@pytest.mark.parametrize("which", ["routed", "random"])
def test_fleet_matches_jax(tiny_cfg, jax_fleets, which):
    runs, jmodel, jparams = jax_fleets
    jf, jm, jreqs = runs[which]
    with _step_clock(tfleet.FleetBackend, TorchBackend):
        fleet = tfleet.FleetBackend(port_cfg(tiny_cfg), n_replicas=2,
                                    device="cpu", **FLEET)
        # one shared model per arm: loading it once loads every replica
        bridge.load_params(fleet.jit_cache[LAYER]["model"], np_tree(jparams))
        policy = FixedPolicy(LAYER, placement=_placement(
            which, fleet.board, trouting, tbase))
        eng, treqs = _drive(fleet, PlacementEngine, policy, Request,
                            tiny_cfg.vocab_size)
    tm = eng.summary()
    assert fleet.routed_per_replica.tolist() == \
        jf.routed_per_replica.tolist()
    assert min(fleet.routed_per_replica) > 0
    for j, t in zip(jreqs, treqs):
        np.testing.assert_array_equal(t.output, j.output)
    lanes = [type("L", (), {"req": r, "out": list(r.output)})
             for r in jreqs]
    assert _min_margin(jmodel, jparams, lanes) > MARGIN
    for key in SYNC_KEYS:
        assert tm.get(key) == jm.get(key), key
    assert tm["routed_per_replica"] == jm["routed_per_replica"]
    if which == "routed":
        assert tm["route_expected_overlap"] > 0
        assert tm["prefix_hit_rate"] > runs["random"][1]["prefix_hit_rate"]


def test_fleet_sync_under_eviction(tiny_cfg):
    """Undersized pools force LRU eviction mid-run: the board mirrors the
    union of the replicas' indexes after every step, and drops happen."""
    kw = dict(FLEET, num_blocks=1 + 14)
    fleet = tfleet.FleetBackend(port_cfg(tiny_cfg), n_replicas=2,
                                device="cpu", **kw)
    policy = FixedPolicy(LAYER,
                         placement=trouting.PrefixAwareRouter(fleet.board))
    eng, _ = _drive(fleet, PlacementEngine, policy, Request,
                    tiny_cfg.vocab_size, check_sync=True)
    m = eng.summary()
    assert m["completed"] == 24
    live = sum(sum(o.values()) for o in fleet.board._owners.values())
    drops = (m["sync_deltas"] - live) // 2
    assert drops > 0


# -------------------------------------------------------- shared built calls
def _serve(backend, reqs):
    eng = PlacementEngine(FixedPolicy(LAYER, placement=None), backend)
    eng.submit(reqs)
    eng.drain()
    return eng.summary()


def test_jit_cache_shares_models_and_calls(tiny_cfg):
    """Replicas of one arm share the arm's model and built calls: the
    bucket replica 0 built is a hit on replica 2."""
    fleet = tfleet.FleetBackend(port_cfg(tiny_cfg), n_replicas=3,
                                device="cpu", **FLEET)
    shared = fleet.jit_cache[LAYER]
    scheds = [rep._paged[LAYER] for rep in fleet.replicas]
    assert all(rep.models[LAYER] is shared["model"]
               for rep in fleet.replicas)
    assert all(s._built is shared for s in scheds)
    for i in (0, 2):
        m = _serve(fleet.replicas[i],
                   _fleet_reqs(Request, tiny_cfg.vocab_size, 6))
        assert m["completed"] == 6
    s0, s2 = scheds[0].compile_stats, scheds[2].compile_stats
    assert s0["prefill_misses"] > 0 and s0["decode_misses"] > 0
    assert s2 and not any(k.endswith("_misses") for k in s2)
    assert s2["prefill_hits"] > 0 and s2["decode_hits"] > 0
    assert scheds[1].compile_stats == {}
    # the fleet's merged stats count every bucket's build once
    fm = fleet.extra_metrics()
    built = sum(1 for k in shared if isinstance(k, tuple)
                and k[0] in ("prefill", "decode", "cow"))
    assert sum(fm.get(f"compile_{k}_misses", 0)
               for k in ("prefill", "decode", "cow")) == built
    assert fm["batches"] == fm["decode_steps"] == 0


def test_jit_cache_weight_quant_fleet_equals_single(tiny_cfg):
    """A weight-quantized fleet shares one quantized copy and emits the
    tokens a single weight-quantized backend emits."""
    cfg = port_cfg(tiny_cfg)
    kw = dict(FLEET, weight_quant="int8")
    single = TorchBackend(cfg, device="cpu", **kw)
    sreqs = _fleet_reqs(Request, tiny_cfg.vocab_size, 8)
    assert _serve(single, sreqs)["completed"] == 8
    fleet = tfleet.FleetBackend(cfg, n_replicas=2, device="cpu", **kw)
    freqs = _fleet_reqs(Request, tiny_cfg.vocab_size, 8)
    eng = PlacementEngine(
        FixedPolicy(LAYER, placement=tbase.RoundRobinPlacement()), fleet)
    eng.submit(freqs)
    eng.drain()
    assert fleet.routed_per_replica.tolist() == [4, 4]
    for s, f in zip(sreqs, freqs):
        np.testing.assert_array_equal(f.output, s.output)
    p0, p1 = (rep._paged[LAYER].params for rep in fleet.replicas)
    assert p0 is p1
    m = eng.summary()
    assert m["weight_quant_bits"] == 8
    assert m["weight_quant_max_err"] == \
        single.extra_metrics()["weight_quant_max_err"]


def test_disagg_replica_fleet(tiny_cfg):
    """Replicas running ``fleet="disagg"``: every request completes, and
    the fleet merges the replicas' cache-store stats."""
    kw = dict(FLEET, fleet="disagg")
    fleet = tfleet.FleetBackend(port_cfg(tiny_cfg), n_replicas=2,
                                device="cpu", **kw)
    policy = FixedPolicy(LAYER,
                         placement=trouting.PrefixAwareRouter(fleet.board))
    eng, reqs = _drive(fleet, PlacementEngine, policy, Request,
                       tiny_cfg.vocab_size, check_sync=True)
    m = eng.summary()
    assert m["completed"] == 24 and all(r.output.shape == (2,)
                                        for r in reqs)
    stores = [st for rep in fleet.replicas for _, _, st in
              rep._disagg.values()]
    assert len(stores) == 2
    shipped = [st.stats()["blocks_shipped"] for st in stores]
    assert all(n > 0 for n in shipped)
    assert m["blocks_shipped"] == sum(shipped)
    assert m["transfer_bytes"] == m["blocks_shipped"] * m["kv_block_bytes"]
    assert m["ship_latency_p50"] >= 0.0
    # each replica's prefill and decode indexes both stream to the board
    assert len(fleet._wired) == 4
    for rep in fleet.replicas:
        for pf, dc, st in rep._disagg.values():
            assert pf.alloc.used_blocks == dc.alloc.used_blocks == 0
            assert st.backlog == 0


def test_fleet_runs_on_the_backend_device(tiny_cfg, monkeypatch):
    """The fleet's replicas take its device: asking for the card where
    there is none raises, as ``TorchBackend`` does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tfleet.FleetBackend(port_cfg(tiny_cfg), n_replicas=2)
