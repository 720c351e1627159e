"""Port disaggregated serving (``fleet="disagg"``: a prefill worker, a
decode worker and the ``CacheStore`` between them) against the JAX package.

``TorchBackend(fleet="disagg")`` and ``JaxBackend(fleet="disagg")`` on the
same bridged weights must give the same token streams on both arms and
both pool layouts, guarded by the top-2 margin check of
``test_torch_scheduler`` (1e-3, ten times the f32 logit tolerance), and the
same ship and scheduler counters.  The block moves and the ledger are
exact: ``gather_blocks`` / ``scatter_blocks`` bit-equal to JAX's on f32 and
int8 pools, ``RequestBlockBuffer`` giving the same answers to the same op
sequence.  The rest holds the port to the invariants of
``tests/test_cache_store.py``: disagg equals colocated, receiver prefix
hits ship nothing, a lost wave requeues and ends with clean-run tokens,
the role guards raise.  No test here launches a kernel.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.decode import RequestBlockBuffer as JBuffer  # noqa: E402
from repro.decode import paged_cache as jpc  # noqa: E402
from repro.engine import FixedPolicy as JFixed  # noqa: E402
from repro.engine import PlacementEngine as JPlacement  # noqa: E402
from repro.engine import Request as JRequest  # noqa: E402
from repro.engine.jax_backend import JaxBackend  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.decode import (NULL_BLOCK, BlockAllocator,  # noqa: E402
                                CacheStore, PagedArmScheduler,
                                RequestBlockBuffer, gather_blocks,
                                scatter_blocks)
from repro_torch.engine import (LAYER, SEMANTIC, FixedPolicy,  # noqa: E402
                                PlacementEngine, Request, TorchBackend)

from test_torch_paged import np_tree, port_cfg  # noqa: E402
from test_torch_scheduler import MARGIN, _min_margin  # noqa: E402

ARMS = [LAYER, SEMANTIC]
ARM_IDS = ["layer", "semantic"]
FLEET = dict(cache_len=32, max_batch=4, block_size=4, scan_tokens=4,
             prefill_chunk=4)


@pytest.fixture(scope="module")
def jax_weights(tiny_cfg, tiny_mesh):
    """Both arms' JAX backend weights (the init every JaxBackend of this
    config and seed draws), as numpy trees, with the backend."""
    jb = JaxBackend(tiny_cfg, tiny_mesh, cache_len=16, arms=(LAYER, SEMANTIC))
    return jb, {arm: np_tree(jb.params[arm]) for arm in ARMS}


def _port(tiny_cfg, weights, arm, **kw):
    tb = TorchBackend(port_cfg(tiny_cfg), device="cpu", arms=(arm,), **kw)
    bridge.load_params(tb.models[arm], weights[arm])
    return tb


def _requests(mk, vocab, seed=11, n=7):
    """Prompts of 6-13 tokens; the first and the last three open with one
    8-token head (two full blocks), so the receiver's index gets hits."""
    rng = np.random.default_rng(seed)
    head = rng.integers(0, vocab, 8)
    reqs = []
    for i in range(n):
        toks = rng.integers(0, vocab, int(rng.integers(6, 14)))
        if i == 0 or i >= n - 3:
            toks = np.concatenate([head, toks[:int(rng.integers(1, 6))]])
        reqs.append(mk(rid=i, app_id=int(rng.integers(0, 3)),
                       tokens=toks.astype(np.int32),
                       sla_s=float(rng.uniform(0.5, 4.0)),
                       max_new=int(rng.integers(2, 8))))
    return reqs


def _serve(backend, policy_cls, engine_cls, reqs, arm):
    eng = engine_cls(policy_cls(arm, placement=None), backend)
    eng.submit(reqs)
    eng.drain()
    return eng


@pytest.mark.parametrize("kv", ["f32", "int8"])
@pytest.mark.parametrize("arm", ARMS, ids=ARM_IDS)
def test_disagg_matches_jax(tiny_cfg, tiny_mesh, jax_weights, arm, kv):
    jb0, weights = jax_weights
    kw = dict(FLEET, fleet="disagg", kv_dtype=kv)
    jb = JaxBackend(tiny_cfg, tiny_mesh, arms=(arm,), **kw)
    tb = _port(tiny_cfg, weights, arm, **kw)
    jreqs = _requests(JRequest, tiny_cfg.vocab_size)
    treqs = _requests(Request, tiny_cfg.vocab_size)
    je = _serve(jb, JFixed, JPlacement, jreqs, arm)
    te = _serve(tb, FixedPolicy, PlacementEngine, treqs, arm)
    for j, t in zip(jreqs, treqs):
        assert t.output.shape == (t.max_new,)
        np.testing.assert_array_equal(t.output, j.output)
    lanes = [type("L", (), {"req": r, "out": list(r.output)})
             for r in jreqs]
    assert _min_margin(jb0.runners[arm].model, jb0.params[arm],
                       lanes) > MARGIN
    jm, tm = je.summary(), te.summary()
    assert tm["completed"] == len(treqs)
    assert tm["blocks_shipped"] > 0 and tm["ship_skipped_blocks"] > 0
    for key in ("blocks_shipped", "transfer_bytes", "ship_skipped_blocks",
                "prefill_calls", "decode_dispatches", "decoded_tokens",
                "prefix_hit_rate", "preemptions", "kv_block_bytes"):
        assert tm[key] == jm[key], key


@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_disagg_matches_colocated(tiny_cfg, jax_weights, kv):
    """As tests/test_cache_store.py:321: on one device the ship is a
    gather/scatter between the two pools, and the tokens equal the
    colocated scheduler's; the ship telemetry flows through EngineStats."""
    _, weights = jax_weights
    outs = {}
    for fleet in (None, "disagg"):
        tb = _port(tiny_cfg, weights, LAYER, fleet=fleet, kv_dtype=kv,
                   **FLEET)
        reqs = _requests(Request, tiny_cfg.vocab_size)
        eng = _serve(tb, FixedPolicy, PlacementEngine, reqs, LAYER)
        outs[fleet] = [r.output for r in reqs]
        m = eng.summary()
        assert m["completed"] == len(reqs)
    for a, b in zip(outs[None], outs["disagg"]):
        np.testing.assert_array_equal(a, b)
    assert m["transfer_bytes"] == m["blocks_shipped"] * m["kv_block_bytes"]
    assert all(0 < r.ttft_s <= r.latency_s + 1e-9 for r in reqs)
    assert eng.stats.blocks_shipped == m["blocks_shipped"]
    assert eng.stats.transfer_bytes == m["transfer_bytes"]
    assert m["overlap_steps"] > 0 and 0.0 <= m["ship_overlap_frac"] <= 1.0
    assert m["ship_latency_p50"] >= 0.0
    pf, dc, store = tb._disagg[LAYER]
    assert (pf.role, dc.role) == ("prefill", "decode")
    assert pf.alloc.used_blocks == 0 and dc.alloc.used_blocks == 0
    assert store.backlog == 0
    # the prefill worker only prefills, the decode worker only decodes
    assert pf.decode_dispatches == 0 and dc.prefill_chunks == 0


# ----------------------------------------------------------- block moves
def _pool(rng, kv, lead):
    """A random numpy pool of the reference layout: KV [*lead, P, bs, K,
    hd]; int8 adds f32 scales [*lead, P, bs, K]."""
    p, bs, k, hd = 9, 4, 2, 8
    out = {}
    for name in ("pos0", "pos1"):
        shape = lead + (p, bs, k, hd)
        if kv == "int8":
            out[name] = {
                "k": rng.integers(-127, 128, shape).astype(np.int8),
                "k_scale": rng.random(shape[:-1]).astype(np.float32),
                "v": rng.integers(-127, 128, shape).astype(np.int8),
                "v_scale": rng.random(shape[:-1]).astype(np.float32)}
        else:
            out[name] = {"k": rng.standard_normal(shape).astype(np.float32),
                         "v": rng.standard_normal(shape).astype(np.float32)}
    return out


@pytest.mark.parametrize("lead", [(2,), (2, 3)], ids=["layer", "semantic"])
@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_gather_scatter_bit_equal_to_jax(kv, lead):
    rng = np.random.default_rng(4)
    src, dst = _pool(rng, kv, lead), _pool(rng, kv, lead)
    # a 5-block wave padded to 8 with null-block pairs
    sids = np.array([3, 1, 7, 8, 2, 0, 0, 0], np.int32)
    dids = np.array([5, 6, 2, 4, 8, 0, 0, 0], np.int32)
    jout = jpc.scatter_blocks(
        jax_tree(dst), jpc.gather_blocks(jax_tree(src), jnp.asarray(sids)),
        jnp.asarray(dids))
    tsrc, tdst = bridge.pool_from_numpy(src), bridge.pool_from_numpy(dst)
    payload = gather_blocks(tsrc, torch.from_numpy(sids))
    tout = scatter_blocks(tdst, payload, torch.from_numpy(dids))
    assert tout is tdst                                  # in place
    for name in src:
        for leaf, want in src[name].items():
            axis = want.ndim - (3 if leaf.endswith("_scale") else 4)
            got = tout[name][leaf].numpy()
            assert got.dtype == want.dtype
            # every block but the null one (garbage by design) as JAX's
            np.testing.assert_array_equal(
                np.delete(got, NULL_BLOCK, axis),
                np.delete(np.asarray(jout[name][leaf]), NULL_BLOCK, axis))
            # the payload is the source blocks verbatim, codes and scales
            np.testing.assert_array_equal(
                np.take(payload[name][leaf].numpy(), np.arange(5), axis),
                np.take(want, sids[:5], axis))


def jax_tree(tree):
    return {k: jax_tree(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in tree.items()}


# --------------------------------------------------------------- ledger
class _StubLane:
    def __init__(self, rid, deadline=0.0):
        self.req = type("R", (), {"rid": rid})()
        self.deadline = deadline


def _call(buf, op, *args, **kw):
    """(result, error type) of one ledger call, with shipments reduced to
    comparable tuples."""
    try:
        out = getattr(buf, op)(*args, **kw)
    except ValueError as e:
        return "ValueError", str(e)
    if isinstance(out, list):
        return [(s.lane.req.rid, sorted(s.dst_blocks), s.n_shared,
                 sorted(s.expected), sorted(s.arrived), s.deadline,
                 s.attempt) for s in out]
    if hasattr(out, "attempt"):
        return out.attempt, out.complete
    return out


@pytest.mark.parametrize("seed", range(3))
def test_request_block_buffer_matches_jax(seed):
    """Random open / mark (current, stale and foreign) / pop_ready /
    pop_expired / pop_all / peek / clear sequences: the same answers, the
    same errors and the same stale-mark count from both ledgers."""
    rng = np.random.default_rng(seed)
    jbuf, tbuf = JBuffer(), RequestBlockBuffer()
    opened = {}
    now = 0.0
    for _ in range(300):
        now += 0.5
        rid = int(rng.integers(0, 6))
        op = rng.random()
        if op < 0.3:
            ids = sorted(rng.choice(np.arange(0 if rng.random() < 0.05
                                              else 1, 20),
                                    int(rng.integers(1, 4)), replace=False))
            shared = int(rng.integers(0, 2))
            args = (_StubLane(rid), ids, shared, set(ids[shared:]),
                    now + float(rng.integers(1, 6)))
            calls = [("open", args, {"opened": now})]
            opened[rid] = ids[shared:]
        elif op < 0.6:
            ids = list(opened.get(rid, [1]))
            if rng.random() < 0.2:
                ids = ids + [99]                 # foreign: a protocol error
            elif ids and rng.random() < 0.5:
                ids = ids[:1]                    # a partial arrival
            att = [None, int(rng.integers(0, 3))][int(rng.random() < 0.7)]
            calls = [("mark", (rid, ids), {"attempt": att})]
        elif op < 0.75:
            calls = [("pop_ready", (), {})]
        elif op < 0.9:
            calls = [("pop_expired", (now,), {})]
        elif op < 0.94:
            calls = [("pop_all", (), {})]
        elif op < 0.97:
            calls = [("peek_attempt", (rid,), {})]
        else:
            calls = [("clear_attempt", (rid,), {})]
        for name, args, kw in calls:
            assert _call(tbuf, name, *args, **kw) == \
                _call(jbuf, name, *args, **kw), (name, args, kw)
        assert len(tbuf) == len(jbuf)
        assert tbuf.stale_marks == jbuf.stale_marks
        assert tbuf.earliest_deadline() == jbuf.earliest_deadline()


# --------------------------------------------------------- store behaviour
def test_receiver_prefix_hit_skips_transfer(tiny_cfg, jax_weights):
    """A second identical prompt, an exact block multiple, finds ALL its
    blocks in the receiver's index: nothing ships, the tokens match."""
    _, weights = jax_weights
    tb = _port(tiny_cfg, weights, LAYER, fleet="disagg", **FLEET)
    eng = PlacementEngine(FixedPolicy(LAYER, placement=None), tb)
    store = tb._disagg[LAYER][2]
    prompt = np.random.default_rng(3).integers(
        0, tiny_cfg.vocab_size, 8).astype(np.int32)        # 8 % 4 == 0
    r1 = Request(rid=0, app_id=0, tokens=prompt, sla_s=5.0, max_new=5)
    eng.submit([r1])
    eng.drain()
    cold = store.blocks_shipped
    assert cold >= 2
    r2 = Request(rid=1, app_id=0, tokens=prompt.copy(), sla_s=5.0, max_new=5)
    eng.submit([r2])
    eng.drain()
    assert store.blocks_shipped == cold                  # nothing moved
    assert store.ship_skipped_blocks >= 2
    np.testing.assert_array_equal(r1.output, r2.output)


def test_ship_timeout_requeues(tiny_cfg, jax_weights):
    """A lost wave (``drop_filter`` drops each request's first marks)
    expires, frees its receiver blocks and requeues the request, which
    re-prefills through the prefill worker's prefix cache and ends with the
    tokens of an undisturbed run."""
    _, weights = jax_weights
    outs = {}
    for drop in (False, True):
        tb = _port(tiny_cfg, weights, LAYER, fleet="disagg",
                   ship_timeout_s=0.0, **FLEET)
        store = tb._disagg[LAYER][2]
        if drop:
            lost = set()
            store.drop_filter = \
                lambda rid: rid not in lost and not lost.add(rid)
        reqs = _requests(Request, tiny_cfg.vocab_size, seed=7, n=4)
        m = _serve(tb, FixedPolicy, PlacementEngine, reqs, LAYER).summary()
        assert m["completed"] == len(reqs)
        if drop:
            assert m["ship_requeues"] >= len(reqs)
            assert m["ship_dropped_waves"] >= len(reqs)
            assert m["re_executions"] >= len(reqs)
            assert m["prefix_hit_rate"] > 0
        else:
            assert m["ship_requeues"] == 0
        pf, dc, _ = tb._disagg[LAYER]
        assert pf.alloc.used_blocks == 0 and dc.alloc.used_blocks == 0
        outs[drop] = [r.output for r in reqs]
    for a, b in zip(outs[False], outs[True]):
        np.testing.assert_array_equal(a, b)


class _FakeSched:
    """A scheduler stand-in for poll-seating: a real allocator, a bounded
    seat count and a scripted evict_latest."""

    def __init__(self, role, *, free_lanes=0, victims=()):
        self.role = role
        self.block_size = 4
        self.kv_dtype = "f32"
        self.device = torch.device("cpu")
        self.prefix_sharing = False
        self.alloc = BlockAllocator(32, 4)
        self.free_lanes = free_lanes
        self.seated = []
        self._victims = list(victims)

    def has_free_lane(self):
        return len(self.seated) < self.free_lanes

    def admit_shipped(self, lane, now):
        self.seated.append(lane.req.rid)

    def evict_latest(self, deadline, now):
        if self._victims:
            self.free_lanes += 1
            return self._victims.pop(0)
        return None


class _ShipLane(_StubLane):
    def __init__(self, rid, deadline):
        super().__init__(rid, deadline)
        self.blocks = []
        self.n_shared = 0


@pytest.mark.parametrize("free_lanes,victims,seated,spills", [
    (3, (), [2, 1, 3], 0),          # same-poll arrivals seat by deadline
    (0, (), [], 0),                 # full receiver, nobody less urgent
    (0, (99,), [2], 1),             # a later-deadline seated lane spills
], ids=["deadline_order", "full_defers", "full_spills"])
def test_poll_seats_by_deadline(free_lanes, victims, seated, spills):
    dst = _FakeSched("decode", free_lanes=free_lanes,
                     victims=[_ShipLane(v, 50.0) for v in victims])
    requeued = []
    store = CacheStore(_FakeSched("prefill"), dst, timeout_s=5.0,
                       on_requeue=lambda lane: requeued.append(lane.req.rid))
    for rid, deadline in ((1, 5.0), (2, 1.0), (3, 5.0)):
        ids = dst.alloc.alloc(2)
        store.ledger.open(_ShipLane(rid, deadline), ids, 0, set(ids),
                          deadline=100.0)
        store.ledger.mark(rid, ids)
    assert store.poll(now=0.0) == len(seated)
    assert dst.seated == seated
    assert requeued == list(victims)
    assert store.decode_spills == spills
    assert store.backlog == 3 - len(seated)              # parked, not lost


# ---------------------------------------------------------------- guards
def test_role_guards(tiny_cfg, jax_weights):
    _, weights = jax_weights
    model = bridge.model_from_params(port_cfg(tiny_cfg), weights[LAYER])
    with pytest.raises(ValueError, match="role"):
        PagedArmScheduler(model, n_lanes=2, cache_len=16, role="router")
    dc = PagedArmScheduler(model, n_lanes=2, cache_len=16, block_size=4,
                           role="decode")
    with pytest.raises(RuntimeError, match="admit_shipped"):
        dc.try_join([], 0.0)
    pf = PagedArmScheduler(model, n_lanes=2, cache_len=16, block_size=4,
                           role="prefill")
    with pytest.raises(RuntimeError, match="non-decode"):
        pf.admit_shipped(None, 0.0)
    with pytest.raises(ValueError, match="prefill src"):
        CacheStore(dc, pf)
    # a prefill worker only needs the PROMPT to fit its pool
    long_gen = Request(rid=0, app_id=0, tokens=np.arange(8, dtype=np.int32),
                       sla_s=1.0, max_new=50)
    pf.validate(long_gen)
    with pytest.raises(ValueError, match="paged capacity"):
        dc.validate(long_gen)
    # pools on two devices make a two-device fleet: the store ships
    # between them (a copy a pool leaf a wave), and none on one device
    assert not CacheStore(pf, dc).fleet
    dc.device = torch.device("meta")
    store = CacheStore(pf, dc)
    assert store.fleet and store.stats()["ship_xdev_copies"] == 0


def test_distinct_fleet_devices_raise(tiny_cfg, monkeypatch):
    """The fleet's devices are resolved as the backend's is: a card that
    is not there raises (nothing moves to the CPU), and each arm takes a
    (prefill, decode) pair from the pool in the order the arms are built;
    an arm that finds fewer than two left colocates."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchBackend(port_cfg(tiny_cfg), device="cpu", fleet="disagg",
                     fleet_devices=("cpu", "cuda:1"))
    tb = TorchBackend(port_cfg(tiny_cfg), device="cpu", fleet="disagg",
                      fleet_devices=("cpu", "cpu", "cpu"),
                      arms=(LAYER, SEMANTIC), cache_len=16)
    assert set(tb._disagg) == {LAYER, SEMANTIC} and len(tb._fleet_pool) == 1
    with pytest.raises(ValueError, match="fleet"):
        TorchBackend(port_cfg(tiny_cfg), device="cpu", fleet="colocated")
    # naming the backend's own device is the same-device fleet
    tb = TorchBackend(port_cfg(tiny_cfg), device="cpu", fleet="disagg",
                      fleet_devices=("cpu", "cpu"), arms=(LAYER,),
                      cache_len=16)
    assert LAYER in tb._disagg and not tb._paged
