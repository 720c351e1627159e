"""The port's routed fleet across ranks (``FleetBackend`` on a process-group
mesh: rank 0 routes, runs every replica's engine and relays each
replica's device calls, the header naming the replica) and
``fleet_devices`` as ranks (``TorchBackend(fleet="disagg")`` with each
worker pinned whole to a rank, the KV ship crossing ranks), against the
JAX package's ``FleetBackend`` and ``JaxBackend(fleet="disagg")`` on one
device.

One world of two CPU processes builds a (2, 1) and a (1, 2) mesh and
serves there; the references run in this process meanwhile:

- ``fleet_model``: (1, 2), two colocated paged replicas under
  ``PrefixAwareRouter`` on JAX's weights; ``fleet_data``: (2, 1), two
  disaggregated replicas under ``RandomPlacement(3)``.  Rank 0's tokens,
  ``routed_per_replica``, sync and scheduler counters (ship counters too)
  equal JAX ``FleetBackend``'s on a 1 x 1 mesh, both fleets on one step
  clock, exactly; the replicas share the arm's runner, weights and built
  calls, and keep their own pools;
- ``pin_remote_prefill``: ``fleet_devices=(1, 0, 1, 0)`` on LAYER and
  SEMANTIC, on JAX's weights: tokens and the disaggregated test's
  counters equal ``JaxBackend(fleet="disagg")``'s (placement is
  transparent in the reference); rank 1 holds the prefill pools whole
  and rank 0 none of them; every shipped block lands on rank 0 bit for
  bit, and the bytes sent between the ranks are ``transfer_bytes``;
- ``pin_remote_decode``: ``fleet_devices=(0, 1)`` with int8 KV and int8
  weights (LAYER pinned, SEMANTIC on the runner's view), held to the
  port's one-process disaggregated run; int8 codes and their scales cross
  the ranks, and the decode worker's token CRC on rank 1 equals rank 0's,
  taken from the tokens it received.

In every case the follower's counts (dropped calls of a worker held on the
other rank included) equal rank 0's, and its stream CRC equals rank 0's
over the workers the follower holds (``stream_digest_for``).  Without a
world: entries of ``fleet_devices`` that are not ranks raise, and so does
a header naming a replica, an arm or a worker a rank does not hold.

The world runs under a 120 s limit, its process groups with a 60 s
timeout.  This file doubles as the worker: ``python
tests/test_torch_fleet_multi.py RANK DIR`` (it imports torch and the port
only).
"""
import contextlib
import json
import os
import pathlib
import subprocess
import sys
import time
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_disagg_multi import (COUNTERS, FOLLOWED, INT8,  # noqa: E402
                                     KW, _np_tree, _pool_bytes)
from test_torch_serve_multi import (_rank0_mesh, flat, make_cfg,  # noqa: E402
                                    port, serve_paged, unflat)

#: the fleets' replicas: the disaggregated cases' size, the LAYER arm only
FLEET_KW = dict(cache_len=32, max_batch=4, decode="paged", block_size=4,
                prefill_chunk=8, scan_tokens=4, arms=(0,))
TICK = 0.01            # clock advance per fleet step
#: name -> (mesh dims, what runs)
CASES = {"fleet_model": ((1, 2), "routed"),
         "fleet_data": ((2, 1), "random_disagg"),
         "pin_remote_prefill": ((1, 2), "pin_prefill"),
         "pin_remote_decode": ((1, 2), "pin_decode")}
PIN_ARMS = (0, 1)
#: the pinned cases' backends: the pool's (prefill, decode) rank pairs
PIN_KW = {"pin_prefill": dict(KW, arms=PIN_ARMS, fleet_devices=(1, 0, 1, 0)),
          "pin_decode": dict(KW, arms=PIN_ARMS, fleet_devices=(0, 1), **INT8)}
#: the fleets' routing and sync counters held to JAX's
SYNC_KEYS = ("completed", "prefix_hit_rate", "sync_deltas", "tracked_hashes",
             "route_expected_overlap", "routed", "prefill_calls",
             "decode_dispatches", "decoded_tokens", "cow_copies")
SHIP_KEYS = ("blocks_shipped", "ship_waves", "ship_skipped_blocks",
             "transfer_bytes")
WORLD_TIMEOUT_S = 120


@contextlib.contextmanager
def step_clock(fleet_cls, backend_cls):
    """One deterministic clock for a fleet and its replicas (either
    package's classes): ``now`` reads a counter that every fleet step
    advances by ``TICK`` (the router weighs SLA slack)."""
    clock = {"t": 0.0}
    step = fleet_cls.step

    def ticking(self, policy=None):
        clock["t"] += TICK
        return step(self, policy)

    saved = [(c, k, c.__dict__[k]) for c, k in
             ((fleet_cls, "now"), (backend_cls, "now"), (fleet_cls, "step"))]
    now = property(lambda self: clock["t"])
    fleet_cls.now, backend_cls.now, fleet_cls.step = now, now, ticking
    try:
        yield
    finally:
        for c, k, v in saved:
            setattr(c, k, v)


def fleet_reqs(mk, vocab, n=12, n_families=3, seed=3, head_blocks=4, bs=4):
    """``tests/test_torch_routing.py``'s request families at this size:
    shared 16-token heads, 3 tokens of tail, 2 new tokens."""
    rng = np.random.default_rng(seed)
    heads = [rng.integers(0, vocab, head_blocks * bs).astype(np.int32)
             for _ in range(n_families)]
    return [mk(rid=i, app_id=int(rng.integers(3)),
               tokens=np.concatenate(
                   [heads[int(rng.integers(n_families))],
                    rng.integers(0, vocab, 3).astype(np.int32)]),
               sla_s=4.0, max_new=2)
            for i in range(n)]


def serve_fleet(fleet, engine_cls, policy, mk, vocab, passes=2):
    """Two passes of the same requests (the second hits warm caches):
    waves of 3, one step after each, then drain (either package's
    classes).  Returns (each pass's tokens, the summary)."""
    eng = engine_cls(policy, fleet)
    tokens = []
    for _ in range(passes):
        reqs = fleet_reqs(mk, vocab)
        for i in range(0, len(reqs), 3):
            eng.submit(reqs[i:i + 3])
            eng.step()
        for _ in range(500):
            if not fleet.pending():
                break
            eng.step()
        assert not fleet.pending(), "the fleet made no progress"
        tokens.append([np.asarray(r.output).tolist() for r in reqs])
    return tokens, {k: v for k, v in eng.summary().items()
                    if not isinstance(v, dict)}


def fleet_policy(what, board, fixed, routing, baselines):
    placement = routing.PrefixAwareRouter(board) if what == "routed" \
        else baselines.RandomPlacement(3)
    return fixed(0, placement=placement)


def fleet_kw(what):
    return dict(FLEET_KW, **({"fleet": "disagg"} if "disagg" in what
                             else {}))


def _crc(tree) -> list:
    """CRC-32 of each leaf's bytes, in leaf order."""
    from repro_torch.decode.paged_cache import _leaves
    return [zlib.crc32(t.contiguous().view(torch.uint8).numpy().tobytes())
            for _, t in _leaves(tree)]


# =================================================================== worker
def _worker(rank: int, io: pathlib.Path) -> None:
    import torch.distributed as dist

    from repro_torch import bridge
    from repro_torch.configs.base import get_config
    from repro_torch.dist.api import RemoteView
    from repro_torch.engine import (FixedPolicy, PlacementEngine, Request,
                                    TorchBackend)
    from repro_torch.engine import routing
    from repro_torch.engine.fleet import FleetBackend
    from repro_torch.launch.mesh import init_mesh
    from repro_torch.sched import baselines
    torch.set_num_threads(1)
    store = dist.FileStore(str(io / "store"), 2)
    meshes = {dims: init_mesh(dims, backend="gloo", device="cpu",
                              store=store, rank=rank, world_size=2,
                              timeout_s=60) for dims in ((2, 1), (1, 2))}
    t0 = time.time()
    while not (io / "ready").exists():        # the weights, being drawn
        if time.time() - t0 > WORLD_TIMEOUT_S:
            raise TimeoutError("no weights written")
        time.sleep(0.05)
    weights = {a: bridge.tree_from_numpy(unflat(dict(np.load(
        io / f"w{a}.npz")))) for a in PIN_ARMS}
    cfg = make_cfg(get_config, "tiny")
    out = {}
    for name, (dims, what) in CASES.items():
        res = {}
        if what in ("routed", "random_disagg"):
            fleet = FleetBackend(cfg, mesh=meshes[dims], n_replicas=2,
                                 device="cpu", **fleet_kw(what))
            lead = fleet.replicas[0]
            lead.params[0] = lead.runners[0].shard(weights[0])
            _fleet_shares(fleet, res)
            if rank > 0:
                res["follow"] = fleet.follow()
            else:
                try:
                    with step_clock(FleetBackend, TorchBackend):
                        res["served"], res["summary"] = serve_fleet(
                            fleet, PlacementEngine, fleet_policy(
                                what, fleet.board, FixedPolicy, routing,
                                baselines), Request, cfg.vocab_size)
                    res["metrics"] = {
                        k: v for k, v in fleet.extra_metrics().items()
                        if not isinstance(v, dict)}
                    res["digest_for_1"] = fleet.stream_digest_for(1)
                finally:
                    fleet.close()
            res["built"] = _built_once(fleet)
        else:
            tb = TorchBackend(cfg, mesh=meshes[dims], device="cpu",
                              **PIN_KW[what])
            if what == "pin_prefill":
                for arm, (pf, dc, _) in tb._disagg.items():
                    for w in {id(w.model): w for w in (pf, dc)}.values():
                        if not isinstance(w.model, RemoteView):
                            bridge.load_params(w.model, weights[arm])
            res["ship"] = _watch_ships(tb)
            if rank > 0:
                res["follow"] = tb.follow()
            else:
                try:
                    res["served"] = {str(a): v for a, v in serve_paged(
                        tb, PlacementEngine, FixedPolicy, Request,
                        cfg.vocab_size, PIN_ARMS).items()}
                    res["metrics"] = {k: v for k, v in
                                      tb.extra_metrics().items()
                                      if not isinstance(v, dict)}
                    res["digest_for_1"] = tb.stream_digest_for(1)
                    res["unwound"] = [(pf.alloc.used_blocks,
                                       dc.alloc.used_blocks, st.backlog)
                                      for pf, dc, st in tb._disagg.values()]
                finally:
                    tb.close()
            res["transfer_bytes"] = {str(a): st.transfer_bytes for a, (
                _, _, st) in tb._disagg.items()}
            res["pins"] = {str(a): list(p) for a, p in tb._pins.items()}
            res["pools"] = {str(a): [[_pool_bytes(w.pool), all(
                t.is_meta for e in w.pool.values() for t in e.values())]
                for w in (pf, dc)] for a, (pf, dc, _) in tb._disagg.items()}
            res["dc_digest"] = {str(a): dc.token_digest
                                for a, (_, dc, _) in tb._disagg.items()}
            res["quant"] = {str(a): [w.quant_telemetry.get(
                "weight_quant_max_err") for w in (pf, dc)]
                for a, (pf, dc, _) in tb._disagg.items()}
        out[name] = res
    (io / f"e_{rank}.json").write_text(json.dumps(out))
    dist.destroy_process_group()


def _fleet_shares(fleet, res):
    """What the replicas share (each arm's runner, view and built calls;
    one params dict) and what each keeps (its pools)."""
    scheds = [[s for s in rep._all_scheds()] for rep in fleet.replicas]
    res["shares"] = dict(
        runner=len({id(r.runners[0]) for r in fleet.replicas}),
        params=len({id(r.params) for r in fleet.replicas}),
        view=len({id(s.model) for ss in scheds for s in ss}),
        built=len({id(s._built) for ss in scheds for s in ss}),
        pools=len({id(next(iter(s.pool.values()))["k"])
                   for ss in scheds for s in ss}),
        scheds=sum(len(ss) for ss in scheds))


def _built_once(fleet):
    """(buckets built fleet-wide, compile misses summed over the replicas'
    schedulers): equal when each bucket is built once."""
    built = {k for k in fleet.jit_cache[0] if isinstance(k, tuple)
             and k[0] in ("prefill", "decode", "cow")}
    misses = sum(v for rep in fleet.replicas for s in rep._all_scheds()
                 for k, v in s.compile_stats.items()
                 if k.endswith("_misses"))
    return [len(built), misses]


def _watch_ships(tb) -> list:
    """Wrap each pinned store's ``_ship``: per wave, the arm, the non-null
    blocks, the bytes this rank sent, the CRC-32 of each leaf of the
    wave's source blocks (on the prefill rank, before) and of its
    destination blocks (on the decode rank, after) and the leaves'
    dtypes."""
    from repro_torch.decode.paged_cache import NULL_BLOCK, gather_blocks
    from repro_torch.dist import comm
    waves = []
    for arm, (pf, dc, st) in tb._disagg.items():
        if st.pinned is None:
            continue

        def ship(wire, orig=st._ship, st=st, arm=arm):
            n = int(np.count_nonzero(wire[:, 0] != NULL_BLOCK))
            ids = torch.from_numpy(wire[:n].astype(np.int64))
            me, (src, dst) = st.mesh.rank, st.pinned
            rec = dict(arm=arm, n=n, src=None, dst=None)
            if me == src:
                payload = gather_blocks(st.src.pool, ids[:, 0])
                rec["src"] = _crc(payload)
                rec["dtypes"] = sorted({str(t.dtype) for e in
                                        payload.values()
                                        for t in e.values()})
            before = comm.COMM_STATS.get("send_bytes", 0.0)
            orig(wire)
            rec["sent"] = comm.COMM_STATS.get("send_bytes", 0.0) - before
            if me == dst:
                rec["dst"] = _crc(gather_blocks(st.dst.pool, ids[:, 1]))
            waves.append(rec)
        st._ship = ship
    return waves


# ==================================================================== tests
@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The world of two started, JAX's weights drawn and written while it
    starts, the references computed while it runs (JAX's fleets on the
    step clock, ``JaxBackend(fleet="disagg")``, the port's one-process
    int8 disaggregated run); then the ranks' results."""
    import jax

    from repro.configs.base import get_config
    from repro.engine import FixedPolicy as JFixed
    from repro.engine import PlacementEngine as JPlacement
    from repro.engine import Request as JRequest
    from repro.engine import fleet as jfleet
    from repro.engine import routing as jrouting
    from repro.engine.jax_backend import JaxBackend
    from repro.sched import baselines as jbase
    from repro_torch.engine import (FixedPolicy, PlacementEngine, Request,
                                    TorchBackend)
    io = tmp_path_factory.mktemp("fleet_multi")
    one = jax.make_mesh((1, 1), ("data", "model"))
    cfg = make_cfg(get_config, "tiny")
    vocab = cfg.vocab_size
    env = dict(os.environ, PYTHONPATH=str(pathlib.Path(__file__).resolve()
                                          .parents[1] / "src"),
               OMP_NUM_THREADS="1")
    procs, logs, t0 = [], [], time.time()
    for r in ("0", "1"):
        logs.append(io / f"log_{r}.txt")
        with open(logs[-1], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, __file__, r, str(io)], env=env,
                stdout=log, stderr=subprocess.STDOUT))
    kw = {k: v for k, v in PIN_KW["pin_prefill"].items()
          if k != "fleet_devices"}
    jb = JaxBackend(cfg, one, **kw)
    weights = {a: _np_tree(jb.params[a]) for a in PIN_ARMS}
    for a in PIN_ARMS:
        np.savez(io / f"w{a}.npz", **flat(weights[a]))
    (io / "ready").touch()

    refs = {"pin_prefill": serve_paged(jb, JPlacement, JFixed, JRequest,
                                       vocab, PIN_ARMS),
            "pin_prefill_metrics": jb.extra_metrics()}
    with step_clock(jfleet.FleetBackend, JaxBackend):
        for what in ("routed", "random_disagg"):
            fleet = jfleet.FleetBackend(cfg, one, n_replicas=2,
                                        **fleet_kw(what))
            assert all(np.array_equal(v, flat(weights[0])[k]) for k, v in
                       flat(_np_tree(fleet.replicas[0].params[0])).items())
            refs[what] = serve_fleet(fleet, JPlacement, fleet_policy(
                what, fleet.board, JFixed, jrouting, jbase), JRequest, vocab)
            refs[what + "_routed"] = fleet.routed_per_replica.tolist()
    kw8 = {k: v for k, v in PIN_KW["pin_decode"].items()
           if k != "fleet_devices"}
    one8 = TorchBackend(port(cfg), device="cpu", **kw8)
    refs["pin_decode"] = serve_paged(one8, PlacementEngine, FixedPolicy,
                                     Request, vocab, PIN_ARMS)
    refs["pin_decode_metrics"] = one8.extra_metrics()
    refs["pin_decode_quant"] = [w.quant_telemetry["weight_quant_max_err"]
                                for w in one8._disagg[0][:2]]

    for p in procs:
        try:
            p.wait(timeout=max(1.0, WORLD_TIMEOUT_S - (time.time() - t0)))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"the gloo world ran past {WORLD_TIMEOUT_S} s")
    bad = [log.read_text()[-3000:] for p, log in zip(procs, logs)
           if p.returncode]
    assert not bad, bad[0]
    ranks = [json.loads((io / f"e_{r}.json").read_text()) for r in (0, 1)]
    return ranks, refs


def _served(lead):
    """Rank 0's {arm: ({rid: tokens}, [(rid, decision)])}, keys as ints."""
    return {int(a): ({int(r): t for r, t in toks.items()},
                     [tuple(d) for d in dec])
            for a, (toks, dec) in lead["served"].items()}


@pytest.mark.parametrize("name", ["fleet_model", "fleet_data"])
def test_fleet_on_mesh_matches_jax(world, name):
    """Rank 0's fleet on the process-group mesh routes the requests to the
    replicas JAX's fleet routes them to and serves JAX's tokens, with its
    sync, scheduler and (disaggregated) ship counters, exactly."""
    ranks, refs = world
    lead = ranks[0][name]
    what = CASES[name][1]
    want_tokens, want = refs[what]
    assert lead["served"] == want_tokens
    m = lead["summary"]
    keys = SYNC_KEYS + (SHIP_KEYS if "disagg" in what else ())
    assert {k: m.get(k) for k in keys} == {k: want.get(k) for k in keys}
    assert m["routed_per_replica"] == refs[what + "_routed"] \
        == want["routed_per_replica"]
    assert min(m["routed_per_replica"]) > 0 and m["completed"] == 24
    assert lead["metrics"]["mesh"] == list(CASES[name][0])
    if what == "routed":
        assert m["route_expected_overlap"] > 0
    else:
        assert m["blocks_shipped"] > 0


@pytest.mark.parametrize("name", ["fleet_model", "fleet_data"])
def test_fleet_replicas_share_runner_weights_and_calls(world, name):
    """On every rank the replicas share the arm's runner, its paged view,
    one params dict and one built-call dict, and each bucket is built once
    fleet-wide; every scheduler keeps its own pool."""
    ranks, _ = world
    for rank in ranks:
        s = rank[name]["shares"]
        assert (s["runner"], s["params"], s["view"], s["built"]) == \
            (1, 1, 1, 1)
        assert s["pools"] == s["scheds"] == \
            (4 if "disagg" in CASES[name][1] else 2)
    lead = ranks[0][name]["built"]
    assert lead[0] == lead[1] > 0


@pytest.mark.parametrize("name", list(CASES))
def test_follower_matches_rank0(world, name):
    """The follower replayed every header rank 0 sent, on the replica and
    worker it names: its counts equal rank 0's (a worker pinned to rank 0
    counts the calls it dropped), and its stream CRC equals rank 0's over
    the workers it holds (all of them but in the pinned cases); rank 0
    sent a header a device call or ship wave."""
    ranks, _ = world
    lead, follower = ranks[0][name], ranks[1][name]["follow"]
    m = lead["metrics"]
    keys = FOLLOWED if "fleet" not in name or "disagg" in CASES[name][1] \
        else FOLLOWED[:4] + FOLLOWED[-1:]
    want = dict(m, stream_digest=lead["digest_for_1"])
    assert {k: follower[k] for k in keys} == {k: want[k] for k in keys}
    if "fleet" in name:
        assert lead["digest_for_1"] == m["stream_digest"] != 0
        assert len(follower["replicas"]) == 2
    else:
        assert lead["digest_for_1"] != m["stream_digest"]
    calls = m["prefill_chunks"] + m["decode_dispatches"] + \
        m.get("ship_waves", 0)
    assert 0 <= m["headers_sent"] - calls <= m["cow_copies"]


def test_pinned_prefill_matches_jax_backend(world):
    """``fleet_devices=(1, 0, 1, 0)``: both arms' prefill workers on rank
    1, decode workers on rank 0; rank 0's tokens, decisions and counters
    are ``JaxBackend(fleet="disagg")``'s on one device, receiver
    backpressure and prefix hits included, and the pools are unwound."""
    ranks, refs = world
    lead = ranks[0]["pin_remote_prefill"]
    assert _served(lead) == refs["pin_prefill"]
    m, want = lead["metrics"], refs["pin_prefill_metrics"]
    assert {k: m[k] for k in COUNTERS} == {k: want[k] for k in COUNTERS}
    assert want["decode_spills"] > 0 and want["ship_skipped_blocks"] > 0
    assert m["ship_xdev_copies"] == 2 * m["ship_waves"]
    assert lead["unwound"] == [[0, 0, 0], [0, 0, 0]]


def test_pinned_int8_matches_one_process(world):
    """``fleet_devices=(0, 1)`` with int8 KV and weights: LAYER's decode
    worker on rank 1, SEMANTIC on the runner's view (the pool ran out);
    rank 0's tokens, decisions, counters and quant error are the port's
    one-process disaggregated backend's, and rank 1's decode CRC of the
    pinned worker equals rank 0's, taken from the tokens it received."""
    ranks, refs = world
    lead, follower = (r["pin_remote_decode"] for r in ranks)
    assert _served(lead) == {int(a): ({int(r): t for r, t in toks.items()},
                                      [tuple(d) for d in dec])
                             for a, (toks, dec) in refs["pin_decode"].items()}
    m, m1 = lead["metrics"], refs["pin_decode_metrics"]
    assert {k: m[k] for k in COUNTERS} == {k: m1[k] for k in COUNTERS}
    assert m["weight_quant_max_err"] == m1["weight_quant_max_err"] > 0
    # the LAYER workers' own gauges, the remote decode worker's received
    # from rank 1
    assert lead["quant"]["0"] == refs["pin_decode_quant"]
    assert lead["pins"] == {"0": [0, 1]}
    assert lead["dc_digest"]["0"] == follower["dc_digest"]["0"] != 0


@pytest.mark.parametrize("name", ["pin_remote_prefill", "pin_remote_decode"])
def test_pinned_pools_on_their_ranks(world, name):
    """A pinned worker's whole pool is on its rank (the one-process pool's
    bytes) and on no other (the meta device there); an arm on the view
    holds its slices as before."""
    from repro_torch.configs.base import get_config
    from repro_torch.decode.paged_cache import quantize_pool
    from repro_torch.models.model import build_model
    ranks, _ = world
    what = CASES[name][1]
    cfg = make_cfg(get_config, "tiny")
    for r, rank in enumerate(ranks):
        res = rank[name]
        for arm, pair in res["pools"].items():
            c = cfg.semantic(2) if arm == "1" else cfg
            pool = build_model(port(c), device="meta").init_pool(
                KW["num_blocks"], KW["block_size"])
            whole = _pool_bytes(quantize_pool(pool) if what == "pin_decode"
                                else pool)
            pins = res["pins"].get(arm)
            for i, (nbytes, meta) in enumerate(pair):
                if pins is None:
                    assert (nbytes * 2, meta) == (whole, False), arm
                elif pins[i] == r:
                    assert (nbytes, meta) == (whole, False), arm
                else:
                    assert meta, arm


@pytest.mark.parametrize("name", ["pin_remote_prefill", "pin_remote_decode"])
def test_pinned_ship_crosses_ranks_bit_for_bit(world, name):
    """Each wave between pinned workers leaves the prefill rank as the
    wave's source blocks and lands in the decode rank's pool bit for bit
    (every leaf; int8 codes and scales in the int8 case), and the bytes
    sent between the ranks are rank 0's ``transfer_bytes``."""
    ranks, _ = world
    src_rank = 1 if name == "pin_remote_prefill" else 0
    src, dst = ranks[src_rank][name]["ship"], ranks[1 - src_rank][name]["ship"]
    assert len(src) == len(dst) > 0
    for a, b in zip(src, dst):
        assert a["arm"] == b["arm"] and a["n"] == b["n"]
        assert a["src"] == b["dst"] and len(a["src"]) >= 2
        assert b["sent"] == 0
    lead = ranks[0][name]
    for arm, nbytes in lead["transfer_bytes"].items():
        if arm in lead["pins"]:
            assert sum(w["sent"] for w in src if w["arm"] == int(arm)) == \
                nbytes > 0
    dtypes = {d for w in src for d in w["dtypes"]}
    assert dtypes == ({"torch.float32", "torch.int8"}
                      if name == "pin_remote_decode" else {"torch.float32"})


# ------------------------------------------------------------ no world
@pytest.mark.parametrize("devices", [("cpu", "cpu"), (0, 2), (-1, 0),
                                     (True, 0)])
def test_fleet_devices_must_be_ranks(devices):
    """On a process-group mesh ``fleet_devices`` names ranks of the world:
    a device, a rank out of range or a bool raises."""
    from repro_torch.configs.base import get_config
    from repro_torch.engine import TorchBackend
    cfg = get_config("stablelm-1.6b").reduced()
    with pytest.raises(ValueError, match="a rank of the world"):
        TorchBackend(cfg, mesh=_rank0_mesh(), device="cpu", arms=(),
                     fleet="disagg", fleet_devices=devices)


@pytest.mark.parametrize("header", [(3, 0, 4, 8, 9, 0, 2),
                                    (3, 2, 4, 8, 9, 0, 1),
                                    (4, 0, 4, 8, 9, 1, 0)])
def test_follower_refuses_what_it_does_not_hold(monkeypatch, header):
    """A follower of a fleet of two colocated LAYER replicas: a header
    naming replica 2, an arm not built (COMPRESSED) or a disaggregated
    worker of a colocated arm raises; nothing is built or served in its
    place."""
    from repro_torch.configs.base import get_config
    from repro_torch.dist import comm
    from repro_torch.engine.fleet import FleetBackend
    from repro_torch.engine.torch_backend import TorchBackend
    monkeypatch.setattr(TorchBackend, "_world", None)
    cfg = get_config("stablelm-1.6b").reduced()
    mesh = _rank0_mesh()
    fleet = FleetBackend(cfg, mesh=mesh, n_replicas=2, device="cpu",
                         arms=(0,), cache_len=16, block_size=4)
    mesh.rank = 1
    sent = iter([torch.tensor(header), torch.zeros((4, 9), dtype=torch.int32)])
    monkeypatch.setattr(comm, "broadcast_from", lambda x, *a: next(sent))
    with pytest.raises(ValueError, match="replica 2|arm 2|worker 1"):
        fleet.follow()
    assert all(set(r.models) == {0} for r in fleet.replicas)
    assert all(s.prefill_chunks == s.decode_dispatches == 0
               for r in fleet.replicas for s in r._all_scheds())


if __name__ == "__main__":
    _worker(int(sys.argv[1]), pathlib.Path(sys.argv[2]))
    # the results are written and the group destroyed: leave without the
    # interpreter's teardown, where a gloo group's destructor racing the
    # other rank's exit can abort the process
    sys.stdout.flush()
    os._exit(0)
