"""The port's disaggregated serving across ranks (``TorchBackend(
fleet="disagg")`` on a process-group mesh: each rank holds its slice of
both workers' paged pools, rank 0 decides and relays every worker call and
ship wave) against ``JaxBackend(fleet="disagg")`` on one device.

One world of two CPU processes builds a (2, 1) and a (1, 2) mesh and
serves there; the references run in this process meanwhile:

- all three arms (LAYER, SEMANTIC, COMPRESSED) on (2, 1) and on (1, 2),
  on JAX's weights (bridged through numpy, cut by the runners' specs),
  with the paged cases' three waves (``test_torch_serve_multi``) in a pool
  small enough that the urgent wave evicts decode lanes (receiver
  backpressure) and probes hit the receiver's prefix index: rank 0's
  tokens, decisions and scheduler and ship counters equal JaxBackend's on
  a 1 x 1 mesh, exactly;
- the chaos plan of ``tests/test_torch_faults.py`` (an arm blackout,
  dropped / delayed / duplicated ship waves, dispatch errors) on the
  LAYER arm on (1, 2): rank 0's tokens equal the JAX chaos run's and the
  port's one-process clean run's, its fault counters JAX's, and both
  workers' allocators and the store are unwound;
- int8 KV and weights on (1, 2), on the weights every rank draws: the
  tokens and counters of the port's one-process disaggregated backend.

In every case the follower's counts (chunks, dispatches, COW copies, ship
waves and blocks) and the CRC-32 of its decode tokens equal rank 0's; each
rank's two pools are its slice (half of the whole pool on (1, 2) in the
LAYER and SEMANTIC arms, all of it on (2, 1) and in COMPRESSED); a relayed
ship wave puts only its header and id matrix into collectives, and the
ship itself none.  Without a world: rank 0's block-bytes gauges on (1, 2)
are JaxBackend's (the whole pool's block, not the rank's slice).

The world runs under a 120 s limit, its process groups with a 60 s
timeout.  This file doubles as the worker: ``python
tests/test_torch_disagg_multi.py RANK DIR`` (it imports torch and the port
only).
"""
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.engine.torch_backend import HEADER_LEN  # noqa: E402
from test_torch_serve_multi import (_rank0_mesh, flat, make_cfg,  # noqa: E402
                                    port, serve_paged, unflat)

ARMS = (0, 1, 2)
#: the paged cases' pool (11 allocatable blocks of 4 slots a worker): the
#: urgent wave evicts seated decode lanes, and lanes wait for receiver
#: blocks
KW = dict(cache_len=32, max_batch=4, decode="paged", block_size=4,
          prefill_chunk=4, scan_tokens=4, num_blocks=12, fleet="disagg")
INT8 = dict(kv_dtype="int8", weight_quant="int8")
#: ``tests/test_torch_faults.py``'s chaos backend: the LAYER arm, ship
#: expiry at 50 ms, eight ship retries
CHAOS = dict(cache_len=32, max_batch=4, block_size=4, scan_tokens=2,
             arms=(0,), fleet="disagg", ship_timeout_s=0.05,
             max_ship_retries=8)
#: name -> (mesh dims, what runs): "jax" the three arms on JaxBackend's
#: weights, "int8" with int8 KV and weights on the weights every rank
#: draws, "chaos" the chaos plan on the LAYER arm on JaxBackend's weights
CASES = {"data": ((2, 1), "jax"), "model": ((1, 2), "jax"),
         "int8": ((1, 2), "int8"), "chaos": ((1, 2), "chaos")}
#: rank 0's counters held to the reference's
COUNTERS = ("prefix_hit_rate", "cow_copies", "preemptions", "prefill_calls",
            "decode_dispatches", "decoded_tokens", "blocks_shipped",
            "ship_waves", "ship_skipped_blocks", "transfer_bytes",
            "ship_deferred", "decode_spills", "kv_block_bytes")
#: what a follower counts, equal to rank 0's ``extra_metrics()``
FOLLOWED = ("prefill_chunks", "decode_dispatches", "cow_copies",
            "prefill_calls", "ship_waves", "blocks_shipped", "stream_digest")
WORLD_TIMEOUT_S = 120


def chaos_plan(F):
    """``tests/test_torch_faults.py``'s six-fault plan, from module ``F``
    (either package's ``faults``)."""
    return F.FaultPlan([
        F.Fault(at=2.0, kind=F.SHIP_DROP),
        F.Fault(at=3.0, kind=F.ARM_BLACKOUT, target=0, duration=3.0),
        F.Fault(at=6.0, kind=F.SHIP_DELAY, magnitude=0.3),
        F.Fault(at=7.0, kind=F.SHIP_DUP),
        F.Fault(at=8.0, kind=F.DISPATCH_ERROR, count=2),
        F.Fault(at=9.0, kind=F.SHIP_DROP),
    ], seed=7)


def chaos_requests(cls, vocab, n=5, seed=5):
    """The chaos run's requests (``tests/test_torch_faults.py``'s
    ``_mk_reqs``): 6-token prompts, 10 new tokens, all at ``arrival_s``
    0."""
    rng = np.random.default_rng(seed)
    return [cls(rid=i, app_id=int(rng.integers(0, 3)),
                tokens=rng.integers(0, vocab, 6).astype(np.int32),
                sla_s=float(rng.uniform(0.5, 4.0)), max_new=10,
                arrival_s=0.0) for i in range(n)]


def serve_chaos(backend, placement_engine, fixed, request_cls, vocab):
    """The chaos requests on the LAYER arm (either package's classes):
    ({rid: tokens}, the engine's summary)."""
    reqs = chaos_requests(request_cls, vocab)
    eng = placement_engine(fixed(0, placement=None), backend)
    eng.submit(reqs)
    eng.drain()
    return ({r.rid: np.asarray(r.output).tolist() for r in reqs},
            {k: v for k, v in eng.summary().items()
             if not isinstance(v, dict)})


def _pool_bytes(pool) -> int:
    return sum(t.numel() * t.element_size()
               for e in pool.values() for t in e.values())


# =================================================================== worker
def _worker(rank: int, io: pathlib.Path) -> None:
    import torch.distributed as dist

    from repro_torch import bridge
    from repro_torch import faults as F
    from repro_torch.configs.base import get_config
    from repro_torch.dist import comm
    from repro_torch.engine import (FixedPolicy, PlacementEngine, Request,
                                    TorchBackend)
    from repro_torch.launch.mesh import init_mesh
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
        io / f"w{a}.npz")))) for a in ARMS}
    cfg = make_cfg(get_config, "tiny")
    out = {}
    for name, (dims, what) in CASES.items():
        kw = dict(CHAOS, faults=chaos_plan(F)) if what == "chaos" else \
            dict(KW, arms=ARMS, **(INT8 if what == "int8" else {}))
        tb = TorchBackend(cfg, mesh=meshes[dims], device="cpu", **kw)
        if what != "int8":
            for arm in tb.runners:
                tb.params[arm] = tb.runners[arm].shard(weights[arm])
        res = {"waves": [], "ship_comm": []}
        _count_ship_comm(tb, res, comm)
        if rank > 0:
            res["follow"] = tb.follow()
        else:
            try:
                if what == "chaos":
                    res["served"], res["summary"] = serve_chaos(
                        tb, PlacementEngine, FixedPolicy, Request,
                        cfg.vocab_size)
                else:
                    res["served"] = {str(a): v for a, v in serve_paged(
                        tb, PlacementEngine, FixedPolicy, Request,
                        cfg.vocab_size, ARMS).items()}
                res["metrics"] = {k: v for k, v in tb.extra_metrics().items()
                                  if not isinstance(v, dict)}
                res["unwound"] = [(pf.alloc.used_blocks, dc.alloc.used_blocks,
                                   st.backlog)
                                  for pf, dc, st in tb._disagg.values()]
            finally:
                tb.close()
        res["pool_bytes"] = {str(a): [_pool_bytes(pf.pool),
                                      _pool_bytes(dc.pool)]
                             for a, (pf, dc, _) in tb._disagg.items()}
        out[name] = res
    (io / f"e_{rank}.json").write_text(json.dumps(out))
    dist.destroy_process_group()


def _count_ship_comm(tb, res, comm):
    """Record ``COMM_STATS`` around each ship: on rank 0 around the whole
    relayed wave (``_transfer``: the relay's header and id matrix, then the
    ship), on every rank around the ship itself (``_ship``)."""
    def delta(before):
        return {k: v - before.get(k, 0.0) for k, v in comm.COMM_STATS.items()
                if v != before.get(k, 0.0) and not k.endswith("_ms")}

    for _, _, st in tb._disagg.values():
        def ship(wire, orig=st._ship):
            before = dict(comm.COMM_STATS)
            orig(wire)
            res["ship_comm"].append(delta(before))

        def transfer(src, dst, orig=st._transfer):
            before = dict(comm.COMM_STATS)
            orig(src, dst)
            res["waves"].append([len(src), delta(before)])
        st._ship, st._transfer = ship, transfer


# ==================================================================== tests
def _np_tree(tree):
    return {k: _np_tree(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The world of two started, JaxBackend's weights drawn and written
    while it starts, the references computed while it runs (JaxBackend's
    disaggregated and chaos runs; the port's one-process clean chaos run
    and int8 run); then the ranks' results."""
    import jax

    from repro import faults as jfaults
    from repro.configs.base import get_config
    from repro.engine import FixedPolicy as JFixed
    from repro.engine import PlacementEngine as JPlacement
    from repro.engine import Request as JRequest
    from repro.engine.jax_backend import JaxBackend
    from repro_torch import bridge
    from repro_torch.engine import (FixedPolicy, PlacementEngine, Request,
                                    TorchBackend)
    io = tmp_path_factory.mktemp("disagg_multi")
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
    jb = JaxBackend(cfg, one, arms=ARMS, **KW)
    weights = {a: _np_tree(jb.params[a]) for a in ARMS}
    for a in ARMS:
        np.savez(io / f"w{a}.npz", **flat(weights[a]))
    (io / "ready").touch()

    refs = {"disagg": serve_paged(jb, JPlacement, JFixed, JRequest, vocab,
                                  ARMS)}
    refs["disagg_metrics"] = jb.extra_metrics()
    jc = JaxBackend(cfg, one, faults=chaos_plan(jfaults), **CHAOS)
    assert all(np.array_equal(v, flat(weights[0])[k]) for k, v in
               flat(_np_tree(jc.params[0])).items())
    refs["chaos"] = serve_chaos(jc, JPlacement, JFixed, JRequest, vocab)
    clean = TorchBackend(port(cfg), device="cpu", **CHAOS)
    bridge.load_params(clean.models[0], weights[0])
    refs["clean"] = serve_chaos(clean, PlacementEngine, FixedPolicy, Request,
                                vocab)
    one8 = TorchBackend(port(cfg), device="cpu", arms=ARMS, **KW, **INT8)
    refs["int8"] = serve_paged(one8, PlacementEngine, FixedPolicy, Request,
                               vocab, ARMS)
    refs["int8_metrics"] = one8.extra_metrics()

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


@pytest.mark.parametrize("name", ["data", "model"])
def test_disagg_on_mesh_matches_jax_backend(world, name):
    """Rank 0's disaggregated backend on the process-group mesh serves all
    three arms with JaxBackend(fleet="disagg")'s tokens, decisions and
    scheduler and ship counters, exactly; receiver backpressure (deferred
    lanes, evicted decode lanes) and receiver prefix hits occur."""
    ranks, refs = world
    lead = ranks[0][name]
    assert _served(lead) == refs["disagg"]
    want = refs["disagg_metrics"]
    m = lead["metrics"]
    assert {k: m[k] for k in COUNTERS} == {k: want[k] for k in COUNTERS}
    assert want["decode_spills"] > 0 and want["ship_skipped_blocks"] > 0 \
        and want["ship_deferred"] > 0 and want["cow_copies"] > 0
    assert m["mesh"] == list(CASES[name][0]) and m["rank"] == 0


def test_disagg_chaos_on_mesh_matches_jax(world):
    """The chaos plan on the LAYER arm on (1, 2) loses nothing: rank 0's
    tokens equal the JAX chaos run's and the port's one-process clean
    run's, its fault counters JAX's; the recovery machinery engaged, and
    both workers' allocators and the store are unwound."""
    ranks, refs = world
    lead = ranks[0]["chaos"]
    tokens, summary = lead["served"], lead["summary"]
    j_tokens, jm = refs["chaos"]
    c_tokens, _ = refs["clean"]
    assert {int(r): t for r, t in tokens.items()} == j_tokens == c_tokens
    assert summary["completed"] == len(j_tokens) == jm["completed"]
    assert summary.get("shed", 0) == 0 and summary.get("failed", 0) == 0
    faults = sorted(k for k in jm if k.startswith("fault"))
    assert faults == sorted(k for k in summary if k.startswith("fault"))
    assert {k: summary[k] for k in faults} == {k: jm[k] for k in faults}
    assert summary["faults_injected"] == 6
    assert summary["retries"] > 0 and summary["re_executions"] >= 1 \
        and summary["recovered"] >= 1
    assert lead["unwound"] == [[0, 0, 0]]


def test_disagg_int8_on_mesh_matches_one_process(world):
    """int8 KV and int8 weights on (1, 2), on the weights every rank draws:
    the one-process disaggregated backend's tokens, decisions, counters and
    weight-quant max error."""
    ranks, refs = world
    lead = ranks[0]["int8"]
    assert _served(lead) == {int(a): ({int(r): t for r, t in toks.items()},
                                      [tuple(d) for d in dec])
                             for a, (toks, dec) in refs["int8"].items()}
    m, m1 = lead["metrics"], refs["int8_metrics"]
    assert {k: m[k] for k in COUNTERS} == {k: m1[k] for k in COUNTERS}
    assert m["weight_quant_max_err"] == m1["weight_quant_max_err"] > 0


@pytest.mark.parametrize("name", list(CASES))
def test_disagg_follower_matches_rank0(world, name):
    """The follower made rank 0's worker calls and ship waves on its own
    slices: its chunks, dispatches, COW copies, ship waves, blocks shipped
    and the CRC-32 of its decode tokens equal rank 0's; rank 0 sent a
    header a device call or wave and the stop header."""
    ranks, _ = world
    lead, follower = ranks[0][name], ranks[1][name]
    m = lead["metrics"]
    assert {k: follower["follow"][k] for k in FOLLOWED} == \
        {k: m[k] for k in FOLLOWED}
    assert m["stream_digest"] != 0 and m["ship_waves"] > 0
    calls = m["prefill_chunks"] + m["decode_dispatches"] + m["ship_waves"]
    assert 0 <= m["headers_sent"] - calls <= m["cow_copies"]


@pytest.mark.parametrize("name", list(CASES))
def test_disagg_pools_are_the_ranks_slices(world, name):
    """Each rank's prefill and decode pools are its slices: half of one
    process's pool on (1, 2) in the LAYER and SEMANTIC arms, all of it on
    (2, 1) and in COMPRESSED (fsdp computes every layer on every rank)."""
    from repro_torch.configs.base import get_config
    from repro_torch.decode.paged_cache import quantize_pool
    from repro_torch.models.model import build_model
    ranks, _ = world
    dims, what = CASES[name]
    cfg = make_cfg(get_config, "tiny")
    # the chaos backend's pool is the full capacity: every lane's blocks
    n_blocks = 1 + CHAOS["max_batch"] * CHAOS["cache_len"] \
        // CHAOS["block_size"] if what == "chaos" else KW["num_blocks"]
    for arm in ranks[0][name]["pool_bytes"]:
        c = cfg.semantic(max(2, dims[1])) if arm == "1" else cfg
        pool = build_model(port(c), device="meta").init_pool(
            n_blocks, KW["block_size"])
        whole = _pool_bytes(quantize_pool(pool) if what == "int8" else pool)
        split = dims[1] if arm in ("0", "1") else 1
        for rank in ranks:
            assert [b * split for b in rank[name]["pool_bytes"][arm]] == \
                [whole, whole], arm


@pytest.mark.parametrize("name", list(CASES))
def test_disagg_ship_stays_on_each_rank(world, name):
    """A relayed ship wave puts its header (seven int64s) and its [n_pad, 2]
    int32 id matrix into two broadcasts and nothing else; the ship itself
    (every rank's copy between its own slices) puts nothing into a
    collective: no pool byte crosses ranks."""
    ranks, _ = world
    lead, follower = ranks[0][name], ranks[1][name]
    assert lead["waves"] and len(follower["ship_comm"]) == \
        len(lead["ship_comm"]) == len(lead["waves"])
    for n, got in lead["waves"]:
        n_pad = 1 << (n - 1).bit_length()
        assert got == {"broadcast_calls": 2,
                       "broadcast_bytes": HEADER_LEN * 8 + n_pad * 2 * 4}
    assert all(d == {} for r in ranks for d in r[name]["ship_comm"])


@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_block_bytes_on_mesh_are_the_whole_pools(kv):
    """Rank 0's ``kv_block_bytes`` (and its f32 twin) on (1, 2) is the
    bytes of one block of the arm's whole pool, as JaxBackend's on a
    1 x 1 mesh, for each arm: not the rank's slice (half of it in the
    LAYER and SEMANTIC arms)."""
    import jax

    from repro.configs.base import get_config
    from repro.engine.jax_backend import JaxBackend
    from repro_torch.engine import TorchBackend
    cfg = make_cfg(get_config, "tiny")
    kw = dict(cache_len=32, decode="paged", block_size=4, num_blocks=12,
              kv_dtype=kv)
    jb = JaxBackend(cfg, jax.make_mesh((1, 1), ("data", "model")),
                    arms=ARMS, **kw)
    for arm in ARMS:
        tb = TorchBackend(port(cfg), mesh=_rank0_mesh(), device="cpu",
                          arms=(arm,), **kw)
        got, want = tb.extra_metrics(), jb._paged[arm].stats()
        for key in ("kv_block_bytes", "kv_block_bytes_f32"):
            assert got[key] == want[key], (arm, key)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), pathlib.Path(sys.argv[2]))
    # the results are written and the group destroyed: leave without the
    # interpreter's teardown, where a gloo group's destructor racing the
    # other rank's exit can abort the process
    sys.stdout.flush()
    os._exit(0)
