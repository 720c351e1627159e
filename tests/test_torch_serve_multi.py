"""The port's serving across ranks (the runners' serving surface on gloo
process groups of CPU processes, flash-decoding over a length-sharded
cache, the cross-device block ship, ``TorchBackend(mesh=)`` and ``serve
--mesh``) against the JAX package on one device.

The reference's contract (``tests/test_perf_paths.py``,
``test_flash_decode_parity``) is that a runner on a mesh serves what the
same runner serves on one device, the length-sharded cache included.  So
each case here runs in one world of two CPU processes, which builds a
(2, 1) and a (1, 2) mesh, and is held to a module-scoped JAX run of the
runner of its mode on a 1 x 1 mesh, on the same weights (the JAX init,
bridged through numpy and cut into each rank's slices by the port's specs)
and the same numpy-seeded tokens:

- flash-decoding (``shard_cache_len=True``, fsdp on (2, 1)) on tiny
  stablelm (a prompt at 0, a second one across the slab boundary at
  ``cache_index`` 5, six decode steps) and on shrunk gemma2 (local window
  8 and softcap 50, twelve decode steps from 0: the ring wraps and the
  global cache crosses its slab boundary);
- fsdp on (2, 1) with recurrent state (tiny xLSTM, and tiny jamba for
  its Mamba mixer), whose rows split over 'data' while the state stays
  whole on each rank: ``prefill_step`` and a prompt fed a token at a time
  through ``serve_step``, then more steps (JAX's calls jitted; the weights
  drawn by the port, whose init is quicker than JAX's Mamba init);
- the LAYER stages on (1, 2) serving tiny internvl's prompt behind its
  patch prefix (``prefill_step`` with ``image_embeds``: stage 0 projects
  the patches, the last stage drops the prefix before the head);
- fsdp on (2, 1) (rows over 'data'), pipeline (stages; in the gspmd
  layout, embed and head split over 'model' and gathered on use, and in
  the stage graph's, whole on each stage) and semantic (branches) on
  (1, 2): ``prefill_step``, ``prefill_into_cache`` with per-row lengths
  and four ``serve_step`` calls;
- tiny whisper (enc-dec: 2 + 2 layers, d 256, 16 frames, vocab 512) on
  the LAYER stages (``schedule="1f1b"``; the encoder a chain of stages of
  its own) and the gspmd layout on (1, 2), semantic on (1, 2) and fsdp on
  (2, 1): ``prefill_step`` with ``audio_embeds``, the prompt
  teacher-forced through ``serve_step`` (the audio re-encoded each call),
  then four greedy steps; the greedy tokens JAX's, the follower's logits
  rank 0's bit for bit; and ``TorchBackend`` on (1, 2) raising the
  reference's ``KeyError`` at its first gang step on both ranks;
- the same calls of fsdp on (2, 1) on tiny qwen2-moe at a capacity factor
  whose experts overflow (the reference drops assignments, counted here),
  and the loss and gradients of its ``value_and_grad``: capacity and drops
  are the whole batch's though each rank routes its own rows;
- ``TorchBackend`` on the process-group mesh (the gang path through the
  runners, rank 0 driving the engine, rank 1 following its headers) on
  (2, 1) and (1, 2), each arm under ``FixedPolicy`` held token for token
  to ``JaxBackend(decode="legacy")`` on its own weights; a UCB run; tiny
  jamba (a teacher-forced prompt loop) held to ``JaxBackend`` on the
  weights the port draws, and to the port's one-process backend.
  The follower's batches, prefill calls, decode steps and the CRC-32 of
  its token streams equal rank 0's;
- the paged path across ranks (``TorchBackend(decode="paged")`` on the
  process-group mesh, each rank holding its stages' or branches' slice of
  the paged pool) on (2, 1) and (1, 2), each arm and COMPRESSED under
  ``FixedPolicy``
  with requests from shared-prefix families in three waves and a pool
  small enough that an urgent wave preempts a lane: held token for token
  and counter for counter (prefix hits, COW copies, preemptions, chunks,
  dispatches) to ``JaxBackend(decode="paged")`` on the same weights; the
  same on (1, 2) with int8 KV and int8 weights, held to the port's
  one-process backend, its codes to JAX's ``quantize_blockwise``; each
  rank's pool bytes, and the collectives of one paged decode step a mesh.

Logits are held to JAX's within 1e-5 of their largest |value| (the
reference holds its sharded decode to 1e-3 absolute), tiny xLSTM's within
1e-4: the reduced xLSTM is ill-conditioned, and the port's one-device
runner itself reads 3.1e-5 of the largest logit against JAX's on these
weights;
its caches and its ranks against the one-device run within 1e-4 too (a
rank's one row rounds differently from two rows); the caches the ranks
hold, reassembled by ``bridge.gather_tree``, within 1e-6 of theirs under
flash-decoding and 1e-5 elsewhere.  The
world runs under a 120 s limit, its process groups with a 60 s timeout.
This file doubles as the worker: ``python tests/test_torch_serve_multi.py
RANK DIR`` (it imports torch and the port only), and as the paged cases'
reference process beside it (``... paged DIR``, with JAX).
"""
import dataclasses
import math
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = pathlib.Path(__file__).resolve().parents[1]
SHRINK = dict(d_model=64, n_heads=2, n_kv_heads=2, head_dim=32, d_ff=128,
              vocab_size=128)
CONFIGS = {"tiny": ("stablelm-1.6b", {}),
           "dense": ("stablelm-1.6b", {"n_layers": 4}),
           "moe": ("qwen2-moe-a2.7b", {}),
           "gemma": ("gemma2-27b", {"sliding_window": 8}),
           "xlstm": ("xlstm-125m", {"n_layers": 6}),
           "jamba": ("jamba-1.5-large-398b", {"n_layers": 8}),
           "vlm": ("internvl2-26b", {}),
           "whisper": ("whisper-base", {})}
#: configs served at the reduced width (not shrunk): tiny whisper, 2 + 2
#: layers, d 256, 16 frames of 128, vocab 512
UNSHRUNK = ("whisper",)
#: configs whose weights the port draws (JAX's Mamba init takes seconds)
PORT_DRAWN = ("xlstm", "jamba")
# name -> (dims, config, weights, mode, runner kwargs, what runs)
CASES = {
    "fd_dense": ((2, 1), "dense", "dense", "fsdp",
                 dict(shard_cache_len=True), "flash_prompt"),
    "fd_gemma": ((2, 1), "gemma", "gemma", "fsdp",
                 dict(shard_cache_len=True), "flash_steps"),
    "fsdp": ((2, 1), "dense", "dense", "fsdp", {}, "surface"),
    "fsdp_xlstm": ((2, 1), "xlstm", "xlstm", "fsdp", {}, "recurrent"),
    "fsdp_mamba": ((2, 1), "jamba", "jamba", "fsdp", {}, "recurrent"),
    "stages_vlm": ((1, 2), "vlm", "vlm", "pipeline", {}, "vlm"),
    "pipeline": ((1, 2), "dense", "dense", "pipeline", {}, "surface"),
    "stages": ((1, 2), "dense", "dense", "pipeline", dict(schedule="1f1b"),
               "surface"),
    "semantic": ((1, 2), "dense", "sem", "semantic", {}, "surface"),
    "fsdp_moe": ((2, 1), "moe", "moe", "fsdp", {}, "surface"),
    "stages_whisper": ((1, 2), "whisper", "whisper", "pipeline",
                       dict(schedule="1f1b"), "encdec"),
    "pipeline_whisper": ((1, 2), "whisper", "whisper", "pipeline", {},
                         "encdec"),
    "semantic_whisper": ((1, 2), "whisper", "whisper_sem", "semantic", {},
                         "encdec"),
    "fsdp_whisper": ((2, 1), "whisper", "whisper", "fsdp", {}, "encdec"),
}
#: the enc-dec cases: greedy steps after the teacher-forced prompt
ENCDEC_STEPS = 4
ENCDEC = [n for n, c in CASES.items() if c[-1] == "encdec"]
#: the MoE case's capacity factor: at 4 experts and top 2, a call of T
#: tokens keeps max(2, T / 4) assignments an expert, so experts overflow
MOE_CF = 0.5
#: the engine cases: (mesh dims, config, policy); "fixed" serves each arm
#: under ``FixedPolicy`` on JaxBackend's weights, "ucb" both arms under
#: UCB and "recurrent" the LAYER arm under ``FixedPolicy``, both on the
#: weights every rank draws (JaxBackend's, in the recurrent case, bridged
#: from them)
ENGINE = {"engine_data": ((2, 1), "tiny", "fixed"),
          "engine_model": ((1, 2), "tiny", "fixed"),
          "engine_ucb": ((2, 1), "tiny", "ucb"),
          "engine_mamba": ((2, 1), "jamba", "recurrent")}
ENGINE_KW = dict(cache_len=16, max_batch=4, decode="legacy")
#: the paged engine cases: mesh dims and the weights ("fixed": JaxBackend's,
#: "int8": the ones every rank draws, with int8 KV and int8 weights)
PAGED = {"engine_paged_data": ((2, 1), "fixed"),
         "engine_paged_model": ((1, 2), "fixed"),
         "engine_paged_int8": ((1, 2), "int8")}
#: the arms the int8 case builds at construction: its COMPRESSED arm is
#: built at its first request (rank 0 announces it with ``OP_ARM``, and
#: both ranks quantize its weights and reduce the telemetry then)
PAGED_INT8_ARMS = (0, 1)
#: 11 allocatable blocks of 4 slots: the urgent wave preempts a lane
PAGED_KW = dict(cache_len=32, max_batch=4, decode="paged", block_size=4,
                prefill_chunk=4, scan_tokens=4, num_blocks=12)
PAGED_INT8 = dict(kv_dtype="int8", weight_quant="int8")
#: the paged cases' arms (LAYER, SEMANTIC, COMPRESSED), and the legacy
#: JaxBackend's arm whose weights each serves (one init key: COMPRESSED's
#: fsdp runner draws LAYER's weights)
PAGED_ARMS = (0, 1, 2)
PAGED_WEIGHTS = {0: 0, 1: 1, 2: 0}
#: the paged calls' counts a follower keeps, equal to rank 0's
PAGED_FOLLOWED = ("prefill_chunks", "decode_dispatches", "cow_copies",
                  "prefill_calls", "stream_digest")
#: the scheduler counters held to JaxBackend's
PAGED_COUNTERS = ("prefix_hit_rate", "cow_copies", "preemptions",
                  "prefill_calls", "decode_dispatches", "decoded_tokens")
#: each request's new tokens: five requests make a batch of four rows
#: (split over 'data') and one of one row (run whole on every rank)
ENGINE_MAX_NEW = (3, 5, 4, 3, 4)
#: what a follower counts, equal to rank 0's ``extra_metrics()``
FOLLOWED = ("batches", "prefill_calls", "decode_steps", "stream_digest")
B, S, CACHE = 4, 6, 16
LENGTHS = np.array([6, 4, 5, 3], np.int32)
FLASH = dict(b=2, cache=16, prompt=5, second=4, steps=6, gemma_steps=12)
#: the recurrent cases: 2 rows (one a rank), a 4-token prompt, 2 more steps
RECURRENT = dict(b=2, prompt=4, steps=2)
TOL, CACHE_TOL = 1e-5, 1e-6
#: logits against JAX's by case, where not ``TOL`` (see above)
LOGIT_TOL = {"fsdp_xlstm": 1e-4}
#: the same for the caches and for the ranks against the port's one-device
#: run (the xLSTM ranks run one row each, which rounds differently)
RANK_TOL = {"fsdp_xlstm": 1e-4}
WORLD_TIMEOUT_S = 120


def make_cfg(get_config, key):
    name, extra = CONFIGS[key]
    cfg = get_config(name).reduced()
    if key not in UNSHRUNK:
        cfg = cfg.replace(**SHRINK)
    cfg = cfg.replace(**extra)
    if cfg.moe is not None:
        # no token drops but in the MoE case's
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, d_ff=128,
            capacity_factor=MOE_CF if key == "moe" else 8.0))
    return cfg


def dictify(tree):
    """A tree with its tuples (a recurrent cell's state) as dicts keyed by
    index, so ``flat`` and the bridge walk it."""
    if isinstance(tree, dict):
        return {k: dictify(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return {str(i): dictify(v) for i, v in enumerate(tree)}
    return tree


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def unflat(d):
    out = {}
    for k, v in d.items():
        node = out
        parts = k.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def _tokens(key, vocab):
    """Every token stream of a case, drawn from one seed."""
    rng = np.random.default_rng(len(key))
    f = FLASH
    return {"prompt": rng.integers(0, vocab, (B, S)).astype(np.int32),
            "steps": rng.integers(0, vocab, (8, B, 1)).astype(np.int32),
            "fd_prompt": rng.integers(0, vocab, (f["b"], f["prompt"]))
            .astype(np.int32),
            "fd_second": rng.integers(0, vocab, (f["b"], f["second"]))
            .astype(np.int32),
            "fd_steps": rng.integers(0, vocab, (f["gemma_steps"], f["b"], 1))
            .astype(np.int32),
            "rec": rng.integers(0, vocab, (RECURRENT["b"], RECURRENT["prompt"]
                                           + RECURRENT["steps"]))
            .astype(np.int32),
            "patches": rng.standard_normal((B, 16, 128)).astype(np.float32),
            "labels": rng.integers(0, vocab, (B, S)).astype(np.int32),
            "audio": rng.standard_normal((B, 16, 128)).astype(np.float32)}


def engine_requests(cls, vocab, n=len(ENGINE_MAX_NEW), seed=8):
    """The engine cases' requests (either package's ``Request``): prompts
    of 3 to 8 tokens, one app each."""
    rng = np.random.default_rng(seed)
    return [cls(rid=i, app_id=i % 3, sla_s=5.0,
                max_new=ENGINE_MAX_NEW[i % len(ENGINE_MAX_NEW)],
                tokens=rng.integers(0, vocab, int(rng.integers(3, 9)))
                .astype(np.int32)) for i in range(n)]


def serve_fixed(backend, placement_engine, fixed, request_cls, vocab, arms):
    """Each arm's requests under ``FixedPolicy`` on one backend (either
    package's classes): {arm: ({rid: tokens}, [(rid, decision)])}."""
    out = {}
    for arm in arms:
        reqs = engine_requests(request_cls, vocab)
        eng = placement_engine(fixed(arm, placement=None), backend)
        eng.submit(reqs)
        done = eng.drain()
        out[arm] = ({r.rid: np.asarray(r.output).tolist() for r in reqs},
                    sorted((o.request.rid, o.decision) for o in done))
    return out


def paged_waves(cls, vocab, arm, seed=17):
    """An arm's three waves of requests (either package's ``Request``, all
    at ``arrival_s`` 0): donors of two 10-token heads; probes that share a
    head (whole blocks and a partial one: a COW copy) with long budgets;
    two urgent requests whose earlier deadline preempts a probe."""
    rng = np.random.default_rng(seed + arm)
    r = lambda n: rng.integers(0, vocab, n).astype(np.int32)
    ha, hb = r(10), r(10)
    spec = [[(np.r_[ha, r(2)], 50.0, 5), (np.r_[hb, r(1)], 50.0, 5)],
            [(np.r_[ha, r(3)], 40.0, 12), (np.r_[hb, r(4)], 40.0, 12),
             (np.r_[ha, r(2)], 40.0, 12)],
            [(np.r_[hb, r(3)], 1.0, 4), (r(12), 1.0, 4)]]
    waves, rid = [], 0
    for wave in spec:
        waves.append([])
        for toks, sla, max_new in wave:
            waves[-1].append(cls(rid=rid, app_id=rid % 3, tokens=toks,
                                 sla_s=sla, max_new=max_new, arrival_s=0.0))
            rid += 1
    return waves


def serve_paged(backend, placement_engine, fixed, request_cls, vocab, arms):
    """Each arm's waves under ``FixedPolicy`` (either package's classes):
    the donors drained, two steps into the probes, the urgent wave, drained.
    {arm: ({rid: tokens}, [(rid, decision)])}."""
    out = {}
    for arm in arms:
        waves = paged_waves(request_cls, vocab, arm)
        eng = placement_engine(fixed(arm, placement=None), backend)
        done = []
        eng.submit(waves[0])
        done += eng.drain()
        eng.submit(waves[1])
        done += eng.step() + eng.step()
        eng.submit(waves[2])
        done += eng.drain()
        out[arm] = ({r.rid: np.asarray(r.output).tolist()
                     for w in waves for r in w},
                    sorted((o.request.rid, o.decision) for o in done))
    return out


def run_case(runner, params, what, toks, t):
    """The calls of one case (either package: ``t`` wraps a numpy array
    as the package's tensor).  Returns ({name: logits}, cache)."""
    out = {}
    f = FLASH
    if what == "surface":
        out["prefill_step"] = runner.prefill_step(
            params, {"tokens": t(toks["prompt"])})
        cache = runner.init_cache(B, CACHE)
        out["prefill_into_cache"], cache = runner.prefill_into_cache(
            params, cache, t(toks["prompt"]), lengths=t(LENGTHS))
        for i in range(4):
            out[f"step{i}"], cache = runner.serve_step(
                params, cache, {"tokens": t(toks["steps"][i])}, S + i)
        return out, cache
    if what == "encdec":
        # prefill_step with the audio; the prompt teacher-forced through
        # serve_step (each call re-encodes the audio, as the reference's
        # decode_step does without enc_kv), then greedy steps
        audio, prompt = t(toks["audio"]), toks["prompt"]
        out["prefill_step"] = runner.prefill_step(
            params, {"tokens": t(prompt), "audio_embeds": audio})
        cache = runner.init_cache(B, CACHE)
        greedy = []
        for i in range(S + ENCDEC_STEPS):
            tok = prompt[:, i:i + 1] if i < S else greedy[-1][:, None]
            out[f"step{i}"], cache = runner.serve_step(
                params, cache, {"tokens": t(tok), "audio_embeds": audio}, i)
            if i >= S - 1:
                greedy.append(np.asarray(out[f"step{i}"]).argmax(-1)
                              .astype(np.int32))
        out["greedy"] = t(np.stack(greedy))
        return out, cache
    if what == "vlm":
        out["prefill_step"] = runner.prefill_step(
            params, {"tokens": t(toks["prompt"]),
                     "image_embeds": t(toks["patches"])})
        return out, {}
    if what == "recurrent":
        r = RECURRENT
        toks_r = toks["rec"]
        out["prefill_step"] = runner.prefill_step(
            params, {"tokens": t(toks_r[:, :r["prompt"]])})
        cache = runner.init_cache(r["b"], CACHE)
        for i in range(toks_r.shape[1]):
            out[f"step{i}"], cache = runner.serve_step(
                params, cache, {"tokens": t(toks_r[:, i:i + 1])}, i)
        return out, cache
    cache = runner.init_cache(f["b"], f["cache"])
    if what == "flash_prompt":
        out["prompt"], cache = runner.prefill_into_cache(
            params, cache, t(toks["fd_prompt"]))
        out["second"], cache = runner.prefill_into_cache(
            params, cache, t(toks["fd_second"]), cache_index=f["prompt"])
        start, n = f["prompt"] + f["second"], f["steps"]
    else:
        start, n = 0, f["gemma_steps"]
    for i in range(n):
        out[f"step{i}"], cache = runner.serve_step(
            params, cache, {"tokens": t(toks["fd_steps"][i])}, start + i)
    return out, cache


# =================================================================== worker
def _worker(rank: int, io: pathlib.Path) -> None:
    import torch.distributed as dist

    from repro_torch import bridge
    from repro_torch.configs.base import get_config
    from repro_torch.dist import api as A
    from repro_torch.dist import comm
    from repro_torch.launch.mesh import init_mesh
    from repro_torch.models import layers as L
    torch.set_num_threads(1)
    store = dist.FileStore(str(io / "store"), 2)
    meshes = {dims: init_mesh(dims, backend="gloo", device="cpu",
                              store=store, rank=rank, world_size=2,
                              timeout_s=60) for dims in ((2, 1), (1, 2))}
    weights = {k: unflat(dict(np.load(io / f"w_{k}.npz")))
               for k in ("dense", "sem", "gemma", "vlm", "moe", "eng0",
                         "eng1", "whisper", "whisper_sem") + PORT_DRAWN}
    for name, (dims, ckey, wkey, mode, kw, what) in CASES.items():
        cfg = make_cfg(get_config, ckey)
        runner = A.build_runner(cfg, mode, meshes[dims], device="cpu", **kw)
        params = runner.shard(bridge.tree_from_numpy(weights[wkey]))
        comm.reset_stats()
        L.FLASH_STATS["lse_merges"] = 0
        out, cache = run_case(runner, params, what, _tokens(name,
                                                            cfg.vocab_size),
                              lambda a: torch.from_numpy(np.asarray(a)))
        res = {"l/" + k: v.numpy() for k, v in out.items()}
        res.update({"c/" + k: v for k, v in
                    flat(bridge.tree_to_numpy(dictify(cache))).items()})
        res.update({"s/" + k: np.asarray(v)
                    for k, v in comm.COMM_STATS.items()})
        res["s/lse_merges"] = np.asarray(L.FLASH_STATS["lse_merges"])
        if name == "fsdp_moe":
            t = lambda a: torch.from_numpy(np.asarray(a))
            toks = _tokens(name, cfg.vocab_size)
            loss, grads = runner.value_and_grad(params, {
                "tokens": t(toks["prompt"]), "labels": t(toks["labels"])})
            res["v/loss"] = loss.detach().numpy()
            res.update({"g/" + k: v for k, v in
                        flat(bridge.tree_to_numpy(grads)).items()})
            res.update(_moe_step_collectives(runner, params, toks, t))
        np.savez(io / f"r_{name}_{rank}.npz", **res)
    _engine_worker(rank, io, meshes, weights)
    dist.destroy_process_group()


def _moe_step_collectives(runner, params, toks, t):
    """The collectives of one decode step of the row-split MoE runner
    (``ds/``), and of the same step with the MoE sized by this rank's rows
    alone (``dw/``: no ``RowSplit``), each op's calls."""
    from repro_torch.dist import comm
    out = {}
    for tag in ("ds", "dw"):
        if tag == "dw":
            runner._row_split = lambda aux=False: None
        cache = runner.init_cache(B, CACHE)
        comm.reset_stats()
        runner.serve_step(params, cache, {"tokens": t(toks["steps"][0])}, 0)
        out.update({f"{tag}/{k}": np.asarray(v) for k, v in
                    comm.COMM_STATS.items() if k.endswith("_calls")})
    del runner._row_split
    return out


def _engine_worker(rank, io, meshes, weights):
    """The engine cases on this rank: rank 0 drives each backend's engine
    and closes it; rank 1 follows.  Results to ``io/e_<rank>.json``."""
    import json

    from repro_torch import bridge
    from repro_torch.configs.base import get_config
    from repro_torch.dist import sharding as SH
    from repro_torch.engine import (LAYER, SEMANTIC, FixedPolicy, MABPolicy,
                                    PlacementEngine, Request, TorchBackend)
    out = {}
    for name, (dims, ckey, what) in ENGINE.items():
        cfg = make_cfg(get_config, ckey)
        arms = (LAYER,) if what == "recurrent" else (LAYER, SEMANTIC)
        tb = TorchBackend(cfg, mesh=meshes[dims], arms=arms, device="cpu",
                          **ENGINE_KW)
        res = {}
        if what == "fixed":
            for arm in arms:
                tb.params[arm] = tb.runners[arm].shard(bridge.tree_from_numpy(
                    weights[f"eng{arm}"]))
        else:       # the weights drawn: the one-process backend's, cut
            one = TorchBackend(cfg, arms=arms, device="cpu", **ENGINE_KW)
            sizes = dict(meshes[dims].shape)
            res["weights_err"] = max(max(flat(SH.tree_map(
                lambda loc, w, sp: float((loc - SH.shard_leaf(
                    w, sp, sizes, meshes[dims].coords)).abs().max()),
                tb.params[arm], one.models[arm].param_tree(),
                tb.runners[arm].specs)).values()) for arm in arms)
        if rank > 0:
            res["follow"] = tb.follow()
        else:
            try:
                if what == "ucb":
                    eng = PlacementEngine(MABPolicy(
                        bandit="ucb", ema_init_values=None, n_ctx=8), tb)
                    for wave in range(2):
                        eng.submit(engine_requests(Request, cfg.vocab_size,
                                                   n=6, seed=wave))
                        eng.drain()
                    res["completed"] = eng.summary()["completed"]
                else:
                    res["served"] = {str(a): v for a, v in serve_fixed(
                        tb, PlacementEngine, FixedPolicy, Request,
                        cfg.vocab_size, arms).items()}
                res["metrics"] = {k: v for k, v in tb.extra_metrics().items()
                                  if not isinstance(v, dict)}
            finally:
                tb.close()
            res["headers_after_close"] = tb.headers_sent
        out[name] = res
    out["engine_whisper"] = _whisper_engine(rank, meshes[(1, 2)])
    out.update(_paged_worker(rank, meshes, weights))
    (io / f"e_{rank}.json").write_text(json.dumps(out))


def _whisper_engine(rank, mesh):
    """Tiny whisper's ``TorchBackend(decode="legacy")`` on (1, 2): both
    arms build (LAYER on the stages); each arm's first gang step, rank 0's
    engine and the follower's replay of it, raises ``KeyError`` (a request
    carries no audio, as in the reference); then rank 0's stop header ends
    the follower's loop."""
    from repro_torch.configs.base import get_config
    from repro_torch.engine import (LAYER, SEMANTIC, FixedPolicy,
                                    PlacementEngine, Request, TorchBackend)
    cfg = make_cfg(get_config, "whisper")
    tb = TorchBackend(cfg, mesh=mesh, device="cpu", **ENGINE_KW)
    res = {"arms": sorted(tb.runners), "staged": tb.runners[LAYER]._staged(),
           "raised": []}
    try:
        for arm in (LAYER, SEMANTIC):
            try:
                if rank == 0:
                    eng = PlacementEngine(FixedPolicy(arm, placement=None),
                                          tb)
                    eng.submit(engine_requests(Request, cfg.vocab_size, n=2))
                    eng.step()
                else:
                    tb.follow()
            except KeyError as e:
                res["raised"].append([arm, e.args[0]])
    finally:
        if rank == 0:
            tb.close()
        else:
            res["stopped"] = bool(tb.follow())
    return res


def _paged_worker(rank, meshes, weights):
    """The paged engine cases on this rank (rank 0 drives, rank 1 follows),
    then one paged decode step of each arm made by both ranks with the
    relay off, its collectives counted."""
    from repro_torch import bridge
    from repro_torch.configs.base import get_config
    from repro_torch.decode.paged_cache import NULL_BLOCK
    from repro_torch.dist import comm
    from repro_torch.engine import (FixedPolicy, PlacementEngine, Request,
                                    TorchBackend)
    from repro_torch.models import transformer as T
    cfg = make_cfg(get_config, "tiny")
    out = {}
    for name, (dims, what) in PAGED.items():
        kw = dict(PAGED_KW, **(PAGED_INT8 if what == "int8" else {}))
        tb = TorchBackend(cfg, mesh=meshes[dims], device="cpu",
                          arms=PAGED_INT8_ARMS if what == "int8"
                          else PAGED_ARMS, **kw)
        if what == "fixed":
            for arm in PAGED_ARMS:
                tb.params[arm] = tb.runners[arm].shard(bridge.tree_from_numpy(
                    weights[f"eng{PAGED_WEIGHTS[arm]}"]))
        res = {}
        if rank > 0:
            res["follow"] = tb.follow()
        else:
            try:
                res["served"] = {str(a): v for a, v in serve_paged(
                    tb, PlacementEngine, FixedPolicy, Request,
                    cfg.vocab_size, PAGED_ARMS).items()}
                res["metrics"] = {k: v for k, v in tb.extra_metrics().items()
                                  if not isinstance(v, dict)}
            finally:
                tb.close()
        res["pool_bytes"] = {str(a): sum(
            t.numel() * t.element_size()
            for e in tb._paged[a].pool.values() for t in e.values())
            for a in PAGED_ARMS}
        if what == "int8":
            # this rank's float wq slices and their int8 codes and scales
            res["codes"] = {}
            for a in PAGED_ARMS:
                mix = T.fetched(tb._paged[a].params[2][0])["pos0"]["mix"]
                res["codes"][str(a)] = [mix["wq"][k].numpy().tolist()
                                        for k in ("q", "scale")]
                w = tb._paged[a].model.grouped_views()[2][0]
                res["codes"][str(a)].append(
                    T.fetched(w)["pos0"]["mix"]["wq"].detach().numpy().tolist())
        # one decode call (4 lanes, one step) on every rank, relay off
        res["step_comm"] = {}
        for a in PAGED_ARMS:
            sched = tb._paged[a]
            sched.relay = None
            w, nb = 4, sched.max_blocks
            host = (np.zeros((w, 1), np.int32),
                    np.full((w, nb), NULL_BLOCK, np.int32),
                    np.zeros(w, np.int32), np.ones(w, np.int32))
            comm.reset_stats()
            sched.call("decode", (w, 1), host)
            res["step_comm"][str(a)] = dict(comm.COMM_STATS)
        out[name] = res
    return out


# ==================================================================== tests
def port(cfg):
    from repro_torch.configs.base import ArchConfig
    return ArchConfig(**{f.name: getattr(cfg, f.name)
                         for f in dataclasses.fields(cfg)})


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Weights written, the world of two started, the JAX references
    computed while it runs; then the workers' results."""
    import jax
    import jax.numpy as jnp

    from repro.configs.base import get_config
    from repro.dist import api as japi
    io = tmp_path_factory.mktemp("serve_multi")
    one = jax.make_mesh((1, 1), ("data", "model"))
    cfgs = {k: make_cfg(get_config, k) for k in CONFIGS}
    from repro.engine import LAYER, SEMANTIC
    from repro.engine.jax_backend import JaxBackend
    inits = {"dense": japi.build_runner(cfgs["dense"], "fsdp", one),
             "sem": japi.build_runner(cfgs["dense"], "semantic", one),
             "gemma": japi.build_runner(cfgs["gemma"], "fsdp", one),
             "vlm": japi.build_runner(cfgs["vlm"], "fsdp", one),
             "moe": japi.build_runner(cfgs["moe"], "fsdp", one),
             "whisper": japi.build_runner(cfgs["whisper"], "fsdp", one),
             "whisper_sem": japi.build_runner(cfgs["whisper"], "semantic",
                                              one)}
    # whisper's eager init takes seconds; the others' as before
    weights = {k: (jax.jit(r.init) if k.startswith("whisper") else r.init)(
        jax.random.PRNGKey(0)) for k, r in inits.items()}
    jb = JaxBackend(cfgs["tiny"], one, arms=(LAYER, SEMANTIC), **ENGINE_KW)
    weights.update({f"eng{arm}": jb.params[arm] for arm in (LAYER,
                                                             SEMANTIC)})
    weights.update({k: jax.tree.map(jnp.asarray, _port_weights(cfgs[k]))
                    for k in PORT_DRAWN})
    for k, w in weights.items():
        np.savez(io / f"w_{k}.npz", **flat(jax.tree.map(np.asarray, w)))

    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    procs, logs, t0 = [], [], time.time()
    for r in ("0", "1", "paged"):         # the world's two ranks; refs
        logs.append(io / f"log_{r}.txt")
        with open(logs[-1], "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, __file__, r, str(io)], env=env,
                stdout=log, stderr=subprocess.STDOUT))

    refs = {"engine": _engine_refs(jb, cfgs, one)}
    for name, (dims, ckey, wkey, mode, kw, what) in CASES.items():
        runner = japi.build_runner(cfgs[ckey], mode, one)
        if what in ("recurrent", "encdec"):     # eager steps take seconds
            runner = _Jitted(runner)
        with _CountDrops(cfgs[ckey].moe) as drops:
            out, cache = run_case(runner, weights[wkey], what,
                                  _tokens(name, cfgs[ckey].vocab_size),
                                  jnp.asarray)
        if name == "fsdp_moe":
            refs["moe_drops"] = drops.per_call
            refs["moe_grads"] = _moe_value_and_grad(
                runner, weights[wkey], _tokens(name, cfgs[ckey].vocab_size))
        refs[name] = ({k: np.asarray(v) for k, v in out.items()},
                      flat(dictify(jax.tree.map(np.asarray, cache))))
        if what == "recurrent":     # the port's own one-device run
            refs[name] += (_port_one_device(cfgs[ckey], weights[wkey],
                                            _tokens(name,
                                                    cfgs[ckey].vocab_size)),)

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
    refs["engine"].update(_load_paged_refs(io))
    return io, cfgs, refs


class _CountDrops:
    """While active, the assignments the reference's MoE drops past
    capacity (``router_topk`` wrapped: an expert keeps the first ``cap`` of
    its assignments), one count a layer and call, reported from inside
    its traced superblock scan by ``jax.debug.callback``: ``per_call``."""

    def __init__(self, moe):
        self.moe, self.per_call = moe, []

    def __enter__(self):
        import jax
        import jax.numpy as jnp
        from repro.models import moe as jmoe
        self.orig = jmoe.router_topk

        def spy(logits, top_k):
            w, idx = self.orig(logits, top_k)
            t, m = idx.shape[0], self.moe
            cap = max(top_k, math.ceil(t * top_k * m.capacity_factor
                                       / m.n_experts))
            count = jnp.bincount(idx.reshape(-1), length=m.n_experts)
            jax.debug.callback(lambda d: self.per_call.append(int(d)),
                               jnp.maximum(count - cap, 0).sum())
            return w, idx
        if self.moe is not None:
            jmoe.router_topk = spy
        return self

    def __exit__(self, *exc):
        from repro.models import moe as jmoe
        jmoe.router_topk = self.orig


def _moe_value_and_grad(runner, params, toks):
    """The reference's loss and gradient tree (numpy, flat paths) on the
    MoE case's batch."""
    import jax
    import jax.numpy as jnp
    batch = {"tokens": jnp.asarray(toks["prompt"]),
             "labels": jnp.asarray(toks["labels"])}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: runner.loss(p, batch)))(params)
    return float(loss), flat(jax.tree.map(np.asarray, grads))


def _engine_refs(jb, cfgs, one):
    """JaxBackend's tokens and decisions on the engine cases' requests,
    each arm under ``FixedPolicy``: the fixed cases' on its own weights,
    the recurrent case's (tiny jamba) on the weights the port's backend
    draws, bridged; and the one-process port backend's on the recurrent
    case too."""
    import jax
    import jax.numpy as jnp

    from repro.engine import FixedPolicy as JFixed
    from repro.engine import LAYER, SEMANTIC
    from repro.engine import PlacementEngine as JPlacement
    from repro.engine import Request as JRequest
    from repro.engine.jax_backend import JaxBackend
    from repro_torch import bridge
    from repro_torch.engine import (FixedPolicy, PlacementEngine, Request,
                                    TorchBackend)
    vocab = cfgs["tiny"].vocab_size
    refs = {"fixed": serve_fixed(jb, JPlacement, JFixed, JRequest, vocab,
                                 (LAYER, SEMANTIC))}
    jamba = port(cfgs["jamba"])
    tb = TorchBackend(jamba, arms=(LAYER,), device="cpu", **ENGINE_KW)
    jjb = JaxBackend(cfgs["jamba"], one, arms=(LAYER,), **ENGINE_KW)
    jjb.params[LAYER] = jax.tree.map(jnp.asarray, bridge.tree_to_numpy(
        tb.models[LAYER].param_tree()))
    refs["recurrent"] = serve_fixed(jjb, JPlacement, JFixed, JRequest,
                                    jamba.vocab_size, (LAYER,))
    refs["recurrent_port"] = serve_fixed(tb, PlacementEngine, FixedPolicy,
                                         Request, jamba.vocab_size, (LAYER,))
    return refs


def _paged_refs(io: pathlib.Path) -> None:
    """The paged cases' references, in a process of their own beside the
    world (``python tests/test_torch_serve_multi.py paged DIR``):
    ``JaxBackend(decode="paged")`` on the tiny config, whose weights are
    the legacy backend's (one init key: checked against ``w_eng<arm>``),
    and the port's one-process int8 run.  Results to
    ``io/paged_refs.json``."""
    import json

    import jax

    from repro.configs.base import get_config
    from repro.engine import FixedPolicy as JFixed
    from repro.engine import PlacementEngine as JPlacement
    from repro.engine import Request as JRequest
    from repro.engine.jax_backend import JaxBackend
    from repro_torch.engine import (FixedPolicy, PlacementEngine, Request,
                                    TorchBackend)
    cfg = make_cfg(get_config, "tiny")
    arms = PAGED_ARMS
    jpb = JaxBackend(cfg, jax.make_mesh((1, 1), ("data", "model")),
                     arms=arms, **PAGED_KW)
    same = all(all(np.array_equal(np.asarray(v), w[k]) for k, v in flat(
        jax.tree.map(np.asarray, jpb.params[a])).items())
        for a in arms
        for w in [dict(np.load(io / f"w_eng{PAGED_WEIGHTS[a]}.npz"))])
    out = {"same_weights": same,
           "paged": (serve_paged(jpb, JPlacement, JFixed, JRequest,
                                 cfg.vocab_size, arms),
                     _counters(jpb.extra_metrics()))}
    one8 = TorchBackend(port(cfg), arms=arms, device="cpu", **PAGED_KW,
                        **PAGED_INT8)
    out["paged_int8"] = (serve_paged(one8, PlacementEngine, FixedPolicy,
                                     Request, cfg.vocab_size, arms),
                         one8.extra_metrics())
    out["pool_bytes"] = {str(a): sum(
        t.numel() * t.element_size() for e in sc.pool.values()
        for t in e.values()) for a, sc in one8._paged.items()}
    (io / "paged_refs.json").write_text(json.dumps(out, default=int))


def _load_paged_refs(io: pathlib.Path) -> dict:
    """``_paged_refs``' results with their int keys and tuples back."""
    import json
    out = json.loads((io / "paged_refs.json").read_text())
    assert out.pop("same_weights")
    for key in ("paged", "paged_int8"):
        served, metrics = out[key]
        out[key] = ({int(a): ({int(r): t for r, t in toks.items()},
                              [tuple(d) for d in dec])
                     for a, (toks, dec) in served.items()}, metrics)
    return out


def _counters(metrics):
    return {k: metrics[k] for k in PAGED_COUNTERS}


def _port_weights(cfg):
    """Weights drawn by the port's init (seed 0) as a numpy tree in the
    JAX layout."""
    from repro_torch import bridge
    from repro_torch.dist import api as tapi
    runner = tapi.build_runner(port(cfg), "fsdp", device="cpu")
    return bridge.tree_to_numpy(runner.init(seed=0))


def _port_one_device(cfg, weights, toks):
    """The port's logits of a recurrent case on one device."""
    from repro_torch import bridge
    from repro_torch.dist import api as tapi
    runner = tapi.build_runner(port(cfg), "fsdp", device="cpu")
    runner.model = bridge.model_from_params(
        runner.cfg, jax_to_numpy(weights))
    out, _ = run_case(runner, runner.model.param_tree(), "recurrent", toks,
                      lambda a: torch.from_numpy(np.asarray(a)))
    return {k: v.numpy() for k, v in out.items()}


def jax_to_numpy(tree):
    return {k: jax_to_numpy(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


class _Jitted:
    """A JAX runner whose serving calls are jitted (the cache index
    traced, so each step reuses one compile)."""

    def __init__(self, runner):
        import jax
        self.init_cache = runner.init_cache
        self.prefill_step = jax.jit(runner.prefill_step)
        self.serve_step = jax.jit(runner.serve_step)


def _shards(io, name):
    return [dict(np.load(io / f"r_{name}_{r}.npz")) for r in range(2)]


def _rank_caches(world, name):
    """The ranks' caches reassembled under the port runner's cache specs,
    and JAX's."""
    from repro_torch import bridge
    from repro_torch.dist import api as tapi
    from repro_torch.launch.mesh import MeshShape
    io, cfgs, refs = world
    dims, ckey, _, mode, kw, _ = CASES[name]
    shards = [unflat({k[2:]: v for k, v in s.items() if k.startswith("c/")})
              for s in _shards(io, name)]
    want = refs[name][1]
    runner = tapi.build_runner(port(cfgs[ckey]), mode, MeshShape(dims),
                               device="cpu", **kw)
    specs = runner.cache_specs(unflat(want))
    return flat(bridge.gather_tree(shards, specs, MeshShape(dims))), want


def _close_logits(got, want, tol=TOL):
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, scale)


@pytest.mark.parametrize("name", list(CASES))
def test_logits_match_jax(world, name):
    """Every call's logits on both ranks: the reference's global logits."""
    io, _, refs = world
    want = refs[name][0]
    for s in _shards(io, name):
        got = {k[2:]: v for k, v in s.items() if k.startswith("l/")}
        assert set(got) == set(want)
        for k in want:
            if k == "greedy":       # the enc-dec cases' greedy tokens
                np.testing.assert_array_equal(got[k], want[k])
                continue
            _close_logits(got[k], want[k], LOGIT_TOL.get(name, TOL))


@pytest.mark.parametrize("name", [n for n in CASES if CASES[n][-1] != "vlm"])
def test_rank_caches_match_jax(world, name):
    """The slices the ranks hold, reassembled, are JAX's whole cache: within
    1e-6 of its largest |value| under flash-decoding (the K/V of the
    one-device layer stack, written into slabs), 1e-5 elsewhere (the
    semantic branches' K/V round differently from JAX's vmap)."""
    got, want = _rank_caches(world, name)
    tol = CACHE_TOL if name.startswith("fd_") else RANK_TOL.get(name, TOL)
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        err = float(np.abs(got[k] - w).max())
        assert err <= tol * max(float(np.abs(w).max()), 1e-30), (k, err)


@pytest.mark.parametrize("name", ENCDEC)
def test_encdec_ranks_agree(world, name):
    """Tiny whisper on every runner across ranks: the follower's logits
    (and greedy tokens) are rank 0's, bit for bit.  On the stages the
    encoder runs as its own chain: each call stage 0 sends the [B, F, d]
    encoder activation and then the decoder's, and each rank takes two
    broadcasts (the encoder's output, then the logits); the other runners
    send nothing point to point."""
    io, cfgs, _ = world
    lead, follower = _shards(io, name)
    logits = [k for k in lead if k.startswith("l/")]
    assert logits == [k for k in follower if k.startswith("l/")]
    for k in logits:
        np.testing.assert_array_equal(lead[k], follower[k], err_msg=k)
    calls = 1 + S + ENCDEC_STEPS
    cfg = cfgs["whisper"]
    if CASES[name][3] == "pipeline":
        frames = cfg.frontend.n_tokens
        act = lambda s: B * s * cfg.d_model * 4
        assert int(lead["s/send_calls"]) == 2 * calls
        assert int(lead["s/send_bytes"]) == calls * act(frames) + act(S) \
            + (calls - 1) * act(1)
        assert "s/send_calls" not in follower
        for s in (lead, follower):
            assert int(s["s/broadcast_calls"]) == 2 * calls
    else:
        assert "s/send_calls" not in lead and "s/send_calls" not in follower


def test_flash_decoding_slabs_and_merges(world):
    """Under ``shard_cache_len`` each rank holds half of every cache's
    length, and each decode step merges the slabs once per attention layer
    (one all-reduce max and one all-reduce sum each)."""
    io, cfgs, refs = world
    for name, steps in (("fd_dense", FLASH["steps"]),
                        ("fd_gemma", FLASH["gemma_steps"])):
        n_layers = cfgs[CASES[name][1]].n_layers
        for s in _shards(io, name):
            for k, v in s.items():
                if k.startswith("c/"):
                    assert v.shape[-3] * 2 == refs[name][1][k[2:]].shape[-3]
            # the second prompt (at cache_index 5) merges too; the first,
            # at 0, is its own causal attention
            prompts = 1 if name == "fd_dense" else 0
            merges = (steps + prompts) * n_layers
            assert int(s["s/lse_merges"]) == merges
            assert int(s["s/all_reduce_max_calls"]) == merges
            assert int(s["s/all_reduce_calls"]) == merges
    # rank 1's slab of the gemma ring is written only once the ring reaches
    # slot 4 of its 8, its global slab only from position 8
    r1 = _shards(io, "fd_gemma")[1]
    assert np.abs(r1["c/pos0/k"]).max() > 0
    assert np.abs(r1["c/pos1/k"]).max() > 0


@pytest.mark.parametrize("name", ["fsdp_xlstm", "fsdp_mamba"])
def test_recurrent_state_whole_on_every_rank(world, name):
    """Where the rows split over 'data', each rank holds the whole
    recurrent state (the bytes of the specs' arithmetic: a replicated
    leaf), equal on both ranks after every call: each call runs a rank's
    own rows and all-gathers each state leaf once."""
    io, cfgs, refs = world
    shards = _shards(io, name)
    want = refs[name][1]
    n_state = 0
    for k, w in want.items():
        a, b = shards[0]["c/" + k], shards[1]["c/" + k]
        if k.rsplit("/", 1)[-1] in ("k", "v"):
            assert a.shape[-4] * 2 == w.shape[-4], k     # rows split
            continue
        n_state += 1
        assert a.shape == b.shape == w.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert n_state > 0
    for s in shards:        # the ranks serve what one device serves
        for k, w in refs[name][2].items():
            _close_logits(s["l/" + k], w, RANK_TOL.get(name, TOL))
    calls = RECURRENT["prompt"] + RECURRENT["steps"]
    n_gather_logits = calls + 1     # every serve_step and prefill_step
    for s in shards:
        assert int(s["s/all_gather_calls"]) >= calls * n_state \
            + n_gather_logits


def test_serving_collectives_by_mode(world):
    """fsdp gathers weights on use and the rows' logits; the stages send
    one activation a call and broadcast the head's logits; the branches'
    logits meet in one all-gather a call."""
    io = world[0]
    calls = 6        # prefill_step, prefill_into_cache, four serve_steps
    for name in ("pipeline", "stages"):
        pipe = _shards(io, name)
        assert sum(int(s.get("s/send_calls", 0)) for s in pipe) == calls
        assert all(int(s["s/broadcast_calls"]) == calls for s in pipe)
        gathers = [int(s.get("s/all_gather_calls", 0)) for s in pipe]
        assert (min(gathers) > 0) == (name == "pipeline"), gathers
    for s in _shards(io, "semantic"):
        assert int(s["s/all_gather_calls"]) == calls
        assert int(s.get("s/send_calls", 0)) == 0
    for s in _shards(io, "fsdp"):
        assert int(s["s/all_gather_calls"]) > calls
        assert int(s.get("s/send_calls", 0)) == 0


# -------------------------------------------------- decode_attention's lse
def _lse_f64(q, k, v, length, softcap):
    b, h, hd = q.shape
    rep = h // k.shape[2]
    kk = np.repeat(k.astype(np.float64), rep, axis=2)
    vv = np.repeat(v.astype(np.float64), rep, axis=2)
    s = np.einsum("bhd,blhd->bhl", q.astype(np.float64), kk) / math.sqrt(hd)
    if softcap:
        s = np.tanh(s / softcap) * softcap
    valid = np.arange(k.shape[1])[None, None] < length[:, None, None]
    s = np.where(valid, s, -np.inf)
    m = s.max(-1, keepdims=True)
    p = np.exp(s - np.where(np.isfinite(m), m, 0))
    l = p.sum(-1)
    out = np.einsum("bhl,blhd->bhd", p, vv) / np.maximum(l, 1e-300)[..., None]
    with np.errstate(divide="ignore"):
        return out, np.where(l > 0, np.log(l) + m[..., 0], -np.inf)


@pytest.mark.parametrize("softcap", [0.0, 50.0])
def test_plain_decode_attention_lse_matches_f64(softcap):
    """The plain version's output and log-sum-exp against a float64
    softmax; a length-0 slab gives 0 and -inf, never NaN."""
    from repro_torch.kernels.decode_attention import decode_attention
    rng = np.random.default_rng(3)
    b, L, h, kh, hd = 5, 40, 8, 2, 32
    q = rng.standard_normal((b, h, hd)).astype(np.float32)
    k = rng.standard_normal((b, L, kh, hd)).astype(np.float32)
    v = rng.standard_normal((b, L, kh, hd)).astype(np.float32)
    length = np.array([0, 1, 17, 39, 40], np.int32)
    out, lse = decode_attention(*(torch.from_numpy(a) for a in (q, k, v,
                                                                  length)),
                                softcap=softcap, return_lse=True)
    want, want_lse = _lse_f64(q, k, v, length, softcap)
    assert out.dtype == torch.float32 and lse.dtype == torch.float32
    assert not torch.isnan(out).any() and not torch.isnan(lse).any()
    np.testing.assert_allclose(out.numpy(), want, rtol=0, atol=2e-6)
    assert np.isneginf(lse[0].numpy()).all() and (out[0] == 0).all()
    np.testing.assert_allclose(lse[1:].numpy(), want_lse[1:], rtol=1e-6)


# ------------------------------------------------- the cross-device ship
@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_ship_blocks_matches_jax_gather_scatter(kv):
    """``ship_blocks`` between two pools (on the CPU the move to the
    destination's device is a no-op) writes what JAX's ``gather_blocks``
    then ``scatter_blocks`` write, NULL-padded ids included."""
    import jax.numpy as jnp

    from repro.decode import paged_cache as jpc
    from repro_torch.decode.cache_store import ship_blocks
    rng = np.random.default_rng(11)
    n_sb, nb, bs, kh, hd = 2, 12, 4, 2, 8

    def pool():
        p = {}
        for i in range(2):
            if kv == "int8":
                p[f"pos{i}"] = {
                    n: rng.integers(-127, 128, (n_sb, nb, bs, kh, hd))
                    .astype(np.int8) for n in ("k", "v")}
                p[f"pos{i}"].update({
                    n: rng.random((n_sb, nb, bs, kh)).astype(np.float32)
                    for n in ("k_scale", "v_scale")})
            else:
                p[f"pos{i}"] = {n: rng.standard_normal(
                    (n_sb, nb, bs, kh, hd)).astype(np.float32)
                    for n in ("k", "v")}
        return p
    src, dst = pool(), pool()
    s = np.array([3, 7, 1, 0, 0, 0, 0, 0], np.int64)     # NULL padded
    d = np.array([5, 2, 9, 0, 0, 0, 0, 0], np.int64)
    t = lambda tree: {k: t(v) if isinstance(v, dict) else torch.from_numpy(
        v.copy()) for k, v in tree.items()}
    tdst = t(dst)
    ship_blocks(t(src), tdst, s, d)
    want = jpc.scatter_blocks(
        jax_tree(dst, jnp), jpc.gather_blocks(jax_tree(src, jnp),
                                              jnp.asarray(s, jnp.int32)),
        jnp.asarray(d, jnp.int32))
    got = flat(tdst)
    for k, w in flat(want).items():
        if "/" in k:
            # the null block (0) is scratch by design in both packages
            np.testing.assert_array_equal(got[k].numpy()[:, 1:],
                                          np.asarray(w)[:, 1:], err_msg=k)


def jax_tree(tree, jnp):
    return {k: jax_tree(v, jnp) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in tree.items()}


def test_cache_store_fleet_ships_a_copy_a_leaf(tiny_cfg, tiny_mesh):
    """A disagg backend's stores ship with ``ship_blocks``: it emits
    JaxBackend's tokens and ship counters, and on one device counts no
    cross-device copy.  A decode worker on another device (``meta``:
    shapes without data) makes the store a fleet whose waves count one
    copy a pool leaf."""
    from repro.engine import FixedPolicy as JFixed
    from repro.engine import PlacementEngine as JPlacement
    from repro.engine import Request as JRequest
    from repro.engine.jax_backend import JaxBackend
    from repro_torch import bridge
    from repro_torch.decode.cache_store import CacheStore
    from repro_torch.decode.scheduler import PagedArmScheduler
    from repro_torch.engine import (LAYER, FixedPolicy, PlacementEngine,
                                    Request, TorchBackend)
    from test_torch_paged import np_tree
    kw = dict(cache_len=16, arms=(LAYER,), fleet="disagg", max_batch=2,
              block_size=4, prefill_chunk=4, scan_tokens=4)
    jb = JaxBackend(tiny_cfg, tiny_mesh, **kw)
    tb = TorchBackend(port(tiny_cfg), device="cpu", **kw)
    bridge.load_params(tb.models[LAYER], np_tree(jb.params[LAYER]))
    store = tb._disagg[LAYER][2]
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, tiny_cfg.vocab_size, 6).astype(np.int32)
               for _ in range(4)]
    mk = lambda cls: [cls(rid=i, app_id=0, tokens=p, sla_s=5.0, max_new=4)
                      for i, p in enumerate(prompts)]
    jreqs, treqs = mk(JRequest), mk(Request)
    for eng, reqs in ((JPlacement(JFixed(LAYER, placement=None), jb), jreqs),
                      (PlacementEngine(FixedPolicy(LAYER, placement=None),
                                       tb), treqs)):
        eng.submit(reqs)
        eng.drain()
    for j, t in zip(jreqs, treqs):
        np.testing.assert_array_equal(t.output, j.output)
    jm, tm = jb.extra_metrics(), tb.extra_metrics()
    for key in ("blocks_shipped", "transfer_bytes", "ship_waves"):
        assert tm[key] == jm[key], key
    assert not store.fleet and tm["ship_xdev_copies"] == 0
    pf = store.src
    far = PagedArmScheduler(type(pf.model)(pf.model.cfg, device="meta"),
                            n_lanes=2, cache_len=16, block_size=4,
                            role="decode")
    fleet = CacheStore(pf, far)
    fleet._transfer([1, 2, 3], [3, 1, 2])
    n_leaves = sum(len(v) for v in far.pool.values())
    assert fleet.fleet and fleet.stats()["ship_xdev_copies"] == n_leaves > 0


# --------------------------------------------- the backend's mesh shape
def test_torch_backend_mesh_matches_jax_backend(tiny_cfg):
    """On a (1, 4) mesh shape both backends serve 4 semantic branches and
    emit the same tokens on both arms; only ``mesh.shape`` is read."""
    from repro.engine import FixedPolicy as JFixed
    from repro.engine import PlacementEngine as JPlacement
    from repro.engine import Request as JRequest
    from repro.engine.jax_backend import JaxBackend
    from repro_torch import bridge
    from repro_torch.engine import (LAYER, SEMANTIC, FixedPolicy,
                                    PlacementEngine, Request, TorchBackend)
    from test_torch_paged import np_tree
    shape = type("MeshShape", (), {"shape": {"data": 1, "model": 4}})()
    kw = dict(cache_len=16, max_batch=2, block_size=4, prefill_chunk=4,
              scan_tokens=4)
    jb = JaxBackend(tiny_cfg, shape, **kw)
    tb = TorchBackend(port(tiny_cfg), mesh=(1, 4), device="cpu", **kw)
    assert tb.models[SEMANTIC].cfg.n_branches == 4 == \
        jb.runners[SEMANTIC].model.n_branches
    for arm in (LAYER, SEMANTIC):
        bridge.load_params(tb.models[arm], np_tree(jb.params[arm]))
    rng = np.random.default_rng(4)
    spec = [(i % 2, rng.integers(0, tiny_cfg.vocab_size, 5).astype(np.int32))
            for i in range(4)]
    for arm in (LAYER, SEMANTIC):
        jreqs = [JRequest(rid=i, app_id=0, tokens=p, sla_s=5.0, max_new=3)
                 for i, (a, p) in enumerate(spec) if a == arm]
        treqs = [Request(rid=i, app_id=0, tokens=p, sla_s=5.0, max_new=3)
                 for i, (a, p) in enumerate(spec) if a == arm]
        decisions = []
        for eng, reqs in ((JPlacement(JFixed(arm, placement=None), jb),
                           jreqs),
                          (PlacementEngine(FixedPolicy(arm, placement=None),
                                           tb), treqs)):
            eng.submit(reqs)
            decisions.append(sorted((o.request.rid, o.decision)
                                    for o in eng.drain()))
        assert decisions[0] == decisions[1] and len(decisions[0]) == 2
        for j, t in zip(jreqs, treqs):
            np.testing.assert_array_equal(t.output, j.output)


def test_serve_cli_mesh_shapes_the_runners():
    """``serve --mesh 1,2`` serves every request with ``decode="auto"`` (as
    under ``torch.distributed.run`` too); the semantic arm has max(2, M)
    branches."""
    from repro_torch.engine import SEMANTIC, TorchBackend
    from repro_torch.launch import serve
    seen = []
    orig = TorchBackend.__init__

    def spy(self, *a, **kw):
        orig(self, *a, **kw)
        seen.append(self)
    TorchBackend.__init__ = spy
    try:
        out = serve.main(["--device", "cpu", "--mesh", "1,2", "--batches",
                          "2", "--batch-size", "3", "--cache-len", "32"])
    finally:
        TorchBackend.__init__ = orig
    assert out["completed"] == 6
    assert seen[0].decode == "auto"
    assert seen[0].mesh.shape == {"data": 1, "model": 2}
    assert seen[0].models[SEMANTIC].cfg.n_branches == 2


# ------------------------------------- the MoE's capacity on a row split
def test_moe_row_split_drops_as_the_reference(world):
    """At ``MOE_CF`` the reference drops assignments, and the ranks,
    each routing its own rows, drop what it drops: their logits (in
    ``test_logits_match_jax``) and caches match it, and so do the loss and
    every gradient slice of ``value_and_grad`` on the same rows, within
    ``TOL`` of the largest value.  (Sized by a rank's own rows, capacity
    halves, and the logits part from the reference's.)"""
    from repro_torch.dist import api as tapi
    from repro_torch.dist import sharding as SH
    from repro_torch.launch.mesh import MeshShape
    io, cfgs, refs = world
    drops = refs["moe_drops"]          # 6 calls of 2 MoE layers
    assert len(drops) == 6 * cfgs["moe"].n_layers and sum(drops) > 0, drops
    want_loss, want = refs["moe_grads"]
    dims = CASES["fsdp_moe"][0]
    runner = tapi.build_runner(port(cfgs["moe"]), "fsdp", MeshShape(dims),
                               device="cpu")
    specs = flat(runner.param_specs(unflat(want)))
    for r, s in enumerate(_shards(io, "fsdp_moe")):
        assert abs(float(s["v/loss"]) - want_loss) <= TOL * abs(want_loss)
        got = {k[2:]: v for k, v in s.items() if k.startswith("g/")}
        assert set(got) == set(want)
        coords = {"data": r, "model": 0}
        for k, w in want.items():
            w = SH.shard_leaf(torch.from_numpy(w), specs[k], dict(
                data=dims[0], model=dims[1]), coords).numpy()
            assert got[k].shape == w.shape, k
            err = float(np.abs(got[k] - w).max())
            assert err <= TOL * max(float(np.abs(w).max()), 1e-30), (k, err)


def test_moe_row_split_serving_gathers_once_a_layer(world):
    """A decode step of the row-split MoE spends one collective a MoE
    layer on its capacity (the per-expert counts' all-gather) beyond the
    same step sized by a rank's own rows, and no all-reduce: the serving
    calls drop the load-balance aux, so its means are not summed."""
    io, cfgs, _ = world
    for s in _shards(io, "fsdp_moe"):
        split, whole = ({k[3:]: int(v) for k, v in s.items()
                         if k.startswith(tag)} for tag in ("ds/", "dw/"))
        assert split.get("all_reduce_calls", 0) == 0, split
        assert sum(split.values()) - sum(whole.values()) \
            == cfgs["moe"].n_layers, (split, whole)
        assert split["all_gather_calls"] - whole["all_gather_calls"] \
            == cfgs["moe"].n_layers


# ------------------------------------------- the engine across ranks
def _engine(world):
    import json
    io = world[0]
    return [json.loads((io / f"e_{r}.json").read_text()) for r in range(2)]


@pytest.mark.parametrize("name", ["engine_data", "engine_model"])
def test_engine_on_mesh_matches_jax_backend(world, name):
    """Rank 0's ``TorchBackend`` on the process-group mesh serves each arm
    under ``FixedPolicy`` through the runners: the same tokens as
    ``JaxBackend(decode="legacy")`` on a 1 x 1 mesh, token for token, and
    the same decisions."""
    want = world[2]["engine"]["fixed"]
    got = _engine(world)[0][name]["served"]
    for arm, (tokens, decisions) in want.items():
        g_tokens, g_decisions = got[str(arm)]
        assert {int(k): v for k, v in g_tokens.items()} == tokens, arm
        assert [tuple(d) for d in g_decisions] == decisions, arm


@pytest.mark.parametrize("name", list(ENGINE))
def test_engine_follower_matches_rank0(world, name):
    """The follower ran what rank 0 ran: its batches, prefill calls and
    decode steps equal rank 0's ``extra_metrics()``, and the CRC-32 of its
    greedy token streams equals rank 0's (so every rank took the same
    tokens); rank 0 sent a header a batch and the stop header."""
    lead, follower = (e[name] for e in _engine(world))
    m = lead["metrics"]
    assert {k: follower["follow"][k] for k in FOLLOWED} == \
        {k: m[k] for k in FOLLOWED}
    assert m["batches"] > 0 and m["decode_steps"] > 0
    assert m["mesh"] == list(ENGINE[name][0]) and m["rank"] == 0
    assert m["headers_sent"] == m["batches"]
    assert lead["headers_after_close"] == m["batches"] + 1


def test_engine_ucb_serves_every_request(world):
    """A UCB run on (2, 1): every request completes on both arms' runners,
    and the weights every rank drew are the one-process backend's, cut by
    the runners' specs."""
    lead, follower = (e["engine_ucb"] for e in _engine(world))
    assert lead["completed"] == 12
    assert lead["weights_err"] == follower["weights_err"] == 0.0


def test_engine_recurrent_prompt_loop_matches_one_process(world):
    """Tiny jamba's LAYER arm on (2, 1): prompts fed a token at a time
    through ``serve_step`` (no batched prefill), the tokens and decisions
    of ``JaxBackend(decode="legacy")`` on a 1 x 1 mesh and of the
    one-process port backend, on the weights every rank draws."""
    lead, follower = (e["engine_mamba"] for e in _engine(world))
    g_tokens, g_decisions = lead["served"]["0"]
    for ref in ("recurrent", "recurrent_port"):
        (tokens, decisions), = world[2]["engine"][ref].values()
        assert {int(k): v for k, v in g_tokens.items()} == tokens, ref
        assert [tuple(d) for d in g_decisions] == decisions, ref
    assert lead["metrics"]["prefill_calls"] == 0
    assert lead["weights_err"] == follower["weights_err"] == 0.0


# ------------------------------------------------ the paged path across ranks
@pytest.mark.parametrize("name", ["engine_paged_data", "engine_paged_model"])
def test_paged_engine_on_mesh_matches_jax_backend(world, name):
    """Rank 0's paged backend on the process-group mesh: JaxBackend's
    (decode="paged") tokens, decisions and scheduler counters on the same
    weights, with prefix hits, COW copies and a preemption on the way."""
    want, counters = world[2]["engine"]["paged"]
    lead = _engine(world)[0][name]
    for arm, (tokens, decisions) in want.items():
        g_tokens, g_decisions = lead["served"][str(arm)]
        assert {int(k): v for k, v in g_tokens.items()} == tokens, arm
        assert [tuple(d) for d in g_decisions] == decisions, arm
    assert {k: lead["metrics"][k] for k in PAGED_COUNTERS} == counters
    assert counters["cow_copies"] > 0 and counters["preemptions"] > 0 \
        and counters["prefix_hit_rate"] > 0


def test_paged_engine_int8_on_mesh_matches_one_process(world):
    """int8 KV and int8 weights on (1, 2): the one-process backend's tokens,
    counters and weight-quant telemetry (the error's max exact, its mean
    within the last printed digit: sums in another order); each rank's
    codes and scales are JAX's ``quantize_blockwise`` of its own slice."""
    import jax.numpy as jnp

    from repro.kernels.quant_matmul import quantize_blockwise
    want, m1 = world[2]["engine"]["paged_int8"]
    lead = _engine(world)[0]["engine_paged_int8"]
    for arm, (tokens, decisions) in want.items():
        g_tokens, g_decisions = lead["served"][str(arm)]
        assert {int(k): v for k, v in g_tokens.items()} == tokens, arm
        assert [tuple(d) for d in g_decisions] == decisions, arm
    m = lead["metrics"]
    assert {k: m[k] for k in PAGED_COUNTERS} == \
        {k: m1[k] for k in PAGED_COUNTERS}
    assert m["weight_quant_max_err"] == m1["weight_quant_max_err"] > 0
    assert abs(m["weight_quant_mean_err"] - m1["weight_quant_mean_err"]) \
        <= 1e-6
    for rank in _engine(world):
        for arm, (q, scale, w) in rank["engine_paged_int8"]["codes"].items():
            jq, js = quantize_blockwise(jnp.asarray(np.asarray(w, np.float32)),
                                        bits=8)
            np.testing.assert_array_equal(np.asarray(q), np.asarray(jq))
            np.testing.assert_allclose(np.asarray(scale), np.asarray(js),
                                       rtol=1e-6)


@pytest.mark.parametrize("name", list(PAGED))
def test_paged_follower_matches_rank0(world, name):
    """The follower made rank 0's paged calls on its own slices: its
    prefill chunks, decode dispatches, COW copies and the CRC-32 of every
    decode call's tokens equal rank 0's; rank 0 sent a header a device
    call, one an arm built after construction (the int8 case's
    COMPRESSED) and the stop header."""
    lead, follower = (e[name] for e in _engine(world))
    m = lead["metrics"]
    assert {k: follower["follow"][k] for k in PAGED_FOLLOWED} == \
        {k: m[k] for k in PAGED_FOLLOWED}
    assert m["stream_digest"] != 0 and m["batches"] == 0
    lazy = len(PAGED_ARMS) - len(PAGED_INT8_ARMS) \
        if PAGED[name][1] == "int8" else 0
    calls = m["prefill_chunks"] + m["decode_dispatches"] + lazy
    cow_calls = m["headers_sent"] - calls
    assert 0 < cow_calls <= m["cow_copies"]


@pytest.mark.parametrize("name", list(PAGED))
def test_paged_pool_is_the_ranks_slice(world, name):
    """Each rank holds its stages' superblocks' or its branches' slice of
    the paged pool (half of it on (1, 2)), the whole pool on (2, 1) and in
    the COMPRESSED arm (fsdp computes every layer on every rank): the
    physical-block dim is never split."""
    from repro_torch.configs.base import get_config
    from repro_torch.models.model import build_model
    dims, what = PAGED[name]
    cfg = make_cfg(get_config, "tiny")
    for arm in map(str, PAGED_ARMS):
        if what == "int8":
            whole = world[2]["engine"]["pool_bytes"][arm]
        else:
            c = cfg.semantic(max(2, dims[1])) if arm == "1" else cfg
            pool = build_model(port(c), device="meta").init_pool(
                PAGED_KW["num_blocks"], PAGED_KW["block_size"])
            whole = sum(t.numel() * t.element_size()
                        for e in pool.values() for t in e.values())
        split = dims[1] if arm in ("0", "1") else 1
        for rank in _engine(world):
            assert rank[name]["pool_bytes"][arm] * split == whole, arm


def test_paged_decode_step_passes_only_tokens(world):
    """One paged decode call of 4 lanes and one step: on (2, 1) no
    collective; on (1, 2) the LAYER stages send the [4, 1, d] activation
    once and broadcast the [4] int32 tokens once, and the SEMANTIC ranks
    all-gather one (max, index) pair a lane: no logits cross ranks.
    (COMPRESSED on (1, 2) gathers its weights on use, as its gang path
    does, and passes no token.)"""
    from repro_torch.configs.base import get_config
    d = make_cfg(get_config, "tiny").d_model
    ranks = _engine(world)
    for rank, e in enumerate(ranks):
        calls = lambda arm, name: {k[:-6]: int(v) for k, v in
                                   e[name]["step_comm"][arm].items()
                                   if k.endswith("_calls")}
        nbytes = lambda arm, name, op: int(
            e[name]["step_comm"][arm][op + "_bytes"])
        for arm in map(str, PAGED_ARMS):
            assert calls(arm, "engine_paged_data") == {}
        layer = {"send": 1, "broadcast": 1} if rank == 0 \
            else {"broadcast": 1}
        assert calls("0", "engine_paged_model") == layer
        assert nbytes("0", "engine_paged_model", "broadcast") == 4 * 4
        if rank == 0:
            assert nbytes("0", "engine_paged_model", "send") == 4 * d * 4
        assert calls("1", "engine_paged_model") == {"all_gather": 1}
        assert nbytes("1", "engine_paged_model", "all_gather") == 4 * 2 * 4


@pytest.mark.parametrize("knob", [dict(fleet_devices=("cpu", "cpu"))])
def test_engine_mesh_refusals(knob):
    """On a process-group mesh the backend serves the colocated and the
    disaggregated paged paths (workers pinned to ranks too) and the gang
    path: a pool of fleet devices that are not ranks of the world raises
    (there ``fleet_devices`` names ranks); nothing is served another
    way."""
    from repro_torch.configs.base import get_config
    from repro_torch.engine import TorchBackend
    cfg = get_config("stablelm-1.6b").reduced()
    with pytest.raises(ValueError, match="a rank of the world"):
        TorchBackend(cfg, mesh=_rank0_mesh(), device="cpu", decode="legacy",
                     **knob)


def test_engine_whisper_on_mesh_raises_as_the_reference(world):
    """Tiny whisper on a (1, 2) process-group mesh: ``TorchBackend`` builds
    both arms (LAYER on the stages), and each arm's first gang step raises
    ``KeyError: 'audio_embeds'`` on both ranks, inside the world's limit,
    after which rank 0's stop header still reaches the follower.
    ``JaxBackend`` on a 1 x 1 mesh raises the same at its first step, and
    so does the port's one-process backend: a ``Request`` carries no
    audio in either package."""
    from repro.engine import FixedPolicy as JFixed
    from repro.engine import PlacementEngine as JPlacement
    from repro.engine import Request as JRequest
    from repro.engine.jax_backend import JaxBackend
    import jax

    from repro_torch.engine import (LAYER, SEMANTIC, FixedPolicy,
                                    PlacementEngine, Request, TorchBackend)
    cfg = world[1]["whisper"]
    for e in _engine(world):
        got = e["engine_whisper"]
        assert got["arms"] == [LAYER, SEMANTIC] and got["staged"]
        assert got["raised"] == [[LAYER, "audio_embeds"],
                                 [SEMANTIC, "audio_embeds"]]
    assert _engine(world)[1]["engine_whisper"]["stopped"]
    one = jax.make_mesh((1, 1), ("data", "model"))
    for backend, placement, fixed, request in (
            (JaxBackend(cfg, one, **ENGINE_KW), JPlacement, JFixed,
             JRequest),
            (TorchBackend(port(cfg), device="cpu", **ENGINE_KW),
             PlacementEngine, FixedPolicy, Request)):
        for arm in (LAYER, SEMANTIC):
            eng = placement(fixed(arm, placement=None), backend)
            eng.submit(engine_requests(request, cfg.vocab_size, n=2))
            with pytest.raises(KeyError, match="audio_embeds"):
                eng.step()


def _rank0_mesh():
    """Rank 0's view of a (1, 2) process-group mesh, without a world (what
    the backend reads while it builds its arms)."""
    from repro_torch.launch.mesh import Mesh, MeshShape
    ranks = Mesh.__new__(Mesh)
    MeshShape.__init__(ranks, (1, 2))
    ranks.rank, ranks.coords = 0, {"data": 0, "model": 0}
    ranks.backend, ranks.device = "gloo", torch.device("cpu")
    return ranks


@pytest.mark.parametrize("backend,where", [("gloo", "cpu"),
                                           ("nccl", "meta")])
def test_mesh_wire_tensors_on_the_backends_device(monkeypatch, backend,
                                                  where):
    """What the backend makes on the host for the world (rank 0's headers
    and a paged call's wire matrix, the follower's receive buffers, the
    quant telemetry's reduce) goes as host tensors under gloo and on the
    rank's device under NCCL, which takes no host tensor (the meta device
    stands in for the card here)."""
    from repro_torch.configs.base import get_config
    from repro_torch.dist import api as A
    from repro_torch.dist import comm
    from repro_torch.engine import TorchBackend
    seen = []

    def record(x, *args):
        seen.append(x.device.type)
        return torch.zeros(x.shape, dtype=x.dtype)
    for name in ("broadcast_from", "all_reduce_max", "all_reduce_sum"):
        monkeypatch.setattr(comm, name, record)
    monkeypatch.setattr(TorchBackend, "_world", None)
    tb = TorchBackend(get_config("stablelm-1.6b").reduced(),
                      mesh=_rank0_mesh(), device="cpu", arms=())
    tb.ranks.backend, tb.ranks.device = backend, torch.device(where)
    tb.ranks.groups = {"model": None}
    tb._send_header(1, 0, 0, 0, 0)
    tb._relay(0, "decode", (4, 2), np.zeros((4, 5), np.int32))
    A._reduce_stats((1.0, 2.0, 3), tb.ranks)
    tb.ranks.rank = 1
    assert tb.follow()["stream_digest"] == 0      # the zeros: a stop
    assert seen == [where] * 6


@pytest.mark.parametrize("arch,decode", [("stablelm-1.6b", "paged"),
                                         ("xlstm-125m", "auto")])
def test_engine_mesh_builds_paged_or_gang(arch, decode):
    """On a (1, 2) process-group mesh ``decode="paged"`` (and "auto" on a
    pure global-attention config) builds a paged scheduler an arm over the
    runner's view, its pool this rank's slice: the first stage's
    superblocks, the first branch; "auto" on a recurrent config takes the
    gang path, as in one process."""
    from repro_torch.configs.base import get_config
    from repro_torch.dist.api import PagedView
    from repro_torch.engine import LAYER, SEMANTIC, TorchBackend
    cfg = get_config(arch).reduced()
    tb = TorchBackend(cfg, mesh=_rank0_mesh(), device="cpu", decode=decode,
                      cache_len=16, block_size=4)
    assert set(tb.runners) == {LAYER, SEMANTIC}
    if arch == "xlstm-125m":
        assert tb._paged == {}
        return
    assert set(tb._paged) == {LAYER, SEMANTIC}
    for arm, sched in tb._paged.items():
        assert isinstance(sched.model, PagedView)
        k = sched.pool["pos0"]["k"]
        if arm == LAYER:
            assert k.shape[0] == cfg.n_superblocks // 2
        else:
            assert k.shape[:2] == (1, cfg.n_superblocks)


if __name__ == "__main__":
    if sys.argv[1] == "paged":
        _paged_refs(pathlib.Path(sys.argv[2]))
    else:
        _worker(int(sys.argv[1]), pathlib.Path(sys.argv[2]))
