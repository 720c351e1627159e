"""The port's training across ranks (``repro_torch.dist`` on gloo process
groups of CPU processes) against the JAX package on one device.

The reference's own 4-device contract (``tests/test_pipeline_schedules.py``,
``_PARITY_CODE``) is that specs are layout only: a runner on a (data, model)
mesh computes the loss and gradients of the same runner on a 1 x 1 mesh.  So
each case here is held to a module-scoped JAX run on a 1 x 1 mesh, in
process, on the same weights (the JAX init, bridged through numpy and cut
into each rank's slices by the port's specs) and a numpy-seeded batch:

- dense ``gpipe`` / ``1f1b`` on (1, 4); ``1f1b``, ``fsdp``, ``gspmd`` and
  ``semantic`` on (2, 2) (each against JAX's fsdp, or its semantic runner);
- qwen2-moe expert parallel (``1f1b``) on (1, 4) with capacity factor 8,
  against JAX's microbatched loss; phi3.5-moe's gspmd, expert-parallel and
  stage-graph losses on (1, 2);
- the dry run's collectives (``launch.dryrun``: rank 0 of the (2, 2) fsdp
  train step traced on the meta device in a fake world) against the calls
  and bytes rank 0 ran here;
- one clipped AdamW step whose moments are split over 'pod' as well
  (``make_train_step(opt_specs=)``, the two-pod dry run's step) on a
  (2, 2, 1) ('pod', 'data', 'model') mesh against JAX's unsharded step;
- ``schedule_stats`` at S = 4; one AdamW step with clipping against JAX's
  unsharded step (a norm over one rank's slices would clip each rank
  differently: the workers report that norm too, and it differs); a
  checkpoint written from the slices and read back into them.

Tolerances: loss rel 1e-5 and each gradient leaf within 1e-5 of its
largest |value| (the reference's are 1e-3 dense, 1e-4 EP, absolute); the
AdamW moments 1e-5 of their max, and a parameter wherever its first
moment is not within float noise of 0 (the first step is sign-like there).

One gloo world per mesh shape, its processes started together with a
``FileStore`` in the module's temporary directory, each process group
created with a 60 s timeout and the whole world under a 240 s limit.  This
file doubles as the worker: ``python tests/test_torch_multi.py DIMS RANK
DIR`` (it imports torch and the port only).
"""
import dataclasses
import json
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
CONFIGS = {"dense": ("stablelm-1.6b", {"n_layers": 4}),
           "qwen": ("qwen2-moe-a2.7b", {}),
           "phi": ("phi3.5-moe-42b-a6.6b", {})}
BATCHES = {"dense": (8, 16), "qwen": (4, 8), "phi": (4, 8)}
# name -> (config, weights, mode, runner kwargs, what runs)
CASES = {
    (1, 4): {
        "gpipe": ("dense", "dense", "pipeline",
                  dict(schedule="gpipe", n_microbatches=4), "vag"),
        "1f1b": ("dense", "dense", "pipeline",
                 dict(schedule="1f1b", n_microbatches=4), "vag"),
        "ep": ("qwen", "qwen", "pipeline",
               dict(schedule="1f1b", n_microbatches=2, expert_parallel=True),
               "vag"),
    },
    (2, 2): {
        "1f1b": ("dense", "dense", "pipeline",
                 dict(schedule="1f1b", n_microbatches=4), "vag"),
        "fsdp": ("dense", "dense", "fsdp", {}, "vag"),
        "gspmd": ("dense", "dense", "pipeline", dict(n_microbatches=4),
                  "vag"),
        "semantic": ("dense", "sem", "semantic", {}, "vag"),
    },
    (1, 2): {
        "gspmd": ("phi", "phi", "pipeline", dict(n_microbatches=2), "loss"),
        "ep": ("phi", "phi", "pipeline",
               dict(schedule="1f1b", n_microbatches=2, expert_parallel=True),
               "loss"),
        "stage": ("phi", "phi", "pipeline",
                  dict(schedule="1f1b", n_microbatches=2), "loss"),
    },
}
ADAMW = dict(lr=1e-2, clip_norm=0.05, weight_decay=0.1)
#: the (2, 2) world's second mesh: ('pod', 'data', 'model'), the moments
#: split over 'pod' too (``pod_shard_opt_specs``)
POD_DIMS = (2, 2, 1)
TOL = 1e-5


def shrink(cfg):
    """The reference's ``shrink`` (either package's config)."""
    kw = dict(SHRINK)
    if cfg.moe is not None:       # no token drops: dispatch regimes agree
        kw["moe"] = dataclasses.replace(cfg.moe, d_ff=128,
                                        capacity_factor=8.0)
    return cfg.replace(**kw)


def make_cfg(get_config, key):
    name, extra = CONFIGS[key]
    return shrink(get_config(name).reduced()).replace(**extra)


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


# =================================================================== worker
def _np(tree):
    from repro_torch import bridge
    return flat(bridge.tree_to_numpy(tree))


def _worker(dims, rank: int, io: pathlib.Path) -> None:
    import torch.distributed as dist

    from repro_torch import bridge
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.configs.base import get_config
    from repro_torch.dist import api as A
    from repro_torch.dist import comm
    from repro_torch.launch.mesh import init_mesh
    from repro_torch.optim.adamw import adamw_init, adamw_update, global_norm
    torch.set_num_threads(1)
    tag = "x".join(map(str, dims))
    world = dims[0] * dims[1]
    mesh = init_mesh(dims, backend="gloo", device="cpu",
                     store=dist.FileStore(str(io / f"store_{tag}"), world),
                     rank=rank, world_size=world, timeout_s=60)
    weights = {k: unflat(dict(np.load(io / f"w_{k}.npz")))
               for k in ("dense", "sem", "qwen", "phi")}
    batches = {k: {n: torch.from_numpy(v) for n, v in
                   np.load(io / f"batch_{k}.npz").items()} for k in BATCHES}
    out = {}
    for name, (ckey, wkey, mode, kw, what) in CASES[dims].items():
        runner = A.build_runner(make_cfg(get_config, ckey), mode, mesh,
                                device="cpu", **kw)
        params = runner.shard(bridge.tree_from_numpy(weights[wkey]))
        batch = batches[ckey]
        comm.reset_stats()
        if what == "loss":
            out[name] = {"loss": np.asarray(float(runner.loss(params,
                                                              batch)))}
            continue
        loss, grads = runner.value_and_grad(params, batch)
        out[name] = {"loss": np.asarray(float(loss)),
                     **{"g/" + k: v for k, v in _np(grads).items()},
                     **{"c/" + k: np.asarray(v)
                        for k, v in comm.COMM_STATS.items()}}
        if dims == (2, 2) and name == "fsdp":
            local_norm = float(global_norm(grads))
            norm = float(global_norm(grads, specs=runner.specs, mesh=mesh))
            opt = adamw_init(params)
            comm.reset_stats()
            params, opt = adamw_update(grads, opt, params, specs=runner.specs,
                                       mesh=mesh, **ADAMW)
            out[name].update({"u/" + k: np.asarray(v)
                              for k, v in comm.COMM_STATS.items()})
            out["adamw"] = {"norm": np.asarray(norm),
                            "local_norm": np.asarray(local_norm),
                            **{"p/" + k: v for k, v in _np(params).items()},
                            **{"m/" + k: v for k, v in _np(opt.m).items()},
                            **{"v/" + k: v for k, v in _np(opt.v).items()}}
            specs = (runner.specs, A.make_opt_specs(runner.specs))
            path = io / "ckpt_2x2.npz"
            ckpt.save(str(path), (params, opt), step=1, specs=specs,
                      mesh=mesh)
            back = ckpt.restore(str(path), (params, opt), specs=specs,
                                mesh=mesh)
            same = all(torch.equal(a, b) for a, b in zip(
                A.tree_leaves(back[0]) + A.tree_leaves(back[1].m)
                + A.tree_leaves(back[1].v),
                A.tree_leaves(params) + A.tree_leaves(opt.m)
                + A.tree_leaves(opt.v))) and back[1].step == opt.step
            out["ckpt"] = {"same": np.asarray(same)}
    if dims == (2, 2):      # AdamW moments split over 'pod' as well
        from repro_torch.launch.dryrun import pod_moments
        from repro_torch.launch.mesh import POD_AXES
        pmesh = init_mesh(POD_DIMS, POD_AXES, backend="gloo", device="cpu")
        runner = A.build_runner(make_cfg(get_config, "dense"), "fsdp", pmesh,
                                device="cpu")
        params = runner.shard(bridge.tree_from_numpy(weights["dense"]))
        opt, o_specs = pod_moments(runner)
        _, grads = runner.value_and_grad(params, batches["dense"])
        params, opt = A._resharded_adamw(grads, opt, params, runner, o_specs,
                                         **ADAMW)
        out["pod_adamw"] = {**{"p/" + k: v for k, v in _np(params).items()},
                            **{"m/" + k: v for k, v in _np(opt.m).items()},
                            **{"v/" + k: v for k, v in _np(opt.v).items()}}
    if dims == (1, 2):      # the reverse pair: backward is an all-gather
        x = (torch.arange(8.) + 10 * rank).reshape(4, 2).requires_grad_()
        y = comm.reduce_scatter(x, 0, mesh.group("model"))
        y.backward(torch.full_like(y, rank + 1.0))
        out["rs"] = {"y": y.detach().numpy(), "gx": x.grad.numpy()}
    if dims == (1, 4):
        out["stats"] = {s: A.build_runner(
            make_cfg(get_config, "dense"), "pipeline", mesh, device="cpu",
            n_microbatches=4, schedule=s).schedule_stats(8, 16)
            for s in ("gpipe", "1f1b")}
    dist.destroy_process_group()
    for name, res in out.items():
        if name == "stats":
            (io / f"r_{tag}_stats_{rank}.json").write_text(json.dumps(res))
        else:
            np.savez(io / f"r_{tag}_{name}_{rank}.npz", **res)


# ==================================================================== tests
WORLD_TIMEOUT_S = 240


@pytest.fixture(scope="module")
def multi(tmp_path_factory):
    """Weights and batches written, the three worlds started, the JAX
    references computed while they run; then the workers' results."""
    import jax
    import jax.numpy as jnp

    from repro.configs.base import get_config
    from repro.dist import api as japi
    from repro.optim.adamw import adamw_init, adamw_update
    io = tmp_path_factory.mktemp("multi")
    one = jax.make_mesh((1, 1), ("data", "model"))
    cfgs = {k: make_cfg(get_config, k) for k in CONFIGS}
    runners = {
        "dense": japi.build_runner(cfgs["dense"], "fsdp", one),
        "sem": japi.build_runner(cfgs["dense"], "semantic", one),
        "qwen": japi.build_runner(cfgs["qwen"], "pipeline", one,
                                  n_microbatches=2, expert_parallel=True),
        "phi": japi.build_runner(cfgs["phi"], "pipeline", one,
                                 n_microbatches=2)}
    weights = {k: r.init(jax.random.PRNGKey(0)) for k, r in runners.items()}
    for k, w in weights.items():
        np.savez(io / f"w_{k}.npz", **flat(jax.tree.map(np.asarray, w)))
    batches = {}
    for i, (k, (b, s)) in enumerate(BATCHES.items()):
        rng = np.random.default_rng(i)
        vocab = cfgs[k].vocab_size
        batches[k] = {n: rng.integers(0, vocab, (b, s)).astype(np.int32)
                      for n in ("tokens", "labels")}
        np.savez(io / f"batch_{k}.npz", **batches[k])

    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    procs, logs, t0 = [], [], time.time()
    for dims in CASES:
        for r in range(dims[0] * dims[1]):
            logs.append(io / f"log_{dims[0]}x{dims[1]}_{r}.txt")
            with open(logs[-1], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, __file__, f"{dims[0]},{dims[1]}",
                     str(r), str(io)], env=env, stdout=log,
                    stderr=subprocess.STDOUT))

    jb = {k: {n: jnp.asarray(v) for n, v in b.items()}
          for k, b in batches.items()}
    refs = {}
    for k in ("dense", "sem", "qwen"):
        loss, grads = jax.jit(runners[k].value_and_grad)(weights[k],
                                                         jb[k if k != "sem"
                                                            else "dense"])
        refs[k] = (float(loss), flat(jax.tree.map(np.asarray, grads)))
    refs["phi"] = (float(jax.jit(runners["phi"].loss)(weights["phi"],
                                                      jb["phi"])), None)
    opt = adamw_init(weights["dense"])
    p1, o1 = adamw_update(unflat({k: jnp.asarray(v) for k, v in
                                  refs["dense"][1].items()}),
                          opt, weights["dense"], **ADAMW)
    refs["adamw"] = {**{"p/" + k: np.asarray(v) for k, v in
                        flat(jax.tree.map(np.asarray, p1)).items()},
                     **{"m/" + k: np.asarray(v) for k, v in
                        flat(jax.tree.map(np.asarray, o1.m)).items()},
                     **{"v/" + k: np.asarray(v) for k, v in
                        flat(jax.tree.map(np.asarray, o1.v)).items()}}
    refs["grad_norm"] = float(np.sqrt(sum(
        np.square(v.astype(np.float64)).sum()
        for v in refs["dense"][1].values())))
    refs["stats"] = {s: japi.PipelineRunner(
        cfgs["dense"], type("M", (), {"shape": {"data": 1, "model": 4}})(),
        n_microbatches=4, schedule=s).schedule_stats(8, 16)
        for s in ("gpipe", "1f1b")}

    for p in procs:
        try:
            p.wait(timeout=max(1.0, WORLD_TIMEOUT_S - (time.time() - t0)))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"a gloo world ran past {WORLD_TIMEOUT_S} s")
    bad = [log.read_text()[-3000:] for p, log in zip(procs, logs)
           if p.returncode]
    assert not bad, bad[0]
    return io, weights, refs, cfgs


def _shards(io, dims, name):
    tag = "x".join(map(str, dims))
    return [dict(np.load(io / f"r_{tag}_{name}_{r}.npz"))
            for r in range(dims[0] * dims[1])]


def _specs(cfg, mode, kw, dims, tree, names=("data", "model")):
    from repro_torch.dist import api as tapi
    from repro_torch.launch.mesh import MeshShape
    return tapi.build_runner(port(cfg), mode, MeshShape(dims, names),
                             device="cpu", **kw).param_specs(tree)


def port(cfg):
    from repro_torch.configs.base import ArchConfig
    return ArchConfig(**{f.name: getattr(cfg, f.name)
                         for f in dataclasses.fields(cfg)})


def _gathered(io, dims, name, prefix, specs):
    from repro_torch import bridge
    from repro_torch.launch.mesh import MeshShape
    shards = [unflat({k[len(prefix):]: v for k, v in s.items()
                      if k.startswith(prefix)})
              for s in _shards(io, dims, name)]
    return flat(bridge.gather_tree(shards, specs, MeshShape(dims)))


def _close(got, want, tol=TOL):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, k
        err = float(np.abs(g - w).max())
        assert err <= tol * max(float(np.abs(w).max()), 1e-30), (k, err)


VAG = [(dims, name) for dims, cases in CASES.items()
       for name, case in cases.items() if case[-1] == "vag"]


@pytest.mark.parametrize("dims,name", VAG)
def test_value_and_grad_matches_jax(multi, dims, name):
    """Loss and every gradient leaf, gathered from the ranks' slices."""
    io, weights, refs, cfgs = multi
    ckey, wkey, mode, kw, _ = CASES[dims][name]
    want_loss, want = refs["sem" if wkey == "sem" else ckey]
    specs = _specs(cfgs[ckey], mode, kw, dims, weights[wkey])
    shards = _shards(io, dims, name)
    losses = [float(s["loss"]) for s in shards]
    assert max(losses) == min(losses)       # every rank reports the mean
    assert abs(losses[0] - want_loss) <= TOL * abs(want_loss)
    _close(_gathered(io, dims, name, "g/", specs), want)
    # the collectives that carried it: the stage graph sends exactly the
    # scheduled transfers; gathered leaves come in by all-gathers;
    # expert parallelism exchanges tokens by all-to-alls
    calls = {k: sum(float(s.get(f"c/{k}_calls", 0)) for s in shards)
             for k in ("send", "all_gather", "all_to_all")}
    if kw.get("expert_parallel"):
        assert calls["all_to_all"] > 0 and calls["send"] == 0
    elif kw.get("schedule"):
        from repro_torch.dist.pipeline import build_schedule
        sched = build_schedule(kw["schedule"], dims[1], kw["n_microbatches"])
        assert calls["send"] == dims[0] * sched.n_transfers
    elif mode == "semantic":
        assert calls["all_gather"] > 0 and calls["send"] == 0
    else:       # each superblock's leaves gathered when it runs
        n_sb = cfgs[ckey].n_layers // len(cfgs[ckey].pattern)
        assert calls["send"] == 0 and calls["all_gather"] == \
            len(shards) * kw.get("n_microbatches", 1) * \
            _gathers_on_use(specs, n_sb)


def _gathers_on_use(specs, n_sb: int) -> int:
    """The all-gathers of one forward that gathers each leaf on use: one a
    split dim of a leaf, and a block leaf's once a superblock (a split of
    its stack dim is a broadcast, not a gather)."""
    n = 0
    for k, sub in specs.items():
        for spec in flat(sub).values():
            if k == "blocks":
                n += n_sb * sum(e is not None for e in spec[1:])
            else:
                n += sum(e is not None for e in spec)
    return n


def test_dryrun_collectives_match_gloo_world(multi):
    """The dry run of the (2, 2) fsdp train step (rank 0 traced on the meta
    device in a fake world of four) records, op for op, the calls and the
    bytes of the collectives rank 0 ran in this gloo world: its
    ``value_and_grad``'s and its AdamW step's (the clip's norm)."""
    from repro_torch.configs.base import get_config
    from repro_torch.dist import api as A
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.mesh import fake_mesh
    from repro_torch.models.model import InputShape
    want = {}
    for k, v in _shards(multi[0], (2, 2), "fsdp")[0].items():
        if k[:2] in ("c/", "u/"):
            op, what = k[2:].rsplit("_", 1)
            want.setdefault(op, {"calls": 0, "bytes": 0})[what] += int(v)
    assert want["all_gather"]["calls"] > 0 and want["all_reduce"]["calls"]
    b, s = BATCHES["dense"]
    with fake_mesh((2, 2)) as mesh:
        runner = A.build_runner(make_cfg(get_config, "dense"), "fsdp", mesh,
                                device="meta")
        rec = DR.dryrun_rank(runner, InputShape("t", s, b, "train"))
    assert rec["collectives"] == want


@pytest.mark.parametrize("name", ["gspmd", "ep", "stage"])
def test_phi35_moe_losses_match_jax(multi, name):
    """phi3.5-moe on (1, 2): the gspmd microbatched, expert-parallel and
    stage-graph losses all equal JAX's gspmd loss."""
    io, _, refs, _ = multi
    for s in _shards(io, (1, 2), name):
        assert abs(float(s["loss"]) - refs["phi"][0]) <= \
            TOL * abs(refs["phi"][0])


def test_schedule_stats_match_jax(multi):
    io = multi[0]
    for r in range(4):
        got = json.loads((io / f"r_1x4_stats_{r}.json").read_text())
        assert got == multi[2]["stats"]


def test_reduce_scatter_backward_is_all_gather(multi):
    """``comm.reduce_scatter`` sums the ranks' rows and keeps each rank's
    half; its backward hands every rank the gathered cotangents."""
    shards = _shards(multi[0], (1, 2), "rs")
    xs = [(np.arange(8.) + 10 * r).reshape(4, 2) for r in range(2)]
    for r, s in enumerate(shards):
        np.testing.assert_array_equal(s["y"], (xs[0] + xs[1])[2 * r:2 * r + 2])
        np.testing.assert_array_equal(s["gx"], np.repeat([[1.0], [2.0]], 2,
                                                          axis=0).repeat(2, 1))


def test_adamw_step_with_clipping_matches_jax(multi):
    """One clipped AdamW step on fsdp slices on (2, 2) equals JAX's step on
    whole leaves; the norm of one rank's slices would not have."""
    io, weights, refs, cfgs = multi
    assert refs["grad_norm"] > ADAMW["clip_norm"]        # the clip acts
    shards = _shards(io, (2, 2), "adamw")
    for s in shards:
        assert abs(float(s["norm"]) - refs["grad_norm"]) <= \
            1e-5 * refs["grad_norm"]
    assert max(abs(float(s["local_norm"]) - refs["grad_norm"])
               for s in shards) > 1e-2 * refs["grad_norm"]
    specs = _specs(cfgs["dense"], "fsdp", {}, (2, 2), weights["dense"])
    want = refs["adamw"]
    for part in ("m/", "v/"):
        got = _gathered(io, (2, 2), "adamw", part, specs)
        _close(got, {k[2:]: v for k, v in want.items()
                     if k.startswith(part)})
    got = _gathered(io, (2, 2), "adamw", "p/", specs)
    for k, g in got.items():
        m = want["m/" + k]
        sure = np.abs(m) > 1e-3 * np.abs(m).max()
        np.testing.assert_allclose(g[sure], want["p/" + k][sure], rtol=0,
                                   atol=1e-6, err_msg=k)


def test_pod_split_adamw_step_matches_jax(multi):
    """The moments split over 'pod' too (each rank steps its slice of them
    and all-gathers the stepped parameters): the same step as JAX's on
    whole leaves, as ``test_adamw_step_with_clipping_matches_jax`` holds
    it; every moment leaf that 'pod' can split is smaller than its
    parameter slice."""
    from repro_torch import bridge
    from repro_torch.dist import sharding as TSH
    from repro_torch.launch.mesh import POD_AXES, MeshShape
    io, weights, refs, cfgs = multi
    mesh = MeshShape(POD_DIMS, POD_AXES)
    specs = _specs(cfgs["dense"], "fsdp", {}, POD_DIMS, weights["dense"],
                   POD_AXES)
    o_specs = TSH.pod_shard_opt_specs(TSH.make_opt_specs(specs),
                                      weights["dense"], mesh)
    shards = [unflat(s) for s in _shards(io, (2, 2), "pod_adamw")]
    want = refs["adamw"]
    n_split = 0
    for part, sp in (("m", o_specs.m), ("v", o_specs.v), ("p", specs)):
        got = flat(bridge.gather_tree([s[part] for s in shards], sp, mesh))
        if part != "p":
            _close(got, {k[2:]: v for k, v in want.items()
                         if k.startswith(part + "/")})
            n_split += sum("pod" in TSH.spec_axes(x)
                           for x in TSH.spec_leaves(sp))
            continue
        for k, g in got.items():
            m = want["m/" + k]
            sure = np.abs(m) > 1e-3 * np.abs(m).max()
            np.testing.assert_allclose(g[sure], want["p/" + k][sure],
                                       rtol=0, atol=1e-6, err_msg=k)
    assert n_split > 0


def test_checkpoint_round_trip_across_ranks(multi):
    """Rank 0 wrote the gathered slices: the file holds the whole
    post-step parameters and moments, and every rank read its slices
    back."""
    io, weights, _, cfgs = multi
    assert all(bool(s["same"]) for s in _shards(io, (2, 2), "ckpt"))
    specs = _specs(cfgs["dense"], "fsdp", {}, (2, 2), weights["dense"])
    data = dict(np.load(io / "ckpt_2x2.npz"))
    params = _gathered(io, (2, 2), "adamw", "p/", specs)
    for k, v in params.items():
        np.testing.assert_array_equal(data["0/" + k], v)
        assert data["1/.m/" + k].shape == v.shape
    assert int(data["1/.step"]) == 1


if __name__ == "__main__":
    _worker(tuple(int(x) for x in sys.argv[1].split(",")), int(sys.argv[2]),
            pathlib.Path(sys.argv[3]))
