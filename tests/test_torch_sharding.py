"""The port's sharding specs (``repro_torch.dist.sharding``) and meshes
(``repro_torch.launch.mesh``) against the JAX package's, with no process
group.

Every recipe runs on the JAX ``jax.eval_shape`` trees of all ten configs
at full width and on the port's trees of the same configs on the meta
device, on the production meshes (16, 16) and (2, 16, 16) and on (2, 2);
the specs must be equal leaf for leaf, as tuples.  The semantic recipe runs
on each mesh's semantic tree (``max(2, model)`` branches, as the runner
builds it); ``stage_param_specs`` must raise where the reference does.
The runners' ``param_specs`` and ``cache_specs`` are held the same way,
and the bytes a rank stores against the specs' arithmetic.
"""
import functools

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import ASSIGNED  # noqa: E402
from repro.configs.base import get_config as jget  # noqa: E402
from repro.dist import api as japi  # noqa: E402
from repro.dist import sharding as JSH  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro_torch.configs.base import get_config as tget  # noqa: E402
from repro_torch.dist import api as tapi  # noqa: E402
from repro_torch.dist import sharding as TSH  # noqa: E402
from repro_torch.launch import mesh as TM  # noqa: E402
from repro_torch.models.model import build_model as tbuild  # noqa: E402

MESHES = {"16x16": TM.make_production_mesh(),
          "2x16x16": TM.make_production_mesh(multi_pod=True),
          "2x2": TM.make_debug_mesh(2, 2)}


class FakeMesh:
    """What the reference's recipes read of a mesh: ``shape``."""

    def __init__(self, shape):
        self.shape = dict(shape)


def jmesh(name):
    return FakeMesh(MESHES[name].shape)


def jflat(tree):
    """{"a/b": leaf} of a JAX pytree, specs counting as leaves."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    def part(k):
        for attr in ("key", "name", "idx"):
            if hasattr(k, attr):
                return str(getattr(k, attr))
        return str(k)
    return {"/".join(part(k) for k in path): v for path, v in leaves}


def tflat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(tflat(v, f"{prefix}/{k}" if prefix else k))
        return out
    if isinstance(tree, tuple) and not isinstance(tree, TSH.P):
        names = tree._fields if hasattr(tree, "_fields") else \
            [str(i) for i in range(len(tree))]
        out = {}
        for f, v in zip(names, tree):
            out.update(tflat(v, f"{prefix}/{f}" if prefix else f))
        return out
    return {prefix: tree}


def assert_specs_equal(got, want):
    g, w = tflat(got), jflat(want)
    assert set(g) == set(w)
    for k in w:
        assert isinstance(g[k], TSH.P), k
        assert tuple(g[k]) == tuple(w[k]), (k, g[k], w[k])


@functools.lru_cache(maxsize=None)
def trees(name, n_branches=1):
    """(JAX eval_shape param tree, port meta param tree) at full width."""
    jcfg, tcfg = jget(name), tget(name)
    if n_branches > 1:
        jcfg, tcfg = jcfg.semantic(n_branches), tcfg.semantic(n_branches)
    jt = jax.eval_shape(lambda: jbuild(jcfg).init(jax.random.PRNGKey(0)))
    return jt, tbuild(tcfg, device="meta").param_tree()


def semantic_branches(mesh_name):
    return max(2, MESHES[mesh_name].shape["model"])


CASES = [(n, m) for n in ASSIGNED for m in MESHES]


@pytest.mark.parametrize("name,mesh", CASES)
def test_param_specs_match(name, mesh):
    """fsdp (with and without ZeRO over 'data'), pipeline (with and without
    expert parallelism), stage (with and without), and the semantic recipe
    on the semantic tree; the optimizer specs mirror them, and on the
    multi-pod mesh ``pod_shard_opt_specs`` spreads the moments."""
    jt, tt = trees(name)
    jm, tm = jmesh(mesh), MESHES[mesh]
    for zero in (True, False):
        assert_specs_equal(TSH.fsdp_param_specs(tt, tm, zero_data=zero),
                           JSH.fsdp_param_specs(jt, jm, zero_data=zero))
    for ep in (False, True):
        assert_specs_equal(
            TSH.pipeline_param_specs(tt, tm, expert_parallel=ep),
            JSH.pipeline_param_specs(jt, jm, expert_parallel=ep))
        try:
            want = JSH.stage_param_specs(jt, jm, expert_parallel=ep)
        except ValueError as e:
            with pytest.raises(ValueError, match="must be divisible|"
                               "divisible by the mesh 'model'") as got:
                TSH.stage_param_specs(tt, tm, expert_parallel=ep)
            assert str(got.value) == str(e)
        else:
            assert_specs_equal(
                TSH.stage_param_specs(tt, tm, expert_parallel=ep), want)
    jo = JSH.make_opt_specs(JSH.fsdp_param_specs(jt, jm))
    to = TSH.make_opt_specs(TSH.fsdp_param_specs(tt, tm))
    assert tuple(to.step) == tuple(jo.step) == ()
    assert_specs_equal(to.m, jo.m)
    jp, tp = JSH.pod_shard_opt_specs(jo, jt, jm), \
        TSH.pod_shard_opt_specs(to, tt, tm)
    assert_specs_equal(tp.m, jp.m)
    assert_specs_equal(tp.v, jp.v)
    if "pod" in tm.shape:
        assert any(isinstance(e, tuple) or e == "pod"
                   for s in tflat(tp.m).values() for e in s)
    b = semantic_branches(mesh)
    jst, tst = trees(name, b)
    for zero in (True, False):
        assert_specs_equal(
            TSH.semantic_param_specs(tst, tm, zero_data=zero),
            JSH.semantic_param_specs(jst, jm, zero_data=zero))


@pytest.mark.parametrize("mode,kw", [
    ("fsdp", {}), ("semantic", {}), ("pipeline", {}),
    ("pipeline", dict(expert_parallel=True)),
    ("pipeline", dict(schedule="1f1b", expert_parallel=True))])
def test_runner_specs_match(mode, kw):
    """The runners' ``param_specs`` on (2, 2), every config whose layout
    the reference's runner accepts there, and ``cache_specs`` on its cache
    tree."""
    for name in ASSIGNED:
        jcfg, tcfg = jget(name), tget(name)
        if kw.get("expert_parallel") and kw.get("schedule") and \
                (jcfg.moe is None or jcfg.moe.n_experts % 2):
            continue
        jr = japi.build_runner(jcfg, mode, jmesh("2x2"), **kw)
        tr = tapi.build_runner(tcfg, mode, MESHES["2x2"], device="meta",
                               **kw)
        assert tr.cfg.name == jr.cfg.name
        jt = jax.eval_shape(lambda: jr.model.init(jax.random.PRNGKey(0)))
        assert_specs_equal(tr.param_specs(tr.model.param_tree()),
                           jr.param_specs(jt))
        jc = jax.eval_shape(lambda: jr.model.init_cache(2, 32))
        assert_specs_equal(tr.cache_specs(tr.model.init_cache(2, 32)),
                           jr.cache_specs(jc))


@pytest.mark.parametrize("name", ASSIGNED)
def test_cache_specs_match(name):
    """``cache_specs`` on each config's dense decode cache (batch 4, 64
    slots; and the semantic cache of two branches) on (2, 2) and the
    production mesh, with the batch dim or (``shard_cache_len``) the length
    dim on 'data', and the leading dim on 'model' or not."""
    for b in (1, 2):
        jcfg, tcfg = jget(name), tget(name)
        if b > 1:
            jcfg, tcfg = jcfg.semantic(b), tcfg.semantic(b)
        jc = jax.eval_shape(lambda: jbuild(jcfg).init_cache(4, 64))
        tc = tbuild(tcfg, device="meta").init_cache(4, 64)
        assert {k: tuple(v.shape) for k, v in tflat(tc).items()} == \
            {k: tuple(v.shape) for k, v in jflat(jc).items()}
        for mesh in ("2x2", "16x16"):
            for scl in (False, True):
                for lead in (False, True):
                    assert_specs_equal(
                        TSH.cache_specs(tc, MESHES[mesh], shard_cache_len=scl,
                                        model_leading=lead),
                        JSH.cache_specs(jc, jmesh(mesh), shard_cache_len=scl,
                                        model_leading=lead))


def test_batch_specs_and_mesh_shapes():
    """``batch_specs`` (the leading dim on 'data' when it divides, scalars
    replicated) and the reference's mesh shapes and axis names."""
    batch = {"tokens": np.zeros((8, 16), np.int32),
             "labels": np.zeros((6, 16), np.int32),
             "scale": np.zeros((), np.float32)}
    for n in ("2x2", "16x16"):
        got = TSH.batch_specs(None, MESHES[n], batch)
        want = JSH.batch_specs(None, jmesh(n), batch)
        assert_specs_equal(got, want)
    assert MESHES["16x16"].shape == {"data": 16, "model": 16}
    assert MESHES["2x16x16"].shape == {"pod": 2, "data": 16, "model": 16}
    assert TM.make_debug_mesh(2, 2, pods=2).shape == \
        {"pod": 2, "data": 2, "model": 2}
    assert TM.HBM_BW == 3.35e12 and TM.PEAK_FLOPS_BF16 == 989e12
    assert TM.PEAK_FLOPS_F32 == 67e12 and TM.NVLINK_BW == 450e9
    # the caller names the backend; one that cannot run the world raises
    TM.check_backend("gloo", "cpu", 4)
    for backend, device in (("nccl", "cpu"), ("nccl", "cuda"),
                            ("mpi", "cpu")):
        with pytest.raises(ValueError):
            TM.check_backend(backend, device, max(2, torch.cuda.device_count()
                                                  + 1))


def test_stage_specs_refuse_indivisible_stack_and_cache_len():
    """``stage_param_specs``' error (a stack of 24 superblocks on 5
    stages), and ``cache_specs`` with ``shard_cache_len``: the length dim
    takes 'data' only when it divides."""
    jt, tt = trees("stablelm-1.6b")
    mesh = FakeMesh({"data": 1, "model": 5})
    with pytest.raises(ValueError, match="divisible") as want:
        JSH.stage_param_specs(jt, mesh)
    with pytest.raises(ValueError, match="divisible") as got:
        TSH.stage_param_specs(tt, TM.MeshShape((1, 5)))
    assert str(got.value) == str(want.value)
    jc = jax.eval_shape(lambda: jbuild(jget("stablelm-1.6b")).init_cache(
        1, 96))
    tc = tbuild(tget("stablelm-1.6b"), device="meta").init_cache(1, 96)
    for data in (2, 3, 5):
        m = {"data": data, "model": 1}
        got = TSH.cache_specs(tc, TM.MeshShape((data, 1)),
                              shard_cache_len=True)
        assert_specs_equal(got, JSH.cache_specs(jc, FakeMesh(m),
                                                shard_cache_len=True))
        k = tflat(got)["pos0/k"]
        assert k[-3] == ("data" if 96 % data == 0 else None)


@pytest.mark.parametrize("mesh", ["2x2", "16x16", "2x16x16"])
def test_bytes_per_rank_match_spec_arithmetic(mesh):
    """A rank's stored bytes (``bytes_per_rank``) against the reference's
    specs: each leaf's bytes over the product of the sizes of the axes its
    spec splits; and a rank's slice shapes (``shard_leaf``) sum to it."""
    sizes = MESHES[mesh].shape
    for name in ASSIGNED:
        jt, tt = trees(name)
        specs = TSH.fsdp_param_specs(tt, MESHES[mesh])
        want = 0
        for k, spec in jflat(JSH.fsdp_param_specs(jt, jmesh(mesh))).items():
            leaf = jflat(jt)[k]
            n = int(np.prod(leaf.shape)) * np.dtype(leaf.dtype).itemsize
            for e in spec:
                for ax in (e if isinstance(e, tuple) else (e,)):
                    n //= sizes.get(ax, 1) if ax else 1
            want += n
        assert TSH.bytes_per_rank(tt, specs, MESHES[mesh]) == want
        coords = {ax: sizes[ax] - 1 for ax in sizes}
        got = sum(TSH.shard_leaf(t, s, sizes, coords).numel()
                  * t.element_size()
                  for t, s in zip(tflat(tt).values(), tflat(specs).values()))
        assert got == want


def test_serving_refusals_name_the_serving_slice():
    """Serving across devices runs; no message of the port names a later
    slice for it: the serve CLI's mesh shapes the runners, a fleet takes
    devices from its pool, a store between two devices ships across them,
    and flash-decoding over one slab is attention over the whole cache."""
    import pathlib
    import types

    from repro_torch.configs.base import get_config
    from repro_torch.decode.cache_store import CacheStore
    from repro_torch.engine import SEMANTIC, TorchBackend
    from repro_torch.launch import serve
    from repro_torch.models import layers as L
    port = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
    assert not [p for p in port.rglob("*.py")
                if "slice for serving" in p.read_text()]
    out = serve.main(["--arch", "stablelm-1.6b", "--mesh", "2,1",
                      "--device", "cpu", "--batches", "1", "--batch-size",
                      "2", "--cache-len", "32"])
    assert out["completed"] == 2
    cfg = get_config("stablelm-1.6b").reduced()
    tb = TorchBackend(cfg, mesh=(1, 4), arms=(SEMANTIC,), device="cpu",
                      cache_len=32)
    assert tb.models[SEMANTIC].cfg.n_branches == 4
    pool = dict(block_size=16, kv_dtype="f32")
    src = types.SimpleNamespace(role="prefill", device=torch.device("cpu"),
                                **pool)
    dst = types.SimpleNamespace(role="decode", device=torch.device("meta"),
                                **pool)
    assert CacheStore(src, dst).fleet
    # flash-decoding on one slab of one (its merge the identity) is the
    # attention over the whole cache
    d, kvd = cfg.d_model, cfg.n_kv_heads * cfg.hd
    gen = torch.Generator().manual_seed(0)
    rnd = lambda *shape: torch.randn(*shape, generator=gen)
    w = {"wq": rnd(d, cfg.n_heads * cfg.hd), "wk": rnd(d, kvd),
         "wv": rnd(d, kvd), "wo": rnd(cfg.n_heads * cfg.hd, d)}
    kv = {"k": rnd(1, 8, cfg.n_kv_heads, cfg.hd),
          "v": rnd(1, 8, cfg.n_kv_heads, cfg.hd)}
    x, pos = rnd(1, 1, d), torch.full((1, 1), 5)
    one = L.CacheAxis(0, 1, lambda out, lse: out)
    got, gk = L.attn_apply(w, x, cfg, positions=pos, cache_axis=one,
                           kv_cache={k: t.clone() for k, t in kv.items()},
                           cache_index=5)
    want, wk = L.attn_apply(w, x, cfg, positions=pos, kv_cache=kv,
                            cache_index=5)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(gk["k"], wk["k"]) and torch.equal(gk["v"], wk["v"])
