"""Port decision layer, backend and launcher against the JAX package, and
the port's import rules.

UCB is deterministic, so decisions and context buckets must equal the JAX
``SplitDecisionEngine``'s exactly on the same decide/observe stream.  Both
compute in float32, but XLA contracts ``a*b + c*d`` into fused multiply-adds
(the EMA blend, ``linspace`` inside ``geomspace``), so the float state —
bucket edges, E_a, arm means — may differ in the last ulp: it is held to
rtol 1e-6, and a ratio within an ulp of an edge is not a fair probe.
``TorchBackend`` and ``JaxBackend`` on the same bridged weights must emit
the same tokens for every request on both arms.
"""
import ast
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import mab as jmab  # noqa: E402
from repro.core.decision import SplitDecisionEngine as JEngine  # noqa: E402
from repro.engine import FixedPolicy as JFixed  # noqa: E402
from repro.engine import PlacementEngine as JPlacement  # noqa: E402
from repro.engine import Request as JRequest  # noqa: E402
from repro.engine.jax_backend import JaxBackend  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import mab as tmab  # noqa: E402
from repro_torch.core.decision import SplitDecisionEngine as TEngine  # noqa
from repro_torch.engine import (LAYER, SEMANTIC, FixedPolicy,  # noqa: E402
                                PlacementEngine, Request, TorchBackend)
from repro_torch.launch import serve  # noqa: E402

from test_torch_paged import np_tree, port_cfg  # noqa: E402
from test_torch_scheduler import MARGIN, _min_margin  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


# ------------------------------------------------------------ decision layer
@pytest.mark.parametrize("n_ctx", [6, 8])
def test_context_buckets_equal(n_ctx):
    jedges = np.asarray(jnp.concatenate([
        jnp.array([0.0]), jnp.geomspace(0.25, 4.0, n_ctx - 1)]))
    np.testing.assert_allclose(tmab.context_edges(n_ctx), jedges, rtol=1e-6)
    ratios = np.concatenate([jedges * 0.999, jedges * 1.001,
                             np.geomspace(1e-3, 1e3, 200)]).astype(np.float32)
    for r in ratios:
        assert tmab.context_bucket(r, n_ctx) == int(
            jmab.context_bucket(jnp.float32(r), n_ctx))


@pytest.mark.parametrize("seed", range(3))
def test_ucb_decisions_match_jax(seed):
    """One synthetic stream of decide / decide_many / observe on both
    engines: identical arms and contexts at every step."""
    rng = np.random.default_rng(seed)
    kw = dict(n_apps=3, bandit="ucb", n_ctx=6, c=0.3,
              ema_init_values=[2.64, 0.54, 3.12])
    je, te = JEngine(**kw), TEngine(**kw)
    js, ts = je.init(jax.random.PRNGKey(0)), te.init()
    jdecide, jobserve = jax.jit(je.decide), jax.jit(je.observe)
    jmany = jax.jit(je.decide_many)
    for step in range(60):
        apps = rng.integers(0, 3, 4).astype(np.int32)
        slas = rng.choice([0.05, 0.5, 2.0, 5.0], 4).astype(np.float32)
        ja, jc, js = jmany(js, jnp.asarray(apps), jnp.asarray(slas),
                           jnp.ones(4, bool))
        ta, tc, ts = te.decide_many(ts, apps, slas, np.ones(4, bool))
        np.testing.assert_array_equal(ta, np.asarray(ja))
        np.testing.assert_array_equal(tc, np.asarray(jc))
        for app, sla in zip(apps, slas):
            ja, jc, js = jdecide(js, jnp.asarray(app), jnp.asarray(sla))
            ta, tc, ts = te.decide(ts, int(app), float(sla))
            assert (ta, tc) == (int(ja), int(jc)), step
            rt = float(rng.gamma(2.0, 0.3 * (1 + ta)))
            acc = float(rng.uniform(0.85, 0.95))
            js = jobserve(js, jnp.asarray(app), jc, ja, jnp.asarray(rt),
                          jnp.asarray(sla), jnp.asarray(acc))
            ts = te.observe(ts, int(app), tc, ta, rt, float(sla), acc)
    np.testing.assert_array_equal(ts.bandit.counts,
                                  np.asarray(js.bandit.counts))
    np.testing.assert_allclose(ts.bandit.means, np.asarray(js.bandit.means),
                               rtol=1e-6)
    np.testing.assert_allclose(ts.ema.value, np.asarray(js.ema.value),
                               rtol=1e-6)


# ------------------------------------------------------------------ backend
def _requests(mk, vocab, seed=5):
    rng = np.random.default_rng(seed)
    return [mk(rid=i, app_id=int(rng.integers(0, 3)),
               tokens=rng.integers(0, vocab, int(rng.integers(3, 9)))
               .astype(np.int32),
               sla_s=float(rng.uniform(0.5, 4.0)),
               max_new=int(rng.integers(2, 7))) for i in range(5)]


@pytest.mark.parametrize("arm", [LAYER, SEMANTIC], ids=["layer", "semantic"])
def test_torch_backend_matches_jax_backend(tiny_cfg, tiny_mesh, arm):
    kw = dict(cache_len=32, max_batch=4, block_size=4, scan_tokens=4,
              prefill_chunk=4, arms=(arm,))
    jb = JaxBackend(tiny_cfg, tiny_mesh, **kw)
    tb = TorchBackend(port_cfg(tiny_cfg), device="cpu", **kw)
    bridge.load_params(tb.models[arm], np_tree(jb.params[arm]))
    jreqs = _requests(JRequest, tiny_cfg.vocab_size)
    treqs = _requests(Request, tiny_cfg.vocab_size)
    for eng, reqs in ((JPlacement(JFixed(arm, placement=None), jb), jreqs),
                      (PlacementEngine(FixedPolicy(arm, placement=None), tb),
                       treqs)):
        eng.submit(reqs)
        eng.drain()
    for j, t in zip(jreqs, treqs):
        assert t.output.shape == (t.max_new,)
        np.testing.assert_array_equal(t.output, j.output)
    lanes = [type("L", (), {"req": r, "out": list(r.output)})
             for r in jreqs]
    assert _min_margin(jb.runners[arm].model, jb.params[arm], lanes) > MARGIN
    jm, tm = jb.extra_metrics(), tb.extra_metrics()
    for key in ("prefill_calls", "decode_dispatches", "decoded_tokens",
                "prefix_hit_rate", "cow_copies", "preemptions"):
        assert tm[key] == jm[key], key


def test_serve_cli_runs_on_cpu():
    out = serve.main(["--device", "cpu", "--batches", "2", "--batch-size",
                      "3", "--cache-len", "32"])
    assert out["completed"] == 6
    assert sum(out["per_mode"].values()) == 6


def test_serve_cli_refuses_meshes_naming_the_multi_device_slice():
    """``serve --mesh 2,1`` serves (the mesh shapes the arms' runners, as
    in the reference); only a mesh spec that names no shape is refused."""
    out = serve.main(["--device", "cpu", "--mesh", "2,1", "--batches", "1",
                      "--batch-size", "2", "--cache-len", "32"])
    assert out["completed"] == 2
    with pytest.raises(ValueError):
        serve.main(["--device", "cpu", "--mesh", "two,one"])


def test_cuda_without_a_card_raises(tiny_cfg, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchBackend(port_cfg(tiny_cfg))


@pytest.mark.parametrize("knob", [
    dict(fleet="disagg", fleet_devices=("cpu", "cuda:1"))])
def test_unported_knobs_raise(tiny_cfg, knob, monkeypatch):
    """Every knob is ported; what still raises is a request the backend
    cannot honour: a fleet device that is not there (nothing falls back to
    the CPU), and a pool of fleet devices on a process-group mesh (a mesh
    serves the colocated paged path, as the default ``decode="auto"``
    shows, the disaggregated one on the runners' views, and the gang
    path)."""
    from repro_torch.launch.mesh import Mesh, MeshShape
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchBackend(port_cfg(tiny_cfg), device="cpu", **knob)
    ranks = Mesh.__new__(Mesh)
    MeshShape.__init__(ranks, (1, 2))
    ranks.rank, ranks.coords = 0, {"data": 0, "model": 0}
    ranks.backend, ranks.device = "gloo", torch.device("cpu")
    assert set(TorchBackend(port_cfg(tiny_cfg), device="cpu",
                            mesh=ranks)._paged) == {LAYER, SEMANTIC}
    from repro_torch.dist.api import PagedView
    tb = TorchBackend(port_cfg(tiny_cfg), device="cpu", mesh=ranks,
                      fleet="disagg")
    assert set(tb._disagg) == {LAYER, SEMANTIC} and not tb._paged
    assert all(isinstance(w.model, PagedView)
               for pf, dc, _ in tb._disagg.values() for w in (pf, dc))
    with pytest.raises(ValueError, match="queue 4 item 3"):
        TorchBackend(port_cfg(tiny_cfg), device="cpu", mesh=ranks, **knob)


def test_moe_config_raises():
    """MoE FFNs are served; only expert parallelism (a training-mesh
    option) raises, once a forward reaches the MoE FFN."""
    from repro_torch.configs.base import get_config
    cfg = get_config("qwen2-moe-a2.7b").reduced().replace(
        expert_parallel_axis="model")
    tb = TorchBackend(cfg, device="cpu", arms=(LAYER,), cache_len=32)
    eng = PlacementEngine(FixedPolicy(LAYER, placement=None), tb)
    eng.submit([Request(rid=0, app_id=0, sla_s=5.0, max_new=2,
                        tokens=np.arange(5, dtype=np.int32))])
    with pytest.raises(NotImplementedError, match="expert-parallel MoE"):
        eng.drain()


# ------------------------------------------------------------- import rules
def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_imports_neither_jax_nor_repro():
    """AST scan: no ``import jax`` / ``jax.*`` and nothing of ``repro``."""
    bad = []
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            elif isinstance(node, ast.Call) and getattr(
                    node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                    isinstance(node.args[0], ast.Constant):
                names = [str(node.args[0].value)]
            for n in names:
                root = n.split(".")[0]
                if root in ("jax", "jaxlib", "repro"):
                    bad.append(f"{path.relative_to(ROOT)}: {n}")
    assert not bad, bad


def test_port_imports_with_jax_blocked():
    """Every port module and chip_smoke import with ``jax`` unimportable."""
    mods = [".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
            for p in sorted(PORT.rglob("*.py"))]
    mods = [m[:-len(".__init__")] if m.endswith(".__init__") else m
            for m in mods]
    code = (
        "import sys, importlib, importlib.util\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "spec = importlib.util.spec_from_file_location("
        f"'chip_smoke', {str(ROOT / 'chip_smoke.py')!r})\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("ok")
