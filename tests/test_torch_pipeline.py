"""Port explicit pipeline schedules (``repro_torch.dist.pipeline``'s tick
tables and stage-graph executor) against the JAX package, on the CPU.

The tick tables are pure Python and numpy in both packages and must be
equal exactly.  The executor runs at S = 1 (a 1 x 1 mesh) in both; loss and
gradients are held to JAX's ``stage_graph_*`` and to the port's fsdp runner
within 1e-5, the limit of ``tests/test_pipeline_schedules.py``: the same
products summed in another order.  One case runs two stages on the one
device, which exercises the payload and cotangent buffers the S = 1 walk
leaves at their zero slots.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import get_config  # noqa: E402
from repro.dist import api as japi  # noqa: E402
from repro.dist import pipeline as JPL  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.dist import api as tapi  # noqa: E402
from repro_torch.dist import pipeline as TPL  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402

from test_torch_paged import np_tree, port_cfg  # noqa: E402

TABLES = ("f_mb", "f_read", "f_save", "f_wslot", "b_mb", "b_slot", "b_read",
          "b_wslot")
FIELDS = ("kind", "n_stages", "n_micro", "ticks", "n_fwd_slots",
          "n_saved_slots", "n_bwd_slots", "n_ops", "bubble_fraction",
          "peak_saved_microbatches", "n_transfers")


# ---------------------------------------------------------- schedule tables
def _schedule_cases():
    for kind in ("gpipe", "1f1b"):
        for S, M in ((1, 4), (2, 4), (4, 8), (4, 16), (3, 6)):
            yield kind, S, M, {}
    for S, M in ((2, 4), (4, 8), (4, 16), (3, 6)):
        yield "gpipe", S, M, {"memory_budget": S}
    yield "1f1b", 3, 6, {"forward_only": True}


@pytest.mark.parametrize("kind,S,M,kw", list(_schedule_cases()))
def test_build_schedule_equal(kind, S, M, kw):
    want = JPL.build_schedule(kind, S, M, **kw)
    got = TPL.build_schedule(kind, S, M, **kw)
    for name in TABLES:
        assert np.array_equal(getattr(got, name), getattr(want, name)), name
        assert getattr(got, name).dtype == np.int32
    for name in FIELDS:
        assert getattr(got, name) == getattr(want, name), name


def test_unknown_schedule_refused(tiny_cfg):
    with pytest.raises(ValueError, match="unknown schedule"):
        TPL.build_schedule("pipedream", 2, 4)
    with pytest.raises(ValueError, match="unknown schedule"):
        tapi.build_runner(port_cfg(tiny_cfg), "pipeline",
                          schedule="pipedream", device="cpu")


@pytest.mark.parametrize("schedule,budget", [
    ("gspmd", None), ("gpipe", None), ("gpipe", 2), ("1f1b", None)])
def test_schedule_stats_equal(tiny_cfg, tiny_mesh, schedule, budget):
    want = japi.build_runner(tiny_cfg, "pipeline", tiny_mesh,
                             n_microbatches=4, schedule=schedule,
                             memory_budget=budget).schedule_stats(8, 16)
    got = tapi.build_runner(port_cfg(tiny_cfg), "pipeline",
                            n_microbatches=4, schedule=schedule,
                            memory_budget=budget,
                            device="cpu").schedule_stats(8, 16)
    assert got == want
    assert ("ticks" in got) == (schedule != "gspmd")


# ------------------------------------------------- executor (1x1 degenerate)
def _batch(cfg, b=4, s=8):
    rng = np.random.default_rng(0)
    return {k: rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
            for k in ("tokens", "labels")}


def _max_diff(got, want):
    return max(float(np.abs(np.asarray(g) - np.asarray(w)).max())
               for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)))


@pytest.fixture(scope="module")
def jax_runs(tiny_cfg, tiny_mesh):
    """JAX PRNGKey(0) weights, fsdp's (loss, grads) and, per case, the JAX
    stage graph's (loss, (loss, grads)), computed once."""
    batch = {k: jnp.asarray(v) for k, v in _batch(tiny_cfg).items()}
    fsdp = japi.build_runner(tiny_cfg, "fsdp", tiny_mesh)
    params = jax.jit(fsdp.init)(jax.random.PRNGKey(0))
    cache = {}

    def stage(schedule, m, budget, remat):
        key = (schedule, m, budget, remat)
        if key not in cache:
            r = japi.build_runner(tiny_cfg, "pipeline", tiny_mesh,
                                  n_microbatches=m, schedule=schedule,
                                  memory_budget=budget)
            loss = jax.jit(lambda p: r.loss(p, batch, remat=remat))(params)
            lv, g = jax.jit(lambda p: r.value_and_grad(
                p, batch, remat=remat))(params)
            cache[key] = float(loss), float(lv), np_tree(g)
        return cache[key]

    l_ref, g_ref = jax.jit(lambda p: fsdp.value_and_grad(p, batch))(params)
    return np_tree(params), float(l_ref), np_tree(g_ref), stage


def _port(tiny_cfg, params):
    """The port's fsdp runner on the bridged weights and its (loss,
    grads)."""
    fsdp = tapi.build_runner(port_cfg(tiny_cfg), "fsdp", device="cpu")
    fsdp.model = bridge.model_from_params(fsdp.cfg, params)
    fsdp.model.requires_grad_(True)
    tree = fsdp.model.param_tree()
    batch = {k: torch.from_numpy(v) for k, v in _batch(tiny_cfg).items()}
    loss, grads = fsdp.value_and_grad(tree, batch)
    return fsdp.model, tree, batch, float(loss), \
        bridge.tree_to_numpy(grads)


@pytest.mark.parametrize("schedule,m,budget,remat", [
    ("gpipe", 2, None, False), ("1f1b", 2, None, False),
    ("gpipe", 4, 2, False), ("1f1b", 2, None, True)])
def test_stage_graph_matches_jax_and_fsdp(tiny_cfg, jax_runs, schedule, m,
                                          budget, remat):
    params, jl_ref, jg_ref, stage = jax_runs
    jloss, jlv, jg = stage(schedule, m, budget, remat)
    model, tree, batch, tl_ref, tg_ref = _port(tiny_cfg, params)
    r = tapi.build_runner(model.cfg, "pipeline", n_microbatches=m,
                          schedule=schedule, memory_budget=budget,
                          device="cpu")
    r.model = model
    loss = float(r.loss(tree, batch, remat=remat))
    lv, g = r.value_and_grad(tree, batch, remat=remat)
    g = bridge.tree_to_numpy(g)
    assert abs(loss - jloss) < 1e-5 and abs(float(lv) - jlv) < 1e-5
    assert abs(float(lv) - tl_ref) < 1e-5 and abs(tl_ref - jl_ref) < 1e-5
    assert _max_diff(g, jg) < 1e-5
    assert _max_diff(g, tg_ref) < 1e-5
    assert _max_diff(g, jg_ref) < 1e-5


def test_stage_graph_two_stages_on_one_device(tiny_cfg, jax_runs):
    """S = 2: stage 0 sends its payload forward and stage 1 its cotangent
    back through the ring buffers; the result is fsdp's."""
    params, _, _, _ = jax_runs
    model, tree, batch, tl_ref, tg_ref = _port(tiny_cfg, params)
    assert model.cfg.n_superblocks % 2 == 0
    for schedule in ("gpipe", "1f1b"):
        loss = TPL.stage_graph_loss(model, tree, batch, (1, 2),
                                    schedule=schedule, n_micro=4)
        lv, g = TPL.stage_graph_value_and_grad(
            model, tree, batch, (1, 2), schedule=schedule, n_micro=4)
        assert abs(float(loss) - tl_ref) < 1e-5
        assert abs(float(lv) - tl_ref) < 1e-5
        g = bridge.tree_to_numpy(tapi.tree_unflatten(tree, g))
        assert _max_diff(g, tg_ref) < 1e-5


def test_stage_graph_refusals(tiny_cfg, jax_runs):
    whisper = port_cfg(get_config("whisper-base").reduced())
    r = tapi.build_runner(whisper, "pipeline", schedule="1f1b", device="cpu")
    tree = r.init(seed=0)
    batch = {"tokens": torch.zeros(2, 8, dtype=torch.int32),
             "labels": torch.zeros(2, 8, dtype=torch.int32),
             "audio_embeds": torch.zeros(
                 2, whisper.frontend.n_tokens, whisper.frontend.d_frontend)}
    with pytest.raises(ValueError, match="decoder-only"):
        r.loss(tree, batch)
    with pytest.raises(ValueError, match="decoder-only"):
        r.value_and_grad(tree, batch)
    model, tree, batch, _, _ = _port(tiny_cfg, jax_runs[0])
    with pytest.raises(ValueError, match="must split into n_microbatches=3"):
        TPL.stage_graph_value_and_grad(model, tree, batch, (1, 1),
                                       schedule="1f1b", n_micro=3)


# ----------------------------------------------------------- the launcher
def test_train_main_1f1b_matches(monkeypatch, capsys):
    """Both launchers with ``--mode pipeline --schedule 1f1b``, the port's
    from the JAX launcher's initial weights: the printed schedule stats are
    equal, the first loss to rel 1e-5 and the later ones to rel 1e-4 (see
    ``tests/test_torch_train.py::test_train_main_matches``)."""
    flags = ["--arch", "stablelm-1.6b", "--reduced", "--seq-len", "64",
             "--batch", "2", "--steps", "3", "--lr", "3e-3",
             "--log-every", "1", "--mode", "pipeline", "--schedule", "1f1b",
             "--n-microbatches", "2"]
    jlosses = jtrain.main(flags)
    jstats = [ln for ln in capsys.readouterr().out.splitlines()
              if ln.startswith("schedule:")]
    cfg = get_config("stablelm-1.6b").reduced().replace(dtype="float32")
    init = np_tree(jbuild(cfg).init(jax.random.PRNGKey(0)))

    def init_from_jax(self, seed=0):
        self.model = bridge.model_from_params(self.cfg, init)
        self.model.requires_grad_(True)
        return self.model.param_tree()

    monkeypatch.setattr(tapi.BaseRunner, "init", init_from_jax)
    tlosses = ttrain.main(flags + ["--device", "cpu"])
    tstats = [ln for ln in capsys.readouterr().out.splitlines()
              if ln.startswith("schedule:")]
    assert tstats == jstats and "'ticks': 4" in tstats[0]
    assert len(tlosses) == len(jlosses) == 3
    assert abs(tlosses[0] - jlosses[0]) <= 1e-5 * jlosses[0]
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    assert tlosses[-1] < tlosses[0]
