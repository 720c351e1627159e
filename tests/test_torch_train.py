"""Port training path against the JAX package, on the CPU.

The same weights (JAX init, bridged through numpy) and the same batches go
through both packages; everything is f32.  Tolerances, each with its reason:

- loss to rel 1e-5 and every gradient leaf to 1e-5 (1 + max |g|): the same
  products summed in another order (XLA's fusions vs PyTorch's kernels);
- AdamW to 1e-6: one step's arithmetic on identical inputs;
- batches and checkpoints: bit-equal (numpy data, npz round trips);
- the training launchers' loss trajectories: see ``test_train_main_matches``.

At S = 2048 every attention layer takes the flash path (the plain forward
on the CPU) with the chunked recompute backward, in both packages.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import checkpoint as jckpt  # noqa: E402
from repro.configs.base import get_config  # noqa: E402
from repro.data import pipeline as jdata  # noqa: E402
from repro.dist import api as japi  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.checkpoint import checkpoint as tckpt  # noqa: E402
from repro_torch.data import pipeline as tdata  # noqa: E402
from repro_torch.dist import api as tapi  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402

from test_torch_paged import np_tree, port_cfg  # noqa: E402


def _batch(cfg, b, s, seed=0):
    """Tokens over the full vocab (a semantic config's ``vocab_size`` is
    one branch's shard: the other ids reach past its table)."""
    rng = np.random.default_rng(seed)
    vocab = cfg.vocab_size * cfg.n_branches
    toks = rng.integers(0, vocab, (b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _assert_tree_close(got, want, tol=1e-5):
    """Every leaf within tol (1 + max |want|) of its JAX twin."""
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], dict):
            _assert_tree_close(got[k], want[k], tol)
            continue
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k], w, rtol=0, atol=tol * (
            1 + float(np.abs(w).max())), err_msg=k)


def _port_loss_and_grads(cfg, params, batch, remat):
    model = bridge.model_from_params(port_cfg(cfg), np_tree(params))
    model.requires_grad_(True)
    tree = model.param_tree()
    leaves = tapi.tree_leaves(tree)
    loss = model.loss_chunked(tree, _tbatch(batch), remat=remat)
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), bridge.tree_to_numpy(
        tapi.tree_unflatten(tree, grads))


@pytest.mark.parametrize("which", ["dense", "semantic", "moe"])
def test_loss_chunked_and_grads_match_jax(tiny_cfg, which):
    """``loss_chunked`` and its gradients on the tiny config, its
    two-branch semantic variant and reduced qwen2-moe (aux term included),
    at S = 2048 (the flash path), with remat on the first."""
    cfg = {"dense": tiny_cfg, "semantic": tiny_cfg.semantic(2),
           "moe": get_config("qwen2-moe-a2.7b").reduced()}[which]
    if which == "moe":
        cfg = cfg.replace(d_model=64, n_heads=2, n_kv_heads=2, head_dim=32,
                          vocab_size=128, moe=dataclasses.replace(
                              cfg.moe, d_ff=64))
    remat = which == "dense"
    model = jbuild(cfg)
    params = model.init(jax.random.PRNGKey(0))
    batch = _batch(cfg, 1, 2048)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: model.loss_chunked(p, {k: jnp.asarray(v) for k, v in
                                         batch.items()}, remat=remat)))(
        params)
    if which == "moe":
        h, aux = jax.jit(lambda p: model.hidden(p, {k: jnp.asarray(v) for
                                                    k, v in batch.items()}))(
            params)
        assert float(aux) > 0
    loss, grads = _port_loss_and_grads(cfg, params, batch, remat)
    assert abs(loss - float(jloss)) <= 1e-5 * abs(float(jloss))
    _assert_tree_close(grads, np_tree(jgrads))


@pytest.mark.parametrize("which", ["dense", "semantic"])
def test_forward_and_masked_loss_match_jax(tiny_cfg, which):
    """``forward`` logits (merged over both vocab shards on the semantic
    variant) and the unchunked ``loss`` with a ``loss_mask``, at S = 64 (the
    dense ``sdpa`` path), without grad: to rel 1e-5."""
    cfg = tiny_cfg.semantic(2) if which == "semantic" else tiny_cfg
    model = jbuild(cfg)
    params = model.init(jax.random.PRNGKey(3))
    batch = _batch(cfg, 2, 64, seed=3)
    batch["loss_mask"] = (np.random.default_rng(4).random((2, 64))
                          < 0.7).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jlogits, _ = model.forward(params, jb)
    jloss = model.loss(params, jb)
    tmodel = bridge.model_from_params(port_cfg(cfg), np_tree(params))
    with torch.no_grad():
        logits, _ = tmodel.forward(tmodel.param_tree(), _tbatch(batch))
        loss = tmodel.loss(tmodel.param_tree(), _tbatch(batch))
    want = np.asarray(jlogits)
    assert logits.shape == want.shape == (2, 64, 128)
    np.testing.assert_allclose(logits.numpy(), want, rtol=0,
                               atol=1e-5 * (1 + np.abs(want).max()))
    assert abs(float(loss) - float(jloss)) <= 1e-5 * float(jloss)


def test_adamw_update_matches_jax():
    """Two steps from a carried state, with clipping active (the grads'
    norm is above 1) and weight decay: params and moments to 1e-6; the
    state crosses the bridge both ways."""
    rng = np.random.default_rng(0)
    shapes = {"a": (4, 8), "b": {"c": (16,), "d": (3, 2, 5)}}
    mk = lambda t, s=1.0: {k: mk(v, s) if isinstance(v, dict) else
                           (rng.normal(size=v) * s).astype(np.float32)
                           for k, v in t.items()}
    params = mk(shapes)
    jp = jax.tree.map(jnp.asarray, params)
    jopt = jadamw.adamw_init(jp)
    tp = bridge.tree_from_numpy(params)
    topt = tadamw.adamw_init(tp)
    for _ in range(2):
        grads = mk(shapes, 3.0)
        assert float(jadamw.global_norm(grads)) > 1.0
        jp, jopt = jadamw.adamw_update(jax.tree.map(jnp.asarray, grads),
                                       jopt, jp, lr=3e-3)
        tp, topt = tadamw.adamw_update(bridge.tree_from_numpy(grads), topt,
                                       tp, lr=3e-3)
        _assert_tree_close(bridge.tree_to_numpy(tp), np_tree(jp), 1e-6)
        # carry the state across: JAX -> port -> JAX
        topt = bridge.opt_state_from_numpy(np_tree(jopt))
        jopt = jadamw.AdamWState(*jax.tree.map(
            jnp.asarray, bridge.opt_state_to_numpy(topt)))
    assert topt.step == int(jopt.step) == 2
    _assert_tree_close(bridge.tree_to_numpy(topt.m), np_tree(jopt.m), 1e-6)
    _assert_tree_close(bridge.tree_to_numpy(topt.v), np_tree(jopt.v), 1e-6)


def test_cosine_schedule_matches_jax():
    j, t = jadamw.cosine_schedule(3e-3, 5, 50), tadamw.cosine_schedule(
        3e-3, 5, 50)
    for step in (0, 1, 4, 5, 6, 27, 49, 50, 80):
        assert abs(t(step) - float(j(step))) <= 1e-9


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "whisper-base"])
def test_batches_for_bit_equal(arch):
    cfg = get_config(arch).reduced()
    jb = jdata.batches_for(cfg, seq_len=64, global_batch=4, seed=3)
    tb = tdata.batches_for(port_cfg(cfg), seq_len=64, global_batch=4, seed=3)
    for _ in range(3):
        a, b = next(jb), next(tb)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_checkpoints_cross_load(tiny_cfg, tmp_path):
    """Params and an AdamW state written by either package load in the
    other, bit-equal, under the same ``/``-joined keys."""
    params = jbuild(tiny_cfg).init(jax.random.PRNGKey(2))
    opt = jadamw.adamw_init(params)
    opt = opt._replace(step=jnp.asarray(7, jnp.int32), m=jax.tree.map(
        lambda p: p * 0.5, params))
    jckpt.save(str(tmp_path / "j.npz"), (params, opt), step=7)

    tparams = bridge.tree_from_numpy(np_tree(params))
    topt = bridge.opt_state_from_numpy(np_tree(opt))
    target = (jax.tree.map(lambda x: torch.zeros(x.shape), tparams),
              tadamw.adamw_init(tparams)._replace(step=0))
    got_p, got_o = tckpt.restore(str(tmp_path / "j.npz"), target)
    _assert_tree_close(bridge.tree_to_numpy(got_p), np_tree(params), 0)
    assert got_o.step == 7 and isinstance(got_o, tadamw.AdamWState)
    _assert_tree_close(bridge.tree_to_numpy(got_o.m), np_tree(opt.m), 0)

    tckpt.save(str(tmp_path / "t.npz"), (tparams, topt), step=7)
    assert set(np.load(tmp_path / "t.npz")) == set(np.load(tmp_path /
                                                           "j.npz"))
    back = jckpt.restore(str(tmp_path / "t.npz"), (params, opt))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves((params, opt))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert tckpt.latest_step(str(tmp_path)) is None


@pytest.mark.parametrize("mode,n_micro", [
    ("fsdp", None), ("semantic", None), ("pipeline", 2)])
def test_runner_value_and_grad_match_jax(tiny_cfg, tiny_mesh, mode,
                                         n_micro):
    """The three runners' ``value_and_grad`` (the semantic runner takes two
    branches on a 1 x 1 mesh; the gspmd pipeline accumulates two
    microbatches) at B = 2, S = 256, from the same weights."""
    jr = japi.build_runner(tiny_cfg, mode, tiny_mesh,
                           n_microbatches=n_micro)
    tr = tapi.build_runner(port_cfg(tiny_cfg), mode, (1, 1),
                           n_microbatches=n_micro, device="cpu")
    assert tr.cfg.n_branches == jr.cfg.n_branches
    params = jr.init(jax.random.PRNGKey(1))
    batch = _batch(tiny_cfg, 2, 256, seed=1)
    jloss, jgrads = jax.jit(lambda p: jr.value_and_grad(
        p, {k: jnp.asarray(v) for k, v in batch.items()}, remat=True))(
        params)
    tree = tr.init(seed=0)
    bridge.load_params(tr.model, np_tree(params))
    loss, grads = tr.value_and_grad(tree, _tbatch(batch), remat=True)
    assert abs(float(loss) - float(jloss)) <= 1e-5 * abs(float(jloss))
    _assert_tree_close(bridge.tree_to_numpy(grads), np_tree(jgrads))


def test_runner_multi_device_paths_raise(tiny_cfg):
    """The refusals the multi-device runners keep: a mesh larger than the
    world (no process group here), expert parallelism with n_experts not
    divisible by 'model', and a stage split with n_superblocks not
    divisible by the stage count (the reference's messages)."""
    from repro_torch.configs.base import get_config as tget
    from repro_torch.launch.mesh import MeshShape
    cfg = port_cfg(tiny_cfg)
    for mode, mesh in (("fsdp", (2, 1)), ("pipeline", "1,2"),
                       ("semantic", (1, 4))):
        with pytest.raises(ValueError, match="larger than the world"):
            tapi.build_runner(cfg, mode, mesh, device="cpu")
    with pytest.raises(ValueError, match="larger than the world"):
        tapi.build_runner(cfg, "fsdp", MeshShape((2, 1)),
                          device="cpu").init(seed=0)
    moe = tget("qwen2-moe-a2.7b").reduced()            # 4 experts
    with pytest.raises(ValueError, match="divisible"):
        tapi.build_runner(moe, "pipeline", MeshShape((1, 3)),
                          expert_parallel=True, schedule="1f1b",
                          device="cpu")
    r = tapi.build_runner(cfg, "pipeline", MeshShape((1, 3)),
                          schedule="1f1b", device="cpu")
    assert cfg.n_superblocks % 3
    with pytest.raises(ValueError, match="divisible"):
        r.param_specs(r.model.param_tree())


def test_train_main_matches(monkeypatch, capsys):
    """Both launchers with the same flags, the port's starting from the JAX
    launcher's initial weights (``PRNGKey(0)``).  The first loss agrees to
    rel 1e-5 (the same forward).  Later losses are held to rel 1e-4, not
    1e-5: AdamW's first step is sign-like (mhat / sqrt(vhat) = sign(g) at
    step 1), so a gradient element within float noise of 0 can move its
    weight by +lr in one package and -lr in the other, and such flips
    accumulate over steps (on this run the trajectories agree to f32
    precision)."""
    flags = ["--arch", "stablelm-1.6b", "--reduced", "--seq-len", "2048",
             "--batch", "1", "--steps", "3", "--lr", "3e-3",
             "--log-every", "1"]
    jlosses = jtrain.main(flags)
    cfg = get_config("stablelm-1.6b").reduced().replace(dtype="float32")
    init = np_tree(jbuild(cfg).init(jax.random.PRNGKey(0)))

    def init_from_jax(self, seed=0):
        self.model = bridge.model_from_params(self.cfg, init)
        self.model.requires_grad_(True)
        return self.model.param_tree()

    monkeypatch.setattr(tapi.BaseRunner, "init", init_from_jax)
    before = tfa.flash_attention.launches
    tlosses = ttrain.main(flags + ["--device", "cpu"])
    assert tfa.flash_attention.launches == before     # CPU: no launches
    assert len(tlosses) == len(jlosses) == 3
    assert abs(tlosses[0] - jlosses[0]) <= 1e-5 * jlosses[0]
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    assert tlosses[-1] < tlosses[0]
    out = capsys.readouterr().out
    assert "first-10 mean" in out
