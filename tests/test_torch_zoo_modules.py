"""The port's model zoo against the JAX package, continued
(``tests/test_torch_zoo.py`` holds the forwards and decode steps of all
ten configs, and states the tolerances these tests share): the semantic
split of the new mixers and frontends, ``value_and_grad``, each new mixer
alone on the JAX init's weights, a JAX init loaded into the port, and the
gradient of the mLSTM's block-diagonal product.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models.model import build_model as jbuild  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.kernels.block_diag_matmul import \
    block_diag_matmul_plain  # noqa: E402
from repro_torch.models.xlstm import BlockDiagMatmul  # noqa: E402

from test_models import make_batch  # noqa: E402
from test_torch_paged import np_tree, port_cfg  # noqa: E402
from test_torch_zoo import (_decode_both, close, jax_forward,  # noqa: E402
                            nudge, pair, tbatch, zoo_cfg)


@pytest.mark.parametrize("name", ["xlstm-125m", "gemma2-27b",
                                  "whisper-base", "internvl2-26b"])
def test_semantic_forward_and_decode_equal_jax(name):
    """The semantic split (two branches side by side) of the new mixers and
    frontends."""
    tmodel = pair(name, semantic=True)[3]
    batch, want, nudged = jax_forward(name, semantic=True)
    got, _ = tmodel.forward(tmodel.param_tree(), tbatch(batch))
    close(got, want[0], nudged[0], what="semantic logits")
    close(*_decode_both(name, 3, semantic=True),
          what="semantic decode logits")


@pytest.mark.parametrize("name", ["xlstm-125m", "jamba-1.5-large-398b",
                                  "whisper-base", "internvl2-26b"])
def test_value_and_grad_equals_jax(name):
    """The loss and every gradient leaf, each leaf held as ``close`` holds
    logits (leaves whose JAX gradient is 0 everywhere must be 0)."""
    cfg, jmodel, params, _ = pair(name)
    tmodel = bridge.model_from_params(port_cfg(cfg), np_tree(params))
    tmodel.requires_grad_(True)       # a copy: ``pair``'s model stays frozen
    batch = make_batch(cfg, 2, 8, seed=4)
    vg = jax.jit(jax.value_and_grad(jmodel.loss))
    (jloss, jgrads), (nloss, ngrads) = vg(params, batch), \
        vg(nudge(params), batch)
    tree = tmodel.param_tree()
    tloss = tmodel.loss(tree, tbatch(batch))
    leaves = dict(tmodel.named_parameters())
    names = list(leaves)
    grads = torch.autograd.grad(tloss, [leaves[n] for n in names],
                                allow_unused=True)
    close(tloss, jloss, nloss, what="loss")
    for n, g in zip(names, grads):
        want, nudged = jgrads, ngrads
        for part in n.split("."):
            want, nudged = want[part], nudged[part]
        want = np.asarray(want)
        got = torch.zeros(want.shape) if g is None else g
        if not np.abs(want).max() > 0:
            assert float(got.abs().max()) == 0.0, n
            continue
        close(got, want, nudged, what=n)


def _jax_mixer(kind):
    from repro.models import ssm as JS
    from repro.models import xlstm as JX
    return {"mamba": (JS.mamba_init, JS.mamba_apply, JS.mamba_init_state),
            "mlstm": (JX.mlstm_init, JX.mlstm_apply, JX.mlstm_init_state),
            "slstm": (JX.slstm_init, JX.slstm_apply,
                      JX.slstm_init_state)}[kind]


@pytest.mark.parametrize("kind,name", [
    ("mamba", "jamba-1.5-large-398b"), ("mlstm", "xlstm-125m"),
    ("slstm", "xlstm-125m")])
def test_mixers_equal_jax(kind, name):
    """Each new mixer alone on the JAX init's weights (bridged, with the
    branch dim G = 1): a 16-step full-sequence forward, then four decode
    steps from the zero state, outputs and states to 1e-4.  The mLSTM's
    per-head projections run through ``block_diag_matmul`` here."""
    from repro_torch.models import ssm as TS
    from repro_torch.models import xlstm as TX
    init, japply, jstate = _jax_mixer(kind)
    tapply = {"mamba": TS.mamba_apply, "mlstm": TX.mlstm_apply,
              "slstm": TX.slstm_apply}[kind]
    cfg = zoo_cfg(name)
    params = init(jax.random.PRNGKey(3), cfg)
    tp = {k: torch.from_numpy(np.array(v))[None] for k, v in params.items()}
    x = np.random.default_rng(6).normal(size=(2, 16, cfg.d_model)).astype(
        np.float32)
    tx = torch.from_numpy(x)[None]
    jfwd = jax.jit(lambda p, x: japply(p, x, cfg)[0])
    jstep = jax.jit(lambda p, x, st: japply(p, x, cfg, state=st))
    want = jfwd(params, jnp.asarray(x))
    got, _ = tapply(tp, tx, port_cfg(cfg))
    close(got[0], want, what=f"{kind} forward")
    js = jstate(cfg, 2, jnp.float32) if kind == "mamba" else jstate(cfg, 2)
    ts = bridge.tree_from_numpy(np_tree(js)) if kind == "mamba" else tuple(
        torch.from_numpy(np.array(a)) for a in js)
    ts = jax.tree.map(lambda t: t[None], ts)
    for i in range(4):
        want, js = jstep(params, jnp.asarray(x[:, i:i + 1]), js)
        got, ts = tapply(tp, tx[:, :, i:i + 1], port_cfg(cfg), state=ts)
        close(got[0], want, what=f"{kind} step {i}")
    for a, b in zip(jax.tree.leaves(ts), jax.tree.leaves(js)):
        close(a[0], b, what=f"{kind} state")


@pytest.mark.parametrize("seq,chunk", [(39, 13)])
def test_mamba_scan_chunks_equal_jax(seq, chunk):
    """jamba's chunked Mamba scan over several chunks whose length is not a
    power of two (13: odd at the top of the recursion, even below it): y,
    the state each chunk carries out and the gradients of the parameters
    and the input against JAX (``mamba_chunked_scan``, its states from one
    associative scan over the sequence; one jitted call) within 1e-4, and
    against the per-step loop (``_scan_chunk_steps``)."""
    from repro.models import ssm as JS
    from repro_torch.models import ssm as TS
    cfg = zoo_cfg("jamba-1.5-large-398b")
    tcfg = port_cfg(cfg)
    params = JS.mamba_init(jax.random.PRNGKey(3), cfg)
    din = cfg.ssm_expand * cfg.d_model
    rng = np.random.default_rng(9)
    xc = (0.5 * rng.normal(size=(2, seq, din))).astype(np.float32)
    cot = rng.normal(size=(2, seq, din)).astype(np.float32)
    def jscan(p, x):
        y = JS.mamba_chunked_scan(p, x, cfg, chunk=chunk)
        return jnp.sum(y * cot), y

    def jstates(p, x):          # h_t over the whole sequence from zero
        a, bx, _ = JS._ssm_params(p, x, cfg)
        return jax.lax.associative_scan(
            lambda c1, c2: (c1[0] * c2[0], c2[0] * c1[1] + c2[1]), (a, bx),
            axis=1)[1]
    (_, want), jgrads, jh = jax.jit(lambda p, x: (
        *jax.value_and_grad(jscan, argnums=(0, 1), has_aux=True)(p, x),
        jstates(p, x)))(params, jnp.asarray(xc))
    tp = {k: torch.from_numpy(np.array(v))[None].requires_grad_(True)
          for k, v in params.items()}
    tx = torch.from_numpy(xc)[None].requires_grad_(True)

    def grad(y, cot):       # the scan reads x_proj, dt_bias and A_log only
        leaves = [tx, *tp.values()]
        gs = torch.autograd.grad((y * torch.from_numpy(cot)[None]).sum(),
                                 leaves, allow_unused=True)
        return [torch.zeros_like(t) if g is None else g
                for t, g in zip(leaves, gs)]
    got = TS.mamba_chunked_scan(tp, tx, tcfg, chunk=chunk)
    close(got[0], want, what="mamba chunked scan")
    grads = grad(got, cot)
    close(grads[0][0], jgrads[1], what="d xc")
    for k, g in zip(tp, grads[1:]):
        close(g[0], jgrads[0][k], what=f"d {k}")
    # the carried state and the loop oracle, chunk by chunk
    h = torch.zeros(1, 2, din, cfg.ssm_d_state)
    h_loop = h
    for c0 in range(0, seq, chunk):
        x_c = tx[:, :, c0:c0 + chunk]
        h, y = TS._scan_chunk(tp, h, x_c, tcfg)
        h_loop, y_loop = TS._scan_chunk_steps(tp, h_loop, x_c, tcfg)
        close(h[0], jh[:, c0 + chunk - 1], what="carried state")
        close(h, h_loop.detach(), what="state against the loop")
        close(y, y_loop.detach(), what="y against the loop")
    for k, g, w in zip(["xc", *tp], grad(y, cot[:, -chunk:]),
                       grad(y_loop, cot[:, -chunk:])):
        close(g, w, what=f"d {k} against the loop")


def test_mamba_scan_chunk_ops_grow_with_log_chunk():
    """One chunk of the scan issues a fixed number of aten ops a level of
    its log2(chunk)-deep recursion: each doubling of the chunk adds the
    same count, and a 512-step chunk issues far fewer than 512 (the
    per-step loop issued two a step)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.models import ssm as TS
    cfg = port_cfg(zoo_cfg("jamba-1.5-large-398b")).replace(
        d_model=4, ssm_d_state=2)
    din = cfg.ssm_expand * cfg.d_model
    gen = torch.Generator().manual_seed(0)
    params = {k: 0.1 * torch.randn((1,) + v, generator=gen)
              for k, v in TS.mamba_shapes(cfg).items()}

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, fn, types, args=(), kwargs=None):
            Count.n += 1
            return fn(*args, **(kwargs or {}))
    counts = {}
    for chunk in (64, 128, 256, 512):
        x = torch.randn(1, 1, chunk, din, generator=gen)
        h0 = torch.zeros(1, 1, din, cfg.ssm_d_state)
        Count.n = 0
        with Count():
            TS._scan_chunk(params, h0, x, cfg)
        counts[chunk] = Count.n
    steps = [counts[2 * c] - counts[c] for c in (64, 128, 256)]
    assert len(set(steps)) == 1 and steps[0] > 0, counts
    assert counts[512] < 512, counts


@pytest.mark.parametrize("name", ["whisper-base", "internvl2-26b"])
def test_jax_params_load_into_port(name):
    """A JAX init's tree loads by name into the port's model (the frontend
    projector, encoder stack and cross-attention leaves included) and the
    two forwards agree."""
    cfg = zoo_cfg(name)
    jmodel = jbuild(cfg)
    params = jmodel.init(jax.random.PRNGKey(0))
    tmodel = bridge.model_from_params(port_cfg(cfg), np_tree(params))
    assert {n for n, _ in tmodel.named_parameters()} == {
        ".".join(str(getattr(k, "key", k)) for k in path)
        for path, _ in jax.tree_util.tree_leaves_with_path(params)}
    batch = make_batch(cfg, 2, 8)
    want, _ = jax.jit(jmodel.forward)(params, batch)
    got, _ = tmodel.forward(tmodel.param_tree(), tbatch(batch))
    close(got, want, what="logits")


@pytest.mark.parametrize("shape", [(4, 8, 16, 16), (2, 33, 24, 40)])
def test_block_diag_function_grads_equal_einsum(shape):
    """``BlockDiagMatmul``'s forward and both gradients equal the plain
    einsum's autograd on the same inputs."""
    g, t, d, e = shape
    rng = np.random.default_rng(5)
    x0 = torch.from_numpy(rng.normal(size=(g, t, d)).astype(np.float32))
    w0 = torch.from_numpy(rng.normal(size=(g, d, e)).astype(np.float32))
    dy = torch.from_numpy(rng.normal(size=(g, t, e)).astype(np.float32))
    x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
    out = BlockDiagMatmul.apply(x, w)
    out.backward(dy)
    xr, wr = x0.clone().requires_grad_(), w0.clone().requires_grad_()
    ref = torch.einsum("gtd,gde->gte", xr, wr)
    ref.backward(dy)
    torch.testing.assert_close(out, block_diag_matmul_plain(x0, w0))
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(x.grad, xr.grad, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(w.grad, wr.grad, rtol=1e-5, atol=1e-5)
