"""The port's model zoo against the JAX package: all ten configs at their
``reduced()`` sizes in f32 on bridged weights (Mamba and xLSTM mixers,
gemma2's local attention, softcaps and ring buffers, whisper's encoder and
cross-attention, internvl's patch prefix, MoE FFNs): forwards and losses,
decode steps on dense and ring-buffer caches, whole-prompt prefill and the
runners' serving surface.  ``tests/test_torch_zoo_modules.py`` holds the
semantic split, gradients and the mixers alone.

Every float comparison is held to 1e-4 of the largest |reference| value
of the compared tensor (the same f32 math in another summation order), or
to 8 times what the reference itself moves by when every weight is scaled
by (1 + 2^-23), one f32 ulp, where that is larger: an f32 implementation
is not closer to the reference than the reference is to itself under a
one-ulp change of its inputs.  The reduced xlstm is the model where that
matters: the mLSTM's exponential gates and max(|q.n|, 1) normalizer make
its logits move by ~1e-3 of their largest under that nudge, ten times the
1e-4 rule; every other config is held to 1e-4.  The teacher-forced decode of a model must equal its own full-sequence
forward to 2e-3 / 3e-3 (atol and rtol), the tolerances
``tests/test_models.py`` holds the JAX package to.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import ASSIGNED, get_config  # noqa: E402
from repro.dist import api as JA  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro.models.model import cross_entropy  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.dist import api as TA  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

from test_models import make_batch  # noqa: E402
from test_torch_paged import np_tree, port_cfg  # noqa: E402

REL = 1e-4
NOISE = 8.0
ULP = 2.0 ** -23


def close(got, want, nudged=None, what=""):
    """max |got - want| within 1e-4 of max |want|, or NOISE x max |nudged -
    want| (the reference on weights one ulp off) where that is larger."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    lim = REL * max(float(np.abs(want).max()), 1e-30)
    if nudged is not None:
        lim = max(lim, NOISE * float(np.abs(np.asarray(nudged, np.float32)
                                            - want).max()))
    err = float(np.abs(got - want).max())
    assert err <= lim, f"{what}: max |port - jax| {err} > {lim}"


def nudge(params):
    """Every float weight scaled by (1 + one f32 ulp)."""
    return jax.tree.map(lambda a: a * (1 + ULP) if jnp.issubdtype(
        a.dtype, jnp.floating) else a, params)


def zoo_cfg(name: str):
    """``reduced()``, and one superblock where a superblock is 6-8 layers
    (jamba, xlstm)."""
    cfg = get_config(name).reduced()
    if len(cfg.pattern) > 2:
        cfg = cfg.replace(n_layers=len(cfg.pattern))
    return cfg


@functools.lru_cache(maxsize=None)
def pair(name: str, semantic: bool = False, window: int = 0):
    """(JAX cfg, JAX model, JAX params, port model) on the same weights:
    drawn by the port, carried to JAX through numpy (a JAX init of a
    Mamba stack takes seconds; ``test_jax_params_load_into_port`` holds
    the other direction)."""
    cfg = zoo_cfg(name)
    if window:
        cfg = cfg.replace(sliding_window=window)
    if semantic:
        cfg = cfg.semantic(2)
    tmodel = build_model(port_cfg(cfg), device="cpu").reset_parameters(
        torch.Generator().manual_seed(0))
    params = jax.tree.map(jnp.asarray,
                          bridge.tree_to_numpy(tmodel.param_tree()))
    return cfg, jbuild(cfg), params, tmodel


@functools.lru_cache(maxsize=None)
def jitted(name: str, semantic: bool = False, window: int = 0):
    """The JAX model's forward (logits and the loss, which reuses them:
    ``cross_entropy + 0.01 aux``, as ``Model.loss`` computes it) and its
    decode step, each compiled once per config."""
    jmodel = pair(name, semantic, window)[1]

    def fwd(p, b):
        logits, aux = jmodel.forward(p, b)
        return logits, cross_entropy(logits, b["labels"]) + 0.01 * aux

    dec = jax.jit(jmodel.decode_step, static_argnames="window_override")
    return jax.jit(fwd), dec


def tbatch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def jax_forward(name: str, semantic: bool = False):
    """The batch, and JAX's (logits, loss) on the weights and on the nudged
    weights."""
    cfg, _, params, _ = pair(name, semantic)
    batch = make_batch(cfg, 2, 16)
    fwd = jitted(name, semantic)[0]
    return batch, fwd(params, batch), fwd(nudge(params), batch)


@pytest.mark.parametrize("name", ASSIGNED)
def test_forward_and_losses_equal_jax(name):
    _, _, _, tmodel = pair(name)
    batch, want, nudged = jax_forward(name)
    tree, tb = tmodel.param_tree(), tbatch(batch)
    got, _ = tmodel.forward(tree, tb)
    close(got, want[0], nudged[0], what="logits")
    # the reference's chunked loss equals its loss (tests/test_models.py
    # holds the two within 1e-3); the port's is held to the loss here
    close(tmodel.loss(tree, tb), want[1], nudged[1], what="loss")
    close(tmodel.loss_chunked(tree, tb, chunk=8), want[1], nudged[1],
          what="chunked loss")


def _decode_both(name, steps, *, semantic=False, window=0,
                 window_override=None, cache_len=32, b=2):
    """Teacher-forced ``decode_step``s from fresh caches: the per-step
    logits [b, steps, vocab] of the port, of JAX and of JAX on the nudged
    weights."""
    cfg, jmodel, params, tmodel = pair(name, semantic, window)
    jdecode = jitted(name, semantic, window)[1]
    batch = make_batch(cfg, b, steps, seed=1)
    extra = batch if cfg.is_encdec else None

    def run_jax(p):
        cache, out = jmodel.init_cache(b, cache_len, window_override), []
        for i in range(steps):
            lg, cache = jdecode(p, cache, batch["tokens"][:, i:i + 1], i,
                                batch=extra, window_override=window_override)
            out.append(np.asarray(lg[:, 0]))
        return np.stack(out, 1)

    tc = tmodel.init_cache(b, cache_len, window_override)
    tb = tbatch(batch)
    tl = []
    for i in range(steps):
        lg, tc = tmodel.decode_step(None, tc, tb["tokens"][:, i:i + 1], i,
                                    batch=tb if cfg.is_encdec else None,
                                    window_override=window_override)
        tl.append(lg[:, 0])
    return torch.stack(tl, 1), run_jax(params), run_jax(nudge(params))


@pytest.mark.parametrize("name", ASSIGNED)
def test_decode_steps_equal_jax(name):
    """Three decode steps on the dense caches of ``init_cache``."""
    close(*_decode_both(name, 3), what="decode logits")


@pytest.mark.parametrize("name", ASSIGNED)
def test_window_override_decode_equals_jax(name):
    """``init_cache(window_override=4)`` makes every global-attention cache
    a 4-slot ring; six steps wrap it."""
    close(*_decode_both(name, 6, window_override=4),
          what="ring-buffer decode logits")


@pytest.mark.parametrize("name,tol", [("stablelm-1.6b", 2e-3),
                                      ("xlstm-125m", 3e-3)])
def test_teacher_forced_decode_equals_forward(name, tol):
    """The port's decode step by step equals its own full forward."""
    cfg, _, _, tmodel = pair(name)
    batch = tbatch(make_batch(cfg, 2, 8))
    full, _ = tmodel.forward(tmodel.param_tree(), batch)
    cache = tmodel.init_cache(2, 8)
    outs = []
    for i in range(8):
        lg, cache = tmodel.decode_step(None, cache,
                                       batch["tokens"][:, i:i + 1], i)
        outs.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(),
                               full.detach().numpy(), rtol=tol, atol=tol)


def test_gemma2_ring_buffer_past_wrap_equals_jax():
    """gemma2 with its local window cut to 8: 20 decode steps wrap the
    local layers' 8-slot rings twice (the global layers keep 32 slots),
    every step's logits equal to JAX's."""
    got, want, nudged = _decode_both("gemma2-27b", 20, window=8)
    assert pair("gemma2-27b", False, 8)[3].init_cache(2, 32)["pos0"][
        "k"].shape[-3] == 8
    for i in range(20):
        close(got[:, i], want[:, i], nudged[:, i], what=f"step {i}")


def test_prefill_cache_with_lengths_equals_jax():
    """Whole-prompt prefill into the dense cache, last logits at each
    row's true length, then a decode step on the filled cache."""
    cfg, jmodel, params, tmodel = pair("stablelm-1.6b")
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (3, 7))
    lengths = np.asarray([7, 4, 1], np.int32)
    jl, jc = jmodel.prefill_cache(params, jmodel.init_cache(3, 16),
                                  jnp.asarray(toks, jnp.int32),
                                  lengths=jnp.asarray(lengths))
    tl, tc = tmodel.prefill_cache(None, tmodel.init_cache(3, 16),
                                  torch.from_numpy(toks),
                                  lengths=torch.from_numpy(lengths))
    close(tl, jl, what="prefill logits")
    nxt = np.asarray(jl).argmax(-1)[:, None]
    jd, _ = jmodel.decode_step(params, jc, jnp.asarray(nxt, jnp.int32), 7)
    td, _ = tmodel.decode_step(None, tc, torch.from_numpy(nxt), 7)
    close(td, jd, what="decode after prefill")


def test_runner_serve_surface_equals_jax(tiny_cfg, tiny_mesh):
    """``BaseRunner``'s serving surface: ``prefill_into_cache`` then a
    ``make_serve_step`` step, both packages on one set of weights."""
    cfg = tiny_cfg
    jr = JA.build_runner(cfg, "fsdp", tiny_mesh)
    tr = TA.build_runner(port_cfg(cfg), "fsdp", device="cpu")
    params = jr.init(jax.random.PRNGKey(1))
    tr.init(seed=0)
    bridge.load_params(tr.model, np_tree(params))
    assert tr.supports_batched_prefill and jr.supports_batched_prefill
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 5))
    jl, jc = jr.prefill_into_cache(params, jr.init_cache(2, 8),
                                   jnp.asarray(toks, jnp.int32))
    tl, tc = tr.prefill_into_cache(None, tr.init_cache(2, 8),
                                   torch.from_numpy(toks))
    close(tl, jl, what="prefill_into_cache")
    nxt = np.asarray(jl).argmax(-1)[:, None].astype(np.int32)
    jl, _ = JA.make_serve_step(jr)(params, jc, {"tokens": jnp.asarray(nxt)},
                                   5)
    tl, _ = TA.make_serve_step(tr)(None, tc,
                                   {"tokens": torch.from_numpy(nxt)}, 5)
    close(tl, jl, what="serve_step")
    close(tr.prefill_step(tr.model.param_tree(),
                          {"tokens": torch.from_numpy(toks)}),
          jr.prefill_step(params, {"tokens": jnp.asarray(toks, jnp.int32)}),
          what="prefill_step")
