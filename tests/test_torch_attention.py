"""Port flash attention against the JAX package, on the CPU.

The JAX Pallas ``flash_attention`` does not run on this jax (it calls
``pl.load``), so the oracles are ``repro.kernels.ref.flash_attention_ref``
and ``repro.models.attention.chunked_attention`` / ``attention`` (whose
forward off the TPU is the chunked path, and whose backward is the vjp of
the chunked path).  On a CPU tensor the port's ``flash_attention`` is its
plain version; the CUDA kernel is held to that plain version on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).  Inputs come from numpy
seeds; everything is f32, at the JAX tests' tolerances (atol 2e-5, rtol
1e-3: tests/test_kernels.py, tests/test_attention_and_data.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ref as jref  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402

from test_torch_paged import np_tree, port_cfg  # noqa: E402

ATOL, RTOL = 2e-5, 1e-3


def _qkv(seed, b, sq, sk, h, kh, hd):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((b, sq, h, hd), (b, sk, kh, hd), (b, sk, kh, hd))]


def _t(arrs):
    return [torch.from_numpy(a) for a in arrs]


def _j(arrs):
    return [jnp.asarray(a) for a in arrs]


# the shapes of tests/test_kernels.py::test_flash_attention_shapes (MHA,
# GQA 4:1, MQA with Sq < Sk) and its variants (window, softcap,
# non-causal, both), plus a ragged Sq < Sk with a window
CASES = [
    dict(sq=128, sk=128, h=4, kh=4, hd=64),
    dict(sq=256, sk=256, h=8, kh=2, hd=64),
    dict(sq=128, sk=256, h=4, kh=1, hd=128),
    dict(sq=256, sk=256, h=4, kh=2, hd=64, window=64),
    dict(sq=256, sk=256, h=4, kh=2, hd=64, softcap=30.0),
    dict(sq=256, sk=256, h=4, kh=2, hd=64, causal=False),
    dict(sq=256, sk=256, h=4, kh=2, hd=64, window=32, softcap=50.0),
    dict(sq=100, sk=300, h=4, kh=2, hd=32, window=70),
]


def _ids(c):
    return "-".join(f"{k}{v}" for k, v in c.items())


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_flash_plain_and_ref_match_jax_ref(case):
    opts = {k: case[k] for k in ("causal", "window", "softcap") if k in case}
    arrs = _qkv(0, 2, case["sq"], case["sk"], case["h"], case["kh"],
                case["hd"])
    want = np.asarray(jref.flash_attention_ref(*_j(arrs), **opts))
    plain = tfa.flash_attention_plain(*_t(arrs), **opts)
    oracle = tref.flash_attention_ref(*_t(arrs), **opts)
    np.testing.assert_allclose(plain.numpy(), want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(oracle.numpy(), want, atol=ATOL, rtol=RTOL)


def test_flash_plain_folds_leading_dims():
    """A [G, B, S, H, hd] call (the semantic branches) equals the per-branch
    calls, and the plain version's query blocks (512 rows) join exactly."""
    arrs = _qkv(1, 2 * 2, 1100, 1100, 4, 2, 32)
    q, k, v = (t.reshape((2, 2) + t.shape[1:]) for t in _t(arrs))
    got = tfa.flash_attention(q, k, v, window=600)
    want = jref.flash_attention_ref(*_j(arrs), window=600)
    np.testing.assert_allclose(got.reshape(arrs[0].shape).numpy(),
                               np.asarray(want), atol=ATOL, rtol=RTOL)


# tests/test_attention_and_data.py::test_chunked_attention, plus GQA with
# Sq < Sk at the default chunks
@pytest.mark.parametrize("causal,window,softcap,sq,chunk", [
    (True, 0, 0.0, 2048, 512), (True, 512, 0.0, 2048, 512),
    (False, 0, 0.0, 2048, 512), (True, 0, 50.0, 2048, 512),
    (True, 300, 30.0, 1024, 1024)])
def test_chunked_attention_matches_jax(causal, window, softcap, sq, chunk):
    arrs = _qkv(2, 1, sq, 2048, 4, 2, 32)
    opts = dict(causal=causal, window=window, softcap=softcap,
                q_chunk=chunk, k_chunk=chunk)
    want = np.asarray(jattn.chunked_attention(*_j(arrs), **opts))
    got = tattn.chunked_attention(*_t(arrs), **opts).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    exp = np.asarray(jref.flash_attention_ref(
        *_j(arrs), causal=causal, window=window, softcap=softcap))
    np.testing.assert_allclose(got, exp, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("opts", [
    dict(), dict(window=700, softcap=30.0), dict(causal=False)],
    ids=["causal", "window-softcap", "full"])
def test_attention_grads_match_jax_custom_vjp(opts):
    """Gradients of the port's ``attention`` (plain forward on the CPU,
    chunked recompute backward) against ``jax.grad`` through the JAX
    ``custom_vjp``, for a weighted sum of the output: atol 2e-5."""
    arrs = _qkv(3, 1, 2048, 2048, 4, 2, 32)
    w = np.random.default_rng(4).normal(size=arrs[0].shape).astype(
        np.float32)

    def jloss(q, k, v):
        return jnp.sum(jattn.attention(q, k, v, **opts) * w)

    jg = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(*_j(arrs))
    ts = [t.requires_grad_() for t in _t(arrs)]
    before = tfa.flash_attention.launches
    (tattn.attention(*ts, **opts) * torch.from_numpy(w)).sum().backward()
    assert tfa.flash_attention.launches == before
    for t, g in zip(ts, jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=ATOL)


@pytest.mark.parametrize("s", [64, 2048])
def test_attn_apply_matches_jax(tiny_cfg, s):
    """``attn_apply`` on bridged weights: the dense ``sdpa`` path below
    2048 tokens, the flash path at 2048; GQA 2:1, output and input grads."""
    cfg = tiny_cfg.replace(n_kv_heads=1)
    params = jlayers.attn_init(jax.random.PRNGKey(1), cfg)
    x = np.random.default_rng(5).normal(size=(2, s, cfg.d_model)).astype(
        np.float32)
    pos = jnp.arange(s)[None, :]

    def jf(p, x):
        return jnp.sum(jlayers.attn_apply(p, x, cfg, positions=pos)[0] ** 2)

    jval, jgx = jax.jit(jax.value_and_grad(jf, argnums=1))(params,
                                                           jnp.asarray(x))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in
          np_tree(params).items()}
    tx = torch.from_numpy(x).requires_grad_()
    out, cache = tlayers.attn_apply(tp, tx, port_cfg(cfg),
                                    positions=torch.arange(s)[None, :])
    assert cache is None
    want = np.asarray(jlayers.attn_apply(params, jnp.asarray(x), cfg,
                                         positions=pos)[0])
    np.testing.assert_allclose(out.detach().numpy(), want, atol=ATOL,
                               rtol=RTOL)
    (out ** 2).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), atol=1e-4,
                               rtol=RTOL)


@pytest.mark.parametrize("case", ["decode", "ring", "prefill", "cross"])
def test_attn_apply_cache_and_cross_branches_equal_jax(tiny_cfg, case):
    """``attn_apply``'s dense-cache branch (a decode step through
    ``decode_attention``'s plain version, a wrapped ring buffer of window 4
    with softcap 50, a 3-token prefill into the cache) and its
    ``kv_override`` cross-attention branch, outputs and caches equal to
    JAX's on the same weights and cache."""
    cfg = tiny_cfg.replace(attn_softcap=50.0) if case == "ring" else tiny_cfg
    rng = np.random.default_rng(12)
    params = jlayers.attn_init(jax.random.PRNGKey(4), cfg)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
    s = 3 if case == "prefill" else 1
    x = rng.normal(size=(2, s, cfg.d_model)).astype(np.float32)
    L = 4 if case == "ring" else 8
    cache = rng.normal(size=(2, L, cfg.n_kv_heads, cfg.hd)).astype(
        np.float32)
    index = {"decode": 5, "ring": 9, "prefill": 2, "cross": 0}[case]
    window = 4 if case == "ring" else 0
    pos = np.arange(index, index + s)[None]
    kw, tkw = {}, {}
    if case == "cross":
        enc = rng.normal(size=(2, 5, cfg.n_kv_heads, cfg.hd)).astype(
            np.float32)
        kw = dict(kv_override=(jnp.asarray(enc), jnp.asarray(enc)))
        tkw = dict(kv_override=(torch.from_numpy(enc),) * 2)
    else:
        kw = dict(kv_cache={"k": jnp.asarray(cache),
                            "v": jnp.asarray(cache[::-1].copy())},
                  cache_index=index, window=window)
        tkw = dict(kv_cache={"k": torch.from_numpy(cache.copy()),
                             "v": torch.from_numpy(cache[::-1].copy())},
                   cache_index=index, window=window)
    want, jc = jlayers.attn_apply(params, jnp.asarray(x), cfg,
                                  positions=jnp.asarray(pos), **kw)
    got, tc = tlayers.attn_apply(tp, torch.from_numpy(x), port_cfg(cfg),
                                 positions=torch.from_numpy(pos), **tkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    if case == "cross":
        assert tc is None and jc is None
        return
    for n in ("k", "v"):
        np.testing.assert_allclose(tc[n].numpy(), np.asarray(jc[n]),
                                   atol=ATOL, rtol=RTOL)


def test_flash_wrapper_counts_no_cpu_launch():
    """On CPU tensors the wrapper takes the plain version and counts no
    launch; a tensor on a device without a kernel (an xpu stand-in: meta
    is the dry run's) raises instead of falling back."""
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
    arrs = _t(_qkv(6, 1, 64, 64, 2, 2, 32))
    before = tfa.flash_attention.launches
    out = tfa.flash_attention(*arrs)
    assert tfa.flash_attention.launches == before == 0
    assert torch.equal(out, tfa.flash_attention_plain(*arrs))
    mode = FakeTensorMode()
    with pytest.raises(ValueError, match="no kernel for xpu"):
        tfa.flash_attention(*(FakeTensor(mode, a.to("meta"),
                                         torch.device("xpu")) for a in arrs))
