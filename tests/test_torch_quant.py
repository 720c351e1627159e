"""Port weight-quantized serving against the JAX package.

Blockwise codes and scales must be bit-equal (``jnp.round`` and
``torch.round`` both round half to even), and so must dequantization and
the int4 nibble split.  The plain quant GEMM is held to
``repro.kernels.ref.quant_matmul_ref`` at 2e-4, the tolerance of the JAX
kernel test (tests/test_quant.py): the same f32 dequantize-then-matmul in
another summation order.  Quantization telemetry matches to 1e-6 (the mean
error sums in another order, and both round to 6 decimals).  The paged forwards with quantized
projections run the JAX model-level functions with ``interpret=False``,
which on the CPU reach ``ref.quant_matmul_ref`` from ``_proj``; logits are
held to the tolerances of tests/test_torch_paged.py (1e-4 f32 KV, 1e-3 int8
KV), and scheduler token streams match exactly where the JAX run's top-2
margin clears 1e-3.
"""
import heapq
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.decode import paged_model as jpm  # noqa: E402
from repro.kernels import quant_matmul as jqm  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.decode import paged_model as tpm  # noqa: E402
from repro_torch.engine import TorchBackend  # noqa: E402
from repro_torch.kernels import quant_matmul as tqm  # noqa: E402

from test_torch_paged import _setup, port_cfg  # noqa: E402
from test_torch_scheduler import (QUANT_ERR_TOL, _pump, _req,  # noqa: E402
                                  _run_both)


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def _weights(shape, seed):
    """Gaussian weights with an all-zero group and exact rounding ties."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=shape).astype(np.float32)
    w[..., :shape[-2] // 2, 1] = 0.0         # a zero (group, column) cell
    w[..., 0, 0] = 127.0                      # amax 127 -> scale 1 for int8
    w[..., 1:4, 0] = [0.5, 1.5, -2.5]         # ties round half to even
    return w


# --------------------------------------------------------------- helpers
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape", [(256, 24), (2, 3, 512, 16), (96, 8),
                                   (40, 5)], ids=lambda s: "x".join(map(str, s)))
def test_quantize_blockwise_bit_equal(bits, shape):
    w = _weights(shape, seed=len(shape) + bits)
    jq, js = jqm.quantize_blockwise(jnp.asarray(w), bits=bits)
    tq, ts = tqm.quantize_blockwise(torch.from_numpy(w), bits=bits)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    _bits_equal(tq.numpy(), jq)
    _bits_equal(ts.numpy(), js)
    _bits_equal(tqm.dequantize_blockwise(tq, ts, bits=bits).numpy(),
                jqm.dequantize_blockwise(jq, js, bits=bits))
    assert tqm.infer_bits(shape[-2], tq) == jqm.infer_bits(shape[-2], jq)
    assert tqm.fit_group(shape[-2]) == jqm.fit_group(shape[-2])


def test_unpack_int4_bit_equal():
    p = np.arange(-128, 128, dtype=np.int8).reshape(2, 8, 16)
    for a, b in zip(tqm.unpack_int4(torch.from_numpy(p)),
                    jqm.unpack_int4(jnp.asarray(p))):
        _bits_equal(a.numpy(), b)


def test_quantize_rejects_what_jax_rejects():
    with pytest.raises(ValueError, match="bits"):
        tqm.quantize_blockwise(torch.zeros(8, 4), bits=3)
    with pytest.raises(ValueError, match="group >= 2"):
        tqm.quantize_blockwise(torch.zeros(1, 4), bits=4)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("lead", [(), (2,)], ids=["one", "branches"])
def test_quant_matmul_plain_matches_ref(bits, lead):
    rng = np.random.default_rng(bits)
    w = rng.normal(size=lead + (256, 48)).astype(np.float32)
    x = rng.normal(size=lead + (13, 256)).astype(np.float32)
    tq, ts = tqm.quantize_blockwise(torch.from_numpy(w), bits=bits)
    got = tqm.quant_matmul(torch.from_numpy(x), tq, ts)    # CPU: plain
    jq, js = jqm.quantize_blockwise(jnp.asarray(w), bits=bits)
    want = jref.quant_matmul_ref(jnp.asarray(x), jq, js)
    assert got.shape == lead + (13, 48) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4,
                               rtol=2e-4)
    xb = torch.from_numpy(x).bfloat16()
    assert tqm.quant_matmul(xb, tq, ts).dtype == torch.bfloat16


def test_split_count_covers_every_group():
    """Decode-sized calls split their groups over CTAs: every split holds
    at least one group, the splits cover them all, prefill-sized calls do
    not split."""
    from repro_torch.kernels._quant_launch import DECODE_T, split_count
    for g, t, e, n_g in itertools.product((1, 2), (1, 8, 32, 33, 1024),
                                          (40, 1024, 2048), (1, 3, 9, 16)):
        s = split_count(g, t, e, n_g, 132)
        per = -(-n_g // s)
        assert 1 <= s <= n_g and (s - 1) * per < n_g <= s * per
        assert s == 1 or t <= DECODE_T
    assert split_count(1, 8, 2048, 16, 132) == 4      # LAYER decode


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("arm", ["layer", "semantic"])
def test_quantize_attn_params_telemetry(tiny_cfg, arm, bits):
    jmodel, params, _, tmodel, _ = _setup(tiny_cfg, arm, "f32")
    jnew, jtele = jpm.quantize_attn_params(params, bits)
    views, ttele = tpm.quantize_attn_params(tmodel.grouped_views(), bits)
    assert set(ttele) == set(jtele)
    assert ttele["weight_quant_bits"] == jtele["weight_quant_bits"] == bits
    for key in ("weight_quant_max_err", "weight_quant_mean_err"):
        assert ttele[key] == pytest.approx(jtele[key], abs=QUANT_ERR_TOL), key
    # the codes the forwards use equal JAX's, superblock by superblock
    for n, sb in enumerate(views[2]):
        for name in tpm.ATTN_PROJ:
            jw = jnew["blocks"]["pos0"]["mix"][name]
            tw = sb["pos0"]["mix"][name]
            sl = (slice(None), n) if arm == "semantic" else (n,)
            _bits_equal(tw["q"].reshape(np.asarray(jw["q"])[sl].shape),
                        np.asarray(jw["q"])[sl])
    # the model's float parameters are untouched
    assert not isinstance(tmodel.grouped_views()[2][0]["pos0"]["mix"]["wq"],
                          dict)


# ------------------------------------------------------- paged forwards
@pytest.mark.parametrize("kv", ["f32", "int8"])
@pytest.mark.parametrize("arm", ["layer", "semantic"])
@pytest.mark.parametrize("wq", ["int8", "int4"])
def test_quantized_paged_forwards_match_jax(tiny_cfg, wq, arm, kv):
    """A prefill chunk over ragged lanes, then two teacher-forced decode
    steps, with quantized projections on both sides."""
    tol = 1e-4 if kv == "f32" else 1e-3
    bits = int(wq[3:])
    jmodel, params, jpool, tmodel, tpool = _setup(tiny_cfg, arm, kv)
    jparams, _ = jpm.quantize_attn_params(params, bits)
    tparams, _ = tpm.quantize_attn_params(tmodel.grouped_views(), bits)
    rng = np.random.default_rng(11)
    tables = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 11, 12],
                         [0, 0, 0, 0]], np.int32)
    toks = rng.integers(0, tiny_cfg.vocab_size, (4, 8)).astype(np.int32)
    starts = np.zeros(4, np.int32)
    n_tok = np.asarray([8, 5, 3, 0], np.int32)
    jl, jpool = jax.jit(jpm.make_prefill_chunk_fn(jmodel, interpret=False))(
        jparams, jpool, jnp.asarray(toks), jnp.asarray(starts),
        jnp.asarray(n_tok), jnp.asarray(tables))
    tl, tpool = tpm.make_prefill_chunk_fn(tmodel, tparams)(
        tpool, torch.from_numpy(toks), torch.from_numpy(starts),
        torch.from_numpy(n_tok), torch.from_numpy(tables))
    live = n_tok > 0
    np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                               atol=tol, rtol=tol)
    jstep = jax.jit(lambda p, c, t, bt, ln, a: jpm.paged_decode_logits(
        jmodel, p, c, t, bt, ln, a, interpret=False))
    lengths = n_tok.copy()
    active = np.asarray([True, True, False, False])
    for _ in range(2):
        tok = rng.integers(0, tiny_cfg.vocab_size, (4, 1)).astype(np.int32)
        jl, jpool = jstep(jparams, jpool, jnp.asarray(tok),
                          jnp.asarray(tables), jnp.asarray(lengths),
                          jnp.asarray(active))
        tl, tpool = tpm.paged_decode_logits(
            tmodel, tpool, torch.from_numpy(tok), torch.from_numpy(tables),
            torch.from_numpy(lengths), torch.from_numpy(active), tparams)
        np.testing.assert_allclose(tl.numpy()[active],
                                   np.asarray(jl)[active], atol=tol, rtol=tol)
        lengths = lengths + active


# ------------------------------------------------------------ scheduler
@pytest.mark.parametrize("wq", ["int8", "int4"])
@pytest.mark.parametrize("arm", ["layer", "semantic"])
def test_quantized_scheduler_matches_jax(tiny_cfg, arm, wq):
    """An in-flight join and a prefix hit with a COW block, served from
    quantized projections: tokens, counters and weight_quant_* gauges."""
    rng = np.random.default_rng(21)
    head = rng.integers(0, tiny_cfg.vocab_size, 10).astype(np.int32)
    p_a = np.concatenate([head, rng.integers(0, tiny_cfg.vocab_size, 2)])
    p_b = np.concatenate([head, rng.integers(0, tiny_cfg.vocab_size, 3)])

    def script(sched, mk):
        q = [(4.0, 0, 0.0, _req(mk, 1, p_a.astype(np.int32), 6))]
        sched.try_join(q, 0.0)
        sched.prefill_step(0.0)
        done = sched.dispatch(0.0)
        done += _pump(sched, q)
        heapq.heappush(q, (4.0, 1, 0.0, _req(mk, 0, p_b.astype(np.int32),
                                             5)))
        return done + _pump(sched, q)

    _, st = _run_both(tiny_cfg, arm, 4, dict(
        n_lanes=4, cache_len=32, block_size=4, scan_tokens=4,
        prefill_chunk=4, weight_quant=wq), script)
    assert st["weight_quant_bits"] == int(wq[3:])
    assert st["weight_quant_max_err"] > 0 and st["prefix_hit_tokens"] >= 8


def test_backend_weight_quant_validated_like_jax(tiny_cfg):
    with pytest.raises(ValueError, match="weight_quant"):
        TorchBackend(port_cfg(tiny_cfg), device="cpu", weight_quant="int3")
