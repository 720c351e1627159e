"""CPU evidence for the tensor-core paths of the port's kernels: plain-torch
emulations that walk the CUDA kernels' tiles, held to the plain versions
and to the JAX package's oracles (``repro.kernels.ref``) with the
tolerances that the chip check (``chip_smoke.py``) and
``tests/test_torch_gpu.py`` hold the kernels to, plus the pure-Python
rules that pick each launch's path.

- The grouped GEMM's bf16 tile (``_gemm_launch.wgmma_emulated``): 64-deep
  K slabs summed into f32, one cast; held as |emulated - plain| <=
  2e-2 (1 + |plain|).
- The bf16-q paged prefill
  (``paged_prefill_attention.paged_prefill_attention_emulated``): 64-row
  query tiles, 64-token K/V tiles through the table, f32 max, sum and
  accumulator, P rounded to bf16 (int8 pools: K scale on the scores, V
  scale on P); held as |emulated - plain| <= 2e-2 times each output row's
  max |plain|, and the same check must reject the plain output with the
  first 64-token tile of every row longer than 256 keys left out.

The same numpy inputs go to both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.decode.paged_cache import quantize_kv  # noqa: E402
from repro_torch.kernels import _gemm_launch, _paged_launch  # noqa: E402
from repro_torch.kernels.block_diag_matmul import \
    block_diag_matmul_plain  # noqa: E402
from repro_torch.kernels.moe_gmm import moe_gmm_plain  # noqa: E402
from repro_torch.kernels.paged_prefill_attention import (  # noqa: E402
    paged_prefill_attention_emulated, paged_prefill_attention_plain)

#: the chip check's bf16 tolerance (``chip_smoke.QTOL`` / ``TOL``)
TOL = 2e-2


def _np(t):
    return np.asarray(t.float().numpy())


def _jnp(t):
    """A torch tensor as jnp with equal values (bf16 stays bf16)."""
    if t.dtype == torch.bfloat16:
        return jnp.asarray(_np(t), jnp.bfloat16)
    return jnp.asarray(t.numpy())


# ---------------------------------------------------------------- GEMM
@pytest.mark.parametrize("g,m,k,n", [
    (2, 33, 64, 200), (3, 171, 200, 72), (2, 65, 72, 130),
    (1, 2048, 64, 40), (2, 200, 1024, 96)])
def test_gemm_emulation_matches_plain_and_jax(g, m, k, n):
    rng = np.random.default_rng(m + k)
    x = torch.from_numpy(rng.standard_normal((g, m, k), np.float32)) \
        .bfloat16()
    w = torch.from_numpy(rng.standard_normal((g, k, n), np.float32)
                         / np.sqrt(k)).bfloat16()
    got = _gemm_launch.wgmma_emulated(x, w)
    assert got.shape == (g, m, n) and got.dtype == torch.bfloat16
    for plain, oracle in (
            (block_diag_matmul_plain, jref.block_diag_matmul_ref),
            (moe_gmm_plain, jref.moe_gmm_ref)):
        for want in (plain(x, w).float().numpy(),
                     np.asarray(oracle(_jnp(x), _jnp(w)), np.float32)):
            diff = np.abs(_np(got) - want)
            assert (diff <= TOL * (1 + np.abs(want))).all(), diff.max()


@pytest.mark.parametrize("m,consumers", [
    (33, 1), (64, 1), (65, 2), (128, 2), (171, 3), (192, 3), (200, 2),
    (2048, 2)])
def test_wgmma_consumers_pad_least(m, consumers):
    assert _gemm_launch.wgmma_consumers(m) == consumers


def _gemm_args(cut):
    """(x, w) on the CPU cut so that one alignment rule decides."""
    x = torch.zeros(2, 171, 72, dtype=torch.bfloat16)
    w = torch.zeros(2, 64, 200, dtype=torch.bfloat16)
    return {
        "aligned": (x[..., :64], w),                       # row stride 144 B
        "f32": (x[..., :64].float(), w.float()),
        "decode rows": (x[:, :32, :64], w),
        "row stride 140 B": (torch.zeros(2, 171, 70,
                                         dtype=torch.bfloat16)[..., :64], w),
        "pointer 2 B off": (x[..., 1:65], w),
        "broadcast group": (x[:1, :, :64].expand(2, 171, 64), w),
        "w row stride 100 B": (x[..., :64], torch.zeros(
            2, 64, 50, dtype=torch.bfloat16)),
        "one group": (x[:1, :, :64], w[:1]),
    }[cut]


@pytest.mark.parametrize("cut,path", [
    ("aligned", "wgmma"), ("f32", "tiled"), ("decode rows", "skinny"),
    ("row stride 140 B", "tiled"), ("pointer 2 B off", "tiled"),
    ("broadcast group", "tiled"), ("w row stride 100 B", "tiled"),
    ("one group", "wgmma")])
def test_gemm_path_rule(cut, path):
    """The path depends on dtype, shape and alignment alone, decided before
    any launch (these are CPU tensors: nothing launches)."""
    assert _gemm_launch.path_for(*_gemm_args(cut)) == path


@pytest.mark.parametrize("dt,chunk,path", [
    (torch.bfloat16, True, "prefill_mma"),
    (torch.float32, True, "prefill_simt"),
    (torch.bfloat16, False, "decode_simt"),
    (torch.float32, False, "decode_simt")])
def test_paged_path_rule(dt, chunk, path):
    assert _paged_launch.path_for(dt, chunk) == path


# ------------------------------------------------------- paged prefill
def _prefill_case(kind, *, hd, c, g, b=4, h=8, kh=2, bs=16, nb=24):
    """GQA 4 with bf16 q: lane 0 a null table at positions from 0, lanes
    1-3 alias lane 1's first four blocks, lane 1's rows pass 256 keys, lane
    3's chunk runs past the table."""
    rng = np.random.default_rng(hd + c)
    p_blocks = 1 + b * nb
    kf = torch.from_numpy(rng.standard_normal((g, p_blocks, bs, kh, hd),
                                              np.float32))
    vf = torch.from_numpy(rng.standard_normal((g, p_blocks, bs, kh, hd),
                                              np.float32))
    tables = rng.permutation(np.arange(1, p_blocks)).reshape(b, nb)
    tables[2:, :4] = tables[1, :4]
    tables[0] = 0
    starts = np.asarray([0, 300, 100, nb * bs - c // 2])
    case = dict(
        q=torch.from_numpy(rng.standard_normal((g, b, c, h, hd),
                                               np.float32)).bfloat16(),
        tables=torch.from_numpy(tables.astype(np.int32)),
        positions=torch.from_numpy(
            (starts[:, None] + np.arange(c)).astype(np.int32)))
    if kind == "int8":
        (k, ks), (v, vs) = quantize_kv(kf), quantize_kv(vf)
        case.update(k=k, v=v, kw=dict(k_scale=ks, v_scale=vs))
    else:
        case.update(k=kf.bfloat16(), v=vf.bfloat16(), kw={})
    return case


def _row_limit(want):
    return TOL * np.abs(want).max(-1, keepdims=True)


@pytest.mark.parametrize("kind", ["bf16", "int8"])
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("c,g,softcap", [(1, 1, 0.0), (33, 2, 0.0),
                                         (64, 1, 30.0)])
def test_prefill_emulation_matches_plain_and_jax(kind, hd, c, g, softcap):
    cs = _prefill_case(kind, hd=hd, c=c, g=g)
    args = (cs["q"], cs["k"], cs["v"], cs["tables"], cs["positions"])
    kw = dict(cs["kw"], softcap=softcap)
    got = _np(paged_prefill_attention_emulated(*args, **kw))
    want = _np(paged_prefill_attention_plain(*args, **kw))
    assert got.shape == tuple(cs["q"].shape)
    oracle = np.stack([np.asarray(jref.paged_prefill_attention_ref(
        _jnp(cs["q"][i]), _jnp(cs["k"][i]), _jnp(cs["v"][i]),
        _jnp(cs["tables"]), _jnp(cs["positions"]),
        **{n: _jnp(s[i]) for n, s in cs["kw"].items()}, softcap=softcap),
        np.float32) for i in range(g)])
    for ref_out in (want, oracle):
        diff = np.abs(got - ref_out)
        assert (diff <= _row_limit(ref_out)).all(), diff.max()
    # the check rejects the plain output with each long row's first
    # 64-token tile left out, in every query row with more than 256 keys
    nb, bs = cs["tables"].shape[1], cs["k"].shape[2]
    keys = np.minimum(_np(cs["positions"]) + 1, nb * bs)
    long = keys > 256
    bad = _np(paged_prefill_attention_plain(
        cs["q"], cs["k"], cs["v"], cs["tables"][:, 64 // bs:].contiguous(),
        cs["positions"] - 64, **kw))
    over = (np.abs(bad - want) > _row_limit(want)).any((-2, -1))  # [G,B,C]
    assert long.any() and over[:, long].all()
