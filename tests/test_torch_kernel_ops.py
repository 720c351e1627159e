"""The port's kernel-op layer (``repro_torch.kernels.ops``) and the plain
versions of its four kernels against the JAX package.

The same numpy inputs go to both packages.  Each plain version is held
against its jnp oracle (``repro.kernels.ref``) at the shapes of
tests/test_kernels.py and with its tolerances, and the scan also against
the Pallas kernel itself in interpret mode (the one Pallas kernel that
runs on this tree).  Ragged shapes that the Pallas wrappers' asserts
refuse are held against the oracle.  The ops are held to the JAX ops with
both switches off.  The CUDA kernels themselves are held against these
plain versions on the card in tests/test_torch_gpu.py.

Length-0 decode rows: the port's kernel and its plain version return 0,
as the Pallas kernel does; the oracle (and so either package's ops with
kernels off) returns the mean of v.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.quant_matmul import \
    quantize_blockwise as jquantize  # noqa: E402
from repro.kernels.ssm_scan import ssm_scan as pallas_scan  # noqa: E402
from repro_torch.kernels import _decode_launch, _gemm_launch  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.block_diag_matmul import (  # noqa: E402
    block_diag_matmul, block_diag_matmul_plain)
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention, decode_attention_plain)
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.moe_gmm import moe_gmm, moe_gmm_plain  # noqa: E402
from repro_torch.kernels.quant_matmul import quant_matmul  # noqa: E402
from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_plain  # noqa

# the block-diagonal matmul's tolerances, far tighter than
# tests/test_kernels.py's (atol 2e-5 d in f32, 2e-2 d in bf16, which hold a
# Pallas kernel): both packages take the same f32 einsum of the same values,
# so they differ by the summation order and, in bf16, one rounding of the
# output
BDM_TOL = {"f32": dict(atol=1e-4, rtol=1e-4),
           "bf16": dict(atol=1e-2, rtol=1e-2)}
DT = {"f32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}
WRAPPERS = (block_diag_matmul, moe_gmm, ssm_scan, decode_attention,
            flash_attention, quant_matmul)


def _pair(a, kind="f32"):
    """A numpy array as (jnp, torch) in the dtype ``kind``, equal values on
    both sides (bf16 rounded once, by jnp)."""
    j = jnp.asarray(a, DT[kind][0])
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))) \
        .to(DT[kind][1])


def _np(t):
    return t.float().numpy()


def _close(got, want, **tol):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **tol)


@pytest.fixture
def kernels_off():
    """Both packages' switches off for the test, back on after it (other
    tests share the worker)."""
    ops.use_kernels(False)
    jops.use_kernels(False)
    try:
        yield
    finally:
        ops.use_kernels(True)
        jops.use_kernels(True)


# ------------------------------------------------------ plain vs the oracle
@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("bb,t,d,e", [(4, 128, 128, 128), (16, 128, 64, 256),
                                      (2, 256, 384, 128)])
def test_block_diag_matmul_plain_matches_jax(bb, t, d, e, kind):
    rng = np.random.default_rng(1)
    xj, xt = _pair(rng.normal(size=(bb, t, d)) * 0.3, kind)
    wj, wt = _pair(rng.normal(size=(bb, d, e)) * 0.3, kind)
    got = block_diag_matmul_plain(xt, wt)
    assert got.dtype == DT[kind][1] and got.shape == (bb, t, e)
    _close(got, jref.block_diag_matmul_ref(xj, wj), **BDM_TOL[kind])


def test_block_diag_matmul_plain_equals_dense_embedding():
    rng = np.random.default_rng(2)
    x, w = rng.normal(size=(4, 64, 64)), rng.normal(size=(4, 64, 32))
    (xj, xt), (wj, wt) = _pair(x), _pair(w)
    got = block_diag_matmul_plain(xt, wt)
    _close(got, jref.block_diag_dense_ref(xj, wj), atol=1e-4)
    from repro_torch.kernels import ref as tref
    _close(tref.block_diag_dense_ref(xt, wt), jref.block_diag_dense_ref(
        xj, wj), atol=1e-4)


@pytest.mark.parametrize("e,c,d,f", [(4, 128, 128, 128), (8, 128, 256, 64)])
def test_moe_gmm_plain_matches_jax(e, c, d, f):
    rng = np.random.default_rng(3)
    (xj, xt), (wj, wt) = _pair(rng.normal(size=(e, c, d)) * 0.3), \
        _pair(rng.normal(size=(e, d, f)) * 0.3)
    _close(moe_gmm_plain(xt, wt), jref.moe_gmm_ref(xj, wj), atol=1e-4,
           rtol=1e-4)


@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("L,lens", [(512, (3, 512)), (256, (256, 17))])
def test_decode_attention_plain_matches_jax(L, lens, softcap):
    rng = np.random.default_rng(4)
    qj, qt = _pair(rng.normal(size=(2, 8, 64)))
    kj, kt = _pair(rng.normal(size=(2, L, 2, 64)))
    vj, vt = _pair(rng.normal(size=(2, L, 2, 64)))
    length = np.asarray(lens, np.int32)
    got = decode_attention_plain(qt, kt, vt, torch.from_numpy(length),
                                 softcap=softcap)
    _close(got, jref.decode_attention_ref(qj, kj, vj, jnp.asarray(length),
                                          softcap=softcap),
           atol=2e-5, rtol=1e-3)


@pytest.mark.parametrize("s,chunk", [(128, 32), (64, 64), (96, 16)])
def test_ssm_scan_plain_matches_jax_and_pallas(s, chunk):
    rng = np.random.default_rng(5)
    aj, at = _pair(rng.uniform(0.7, 0.999, (2, s, 16, 8)))
    bj, bt = _pair(rng.normal(size=(2, s, 16, 8)))
    got = ssm_scan_plain(at, bt)
    _close(got, jref.ssm_scan_ref(aj, bj), atol=1e-4, rtol=1e-4)
    _close(got, pallas_scan(aj, bj, chunk=chunk, interpret=True), atol=1e-4,
           rtol=1e-4)


def test_ssm_scan_plain_bf16_keeps_an_f32_state():
    """bf16 a and b: the state stays f32 and only each h_t is rounded, as
    in the oracle (a state rounded every step would drift)."""
    rng = np.random.default_rng(6)
    aj, at = _pair(rng.uniform(0.7, 0.999, (1, 96, 4, 8)), "bf16")
    bj, bt = _pair(rng.normal(size=(1, 96, 4, 8)), "bf16")
    got = ssm_scan_plain(at, bt)
    assert got.dtype == torch.bfloat16
    _close(got, jref.ssm_scan_ref(aj, bj), atol=2e-2, rtol=2e-2)


# ----------------------------------------------- shapes the Pallas refuses
def test_ragged_shapes_match_the_oracle():
    """Shapes the Pallas wrappers' divisibility asserts refuse: T 200 over
    128-row blocks, capacity 171, S 100 over 64-step chunks, L 300 over
    256-slot blocks with a GQA ratio of 3 and a softcap."""
    rng = np.random.default_rng(7)
    (xj, xt), (wj, wt) = _pair(rng.normal(size=(2, 200, 96))), \
        _pair(rng.normal(size=(2, 96, 72)))
    _close(block_diag_matmul(xt, wt), jref.block_diag_matmul_ref(xj, wj),
           atol=1e-4, rtol=1e-4)
    (xj, xt), (wj, wt) = _pair(rng.normal(size=(3, 171, 100))), \
        _pair(rng.normal(size=(3, 100, 60)))
    _close(moe_gmm(xt, wt), jref.moe_gmm_ref(xj, wj), atol=1e-4, rtol=1e-4)
    aj, at = _pair(rng.uniform(0.7, 0.999, (1, 100, 3, 5)))
    bj, bt = _pair(rng.normal(size=(1, 100, 3, 5)))
    _close(ssm_scan(at, bt), jref.ssm_scan_ref(aj, bj), atol=1e-4,
           rtol=1e-4)
    qj, qt = _pair(rng.normal(size=(3, 6, 32)))
    kj, kt = _pair(rng.normal(size=(3, 300, 2, 32)))
    vj, vt = _pair(rng.normal(size=(3, 300, 2, 32)))
    length = np.asarray([300, 1, 257], np.int32)
    _close(decode_attention(qt, kt, vt, torch.from_numpy(length),
                            softcap=20.0),
           jref.decode_attention_ref(qj, kj, vj, jnp.asarray(length),
                                     softcap=20.0), atol=2e-5, rtol=1e-3)


# ------------------------------------------------------------------- ops
def test_ops_match_jax_ops_with_kernels_off(kernels_off):
    rng = np.random.default_rng(8)
    n = rng.normal
    q4 = [_pair(n(size=s)) for s in ((1, 64, 4, 32), (1, 64, 2, 32),
                                     (1, 64, 2, 32))]
    for kw in ({}, {"causal": False}, {"window": 16, "softcap": 20.0}):
        _close(ops.flash_attention(*(t for _, t in q4), **kw),
               jops.flash_attention(*(j for j, _ in q4), **kw), atol=2e-5,
               rtol=1e-4)
    (xj, xt), (wj, wt) = _pair(n(size=(2, 16, 32))), _pair(n(size=(2, 32, 8)))
    _close(ops.block_diag_matmul(xt, wt), jops.block_diag_matmul(xj, wj),
           atol=1e-5, rtol=1e-5)
    _close(ops.moe_gmm(xt, wt), jops.moe_gmm(xj, wj), atol=1e-5, rtol=1e-5)
    aj, at = _pair(rng.uniform(0.7, 0.999, (2, 24, 3, 4)))
    bj, bt = _pair(n(size=(2, 24, 3, 4)))
    _close(ops.ssm_scan(at, bt), jops.ssm_scan(aj, bj), atol=1e-5,
           rtol=1e-5)
    qj, qt = _pair(n(size=(3, 4, 32)))
    kj, kt = _pair(n(size=(3, 40, 2, 32)))
    vj, vt = _pair(n(size=(3, 40, 2, 32)))
    length = np.asarray([40, 0, 7], np.int32)
    for cap in (0.0, 25.0):
        _close(ops.decode_attention(qt, kt, vt, torch.from_numpy(length),
                                    softcap=cap),
               jops.decode_attention(qj, kj, vj, jnp.asarray(length),
                                     softcap=cap), atol=2e-5, rtol=1e-4)
    w = n(size=(64, 24)).astype(np.float32)
    xj, xt = _pair(n(size=(5, 64)))
    for bits in (8, 4):
        cj, sj = jquantize(jnp.asarray(w), bits=bits, group=32)
        ct = torch.from_numpy(np.asarray(cj))
        st = torch.from_numpy(np.asarray(sj))
        _close(ops.quant_matmul(xt, ct, st), jops.quant_matmul(xj, cj, sj),
               atol=1e-4, rtol=1e-4)


def test_ops_ssm_scan_matches_jax_with_kernels_on():
    """The JAX op with its switch on runs the Pallas kernel (interpret
    mode off the TPU); the port's op takes the plain version on the
    CPU."""
    rng = np.random.default_rng(9)
    aj, at = _pair(rng.uniform(0.7, 0.999, (1, 64, 8, 4)))
    bj, bt = _pair(rng.normal(size=(1, 64, 8, 4)))
    _close(ops.ssm_scan(at, bt), jops.ssm_scan(aj, bj), atol=1e-4,
           rtol=1e-4)


def test_decode_length_zero_rule():
    """Kernels on: a length-0 row is 0 (the Pallas kernel's rule, kept by
    the CUDA kernel and its plain version).  Kernels off: the oracle's
    uniform softmax, the mean of v over every slot of the row's kv head."""
    rng = np.random.default_rng(10)
    q = torch.from_numpy(rng.normal(size=(2, 4, 32)).astype(np.float32))
    k, v = (torch.from_numpy(rng.normal(size=(2, 16, 2, 32))
                             .astype(np.float32)) for _ in range(2))
    length = torch.tensor([0, 5], dtype=torch.int32)
    on = ops.decode_attention(q, k, v, length)
    assert bool((on[0] == 0).all())
    ops.use_kernels(False)
    try:
        off = ops.decode_attention(q, k, v, length)
    finally:
        ops.use_kernels(True)
    mean_v = v[0].mean(dim=0).repeat_interleave(2, dim=0)      # [H, hd]
    torch.testing.assert_close(off[0], mean_v, atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(on[1], off[1], atol=0, rtol=0)


def test_ops_launch_nothing_on_cpu():
    """On the CPU every op takes a plain version: no wrapper counts a
    launch."""
    rng = np.random.default_rng(11)
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    before = [w.launches for w in WRAPPERS]
    ops.block_diag_matmul(t(2, 3, 4), t(2, 4, 5))
    ops.moe_gmm(t(2, 3, 4), t(2, 4, 5))
    ops.ssm_scan(t(1, 3, 2, 2), t(1, 3, 2, 2))
    ops.decode_attention(t(1, 2, 32), t(1, 4, 1, 32), t(1, 4, 1, 32),
                         torch.tensor([3], dtype=torch.int32))
    ops.flash_attention(t(1, 8, 2, 32), t(1, 8, 2, 32), t(1, 8, 2, 32))
    codes = torch.zeros(8, 4, dtype=torch.int8)
    ops.quant_matmul(t(3, 8), codes, torch.ones(1, 4))
    assert [w.launches for w in WRAPPERS] == before == [0] * len(WRAPPERS)


@pytest.mark.parametrize("wrapper,args", [
    (block_diag_matmul, ((2, 3, 4), (2, 4, 5))),
    (moe_gmm, ((2, 3, 4), (2, 4, 5))),
    (ssm_scan, ((1, 3, 2, 2), (1, 3, 2, 2))),
    (decode_attention, ((1, 2, 32), (1, 4, 1, 32), (1, 4, 1, 32))),
], ids=["block_diag_matmul", "moe_gmm", "ssm_scan", "decode_attention"])
def test_wrappers_refuse_devices_without_a_kernel(wrapper, args):
    """A tensor on a device with no kernel (an xpu stand-in: meta is the
    dry run's, whose launches ``tests/test_torch_dryrun.py`` holds)."""
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
    mode, xpu = FakeTensorMode(), torch.device("xpu")
    on = lambda t: FakeTensor(mode, t.to("meta"), xpu)
    tensors = [on(torch.empty(s)) for s in args]
    if wrapper is decode_attention:
        tensors.append(on(torch.empty(1, dtype=torch.int32)))
    with pytest.raises(ValueError, match="no kernel for xpu"):
        wrapper(*tensors)


# ---------------------------------------------------- launch planning
@pytest.mark.parametrize("m,tile", [(1, 8), (8, 8), (32, 8), (33, 64),
                                    (171, 64), (200, 128), (2048, 128),
                                    (100, 128)])
def test_gemm_tile_rows(m, tile):
    assert _gemm_launch.tile_rows(m) == tile


@pytest.mark.parametrize("tiles,k,slab,want", [
    (44, 1024, 32, 528), (44, 2816, 32, 528), (704, 1024, 16, 264),
    (88, 1024, 16, 264), (1, 7, 32, 528), (3, 0, 16, 264),
    (1000, 4096, 16, 264)])
def test_gemm_split_plan_covers_the_contraction(tiles, k, slab, want):
    splits, per = _gemm_launch.split_plan(tiles, k, slab, want)
    assert per % slab == 0 and per >= slab and splits >= 1
    assert splits * per >= k and (splits - 1) * per < max(k, 1)
    if tiles >= want:
        assert splits == 1


@pytest.mark.parametrize("rep,group", [(1, 1), (2, 2), (3, 1), (4, 4),
                                       (6, 2), (8, 8), (16, 8), (12, 4)])
def test_decode_head_group_divides_the_ratio(rep, group):
    assert _decode_launch.head_group(rep) == group
