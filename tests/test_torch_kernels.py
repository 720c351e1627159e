"""Port kernels: the plain PyTorch versions of the two paged-attention
kernels against the JAX package's jnp oracles (``repro.kernels.ref``).  The
CUDA kernels themselves are held against these plain versions on the card
in tests/test_torch_gpu.py.

Same numpy inputs go to both packages.  Both sides compute in float32 with
a different summation order (einsum/softmax in XLA vs PyTorch), so f32
outputs agree to atol/rtol 1e-5.  Rows the callers never read are left out
of the comparison where the two functions are documented to differ: a
decode row of length 0 is 0 in the port (the kernel's acc / max(l, 1e-20))
and a uniform average in the dense oracle.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.decode.paged_cache import quantize_kv  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.paged_decode_attention import \
    paged_decode_attention  # noqa: E402
from repro_torch.kernels.paged_prefill_attention import \
    paged_prefill_attention  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)


def _case(seed, *, b, h, kh, hd, bs, nb, quant, alias, c=1, g=None):
    """Random pools, tables and lengths as numpy.  ``alias`` makes lanes
    share their first blocks (prefix sharing); the first row has length 0
    (a decode pad row with a null table)."""
    rng = np.random.default_rng(seed)
    lead = () if g is None else (g,)
    p_blocks = 1 + b * nb
    kf = rng.normal(size=lead + (p_blocks, bs, kh, hd)).astype(np.float32)
    vf = rng.normal(size=lead + (p_blocks, bs, kh, hd)).astype(np.float32)
    perm = rng.permutation(np.arange(1, p_blocks)).reshape(b, nb)
    if alias:
        perm[:, :2] = perm[0, :2]
    tables = perm.astype(np.int32)
    lengths = rng.integers(1, nb * bs + 1, b).astype(np.int32)
    lengths[0] = 0
    tables[0] = 0
    case = dict(tables=tables, lengths=lengths,
                q=rng.normal(size=lead + (b, h, hd)).astype(np.float32),
                qc=rng.normal(size=lead + (b, c, h, hd)).astype(np.float32))
    starts = rng.integers(0, nb * bs - c + 1, b)
    case["positions"] = (starts[:, None] + np.arange(c)).astype(np.int32)
    if quant:
        kq, ks = quantize_kv(torch.from_numpy(kf))
        vq, vs = quantize_kv(torch.from_numpy(vf))
        case.update(k=kq.numpy(), v=vq.numpy(), ks=ks.numpy(), vs=vs.numpy())
    else:
        case.update(k=kf, v=vf, ks=None, vs=None)
    return case


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


GEOMS = [  # (h, kh, hd, bs, nb, softcap): MHA, GQA rep 2 and 4, softcap
    (4, 4, 32, 4, 4, 0.0), (8, 4, 32, 8, 3, 0.0), (8, 2, 64, 4, 5, 0.0),
    (8, 2, 64, 4, 5, 5.0)]


@pytest.mark.parametrize("geom", GEOMS)
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("alias", [False, True], ids=["own", "aliased"])
def test_decode_plain_matches_jax_ref(geom, quant, alias):
    h, kh, hd, bs, nb, softcap = geom
    cs = _case(1, b=4, h=h, kh=kh, hd=hd, bs=bs, nb=nb, quant=quant,
               alias=alias)
    got = paged_decode_attention(
        _t(cs["q"]), _t(cs["k"]), _t(cs["v"]), _t(cs["tables"]),
        _t(cs["lengths"]), k_scale=_t(cs["ks"]), v_scale=_t(cs["vs"]),
        softcap=softcap).numpy()
    want = np.asarray(jref.paged_decode_attention_ref(
        _j(cs["q"]), _j(cs["k"]), _j(cs["v"]), _j(cs["tables"]),
        _j(cs["lengths"]), k_scale=_j(cs["ks"]), v_scale=_j(cs["vs"]),
        softcap=softcap))
    np.testing.assert_allclose(got[1:], want[1:], **TOL)
    assert (got[0] == 0).all()            # the length-0 pad row


@pytest.mark.parametrize("geom", GEOMS)
@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("alias", [False, True], ids=["own", "aliased"])
def test_prefill_plain_matches_jax_ref(geom, quant, alias):
    h, kh, hd, bs, nb, softcap = geom
    cs = _case(2, b=3, h=h, kh=kh, hd=hd, bs=bs, nb=nb, quant=quant,
               alias=alias, c=6)
    got = paged_prefill_attention(
        _t(cs["qc"]), _t(cs["k"]), _t(cs["v"]), _t(cs["tables"]),
        _t(cs["positions"]), k_scale=_t(cs["ks"]), v_scale=_t(cs["vs"]),
        softcap=softcap).numpy()
    want = np.asarray(jref.paged_prefill_attention_ref(
        _j(cs["qc"]), _j(cs["k"]), _j(cs["v"]), _j(cs["tables"]),
        _j(cs["positions"]), k_scale=_j(cs["ks"]), v_scale=_j(cs["vs"]),
        softcap=softcap))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_branch_dim_equals_per_branch(quant):
    """A leading branch dim (the semantic split's pools) equals running
    each branch on its own pool with the shared tables."""
    cs = _case(3, b=3, h=4, kh=2, hd=32, bs=4, nb=3, quant=quant,
               alias=True, c=4, g=2)
    kw = lambda i: dict(k_scale=None if cs["ks"] is None
                        else _t(cs["ks"])[i],
                        v_scale=None if cs["vs"] is None else _t(cs["vs"])[i])
    both = paged_decode_attention(
        _t(cs["q"]), _t(cs["k"]), _t(cs["v"]), _t(cs["tables"]),
        _t(cs["lengths"]), k_scale=_t(cs["ks"]), v_scale=_t(cs["vs"]))
    chunk = paged_prefill_attention(
        _t(cs["qc"]), _t(cs["k"]), _t(cs["v"]), _t(cs["tables"]),
        _t(cs["positions"]), k_scale=_t(cs["ks"]), v_scale=_t(cs["vs"]))
    for i in range(2):
        one = paged_decode_attention(
            _t(cs["q"])[i], _t(cs["k"])[i], _t(cs["v"])[i], _t(cs["tables"]),
            _t(cs["lengths"]), **kw(i))
        torch.testing.assert_close(both[i], one, atol=0, rtol=0)
        one = paged_prefill_attention(
            _t(cs["qc"])[i], _t(cs["k"])[i], _t(cs["v"])[i],
            _t(cs["tables"]), _t(cs["positions"]), **kw(i))
        torch.testing.assert_close(chunk[i], one, atol=0, rtol=0)


def test_torch_ref_matches_jax_ref_dense_decode():
    """The port's dense decode oracle equals the jnp one on a contiguous
    cache (the oracle the paged versions defer to)."""
    rng = np.random.default_rng(4)
    q = rng.normal(size=(3, 4, 32)).astype(np.float32)
    k = rng.normal(size=(3, 10, 2, 32)).astype(np.float32)
    v = rng.normal(size=(3, 10, 2, 32)).astype(np.float32)
    length = np.asarray([1, 7, 10], np.int32)
    got = tref.decode_attention_ref(_t(q), _t(k), _t(v), _t(length)).numpy()
    want = np.asarray(jref.decode_attention_ref(_j(q), _j(k), _j(v),
                                                _j(length)))
    np.testing.assert_allclose(got, want, **TOL)
