"""CPU evidence for the flash-attention forward's two Hopper kernels
(``csrc/flash_attention.cu``): the walk rule they share
(``_flash_launch.flash_plan``) and a plain-torch emulation of their
numerics (``flash_attention.flash_attention_emulated``), held to
``flash_attention_plain`` and to the JAX package's oracle
(``repro.kernels.ref.flash_attention_ref``) on the same numpy inputs.

The limit is the kernels' own (``flash_attention.FLASH_TOL``, as on the
card): tol times each output row's max |plain|, f32 1e-4, bf16 1e-2.  The
same check must reject the emulation with one walked key tile left out.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import _flash_launch  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    FLASH_TOL, flash_attention_emulated, flash_attention_plain)

KT = _flash_launch.KEY_TILE
QT = _flash_launch.QUERY_TILE


def _np(t):
    return np.asarray(t.float().numpy())


def _jnp(t):
    """A torch tensor as jnp with equal values (bf16 stays bf16)."""
    if t.dtype == torch.bfloat16:
        return jnp.asarray(_np(t), jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _allowed(sq, sk, causal, window):
    """[Sq, Sk] bool: the (query, key) pairs the mask keeps."""
    qpos = np.arange(sq)[:, None] + sk - sq
    kpos = np.arange(sk)[None, :]
    ok = np.ones((sq, sk), bool)
    if causal:
        ok &= kpos <= qpos
    if window:
        ok &= kpos > qpos - window
    return ok


# (n, sq, sk, h, kh, hd, causal, window, softcap)
CASES = [
    (1, 320, 320, 2, 2, 64, True, 0, 0.0),          # MHA
    (1, 300, 300, 8, 2, 32, True, 0, 0.0),          # GQA 4:1, ragged
    (1, 150, 420, 4, 1, 128, True, 0, 0.0),         # MQA, Sq < Sk
    (2, 400, 400, 2, 1, 64, True, 200, 30.0),       # window + softcap
    (1, 200, 333, 2, 1, 128, False, 0, 0.0),        # non-causal, ragged
]


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_emulation_matches_plain_and_jax(dt, case):
    n, sq, sk, h, kh, hd, causal, window, softcap = case
    rng = np.random.default_rng(sq + sk + hd)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (n, s, heads, hd), np.float32)).to(dt)
        for s, heads in ((sq, h), (sk, kh), (sk, kh)))
    opts = dict(causal=causal, window=window, softcap=softcap)
    got = flash_attention_emulated(q, k, v, **opts)
    assert got.shape == q.shape and got.dtype == dt
    got = _np(got)
    want = _np(flash_attention_plain(q, k, v, **opts))
    oracle = np.asarray(jref.flash_attention_ref(
        _jnp(q), _jnp(k), _jnp(v), **opts), np.float32)
    tol = FLASH_TOL[dt]
    for ref_out in (want, oracle):
        limit = tol * np.abs(ref_out).max(-1, keepdims=True)
        diff = np.abs(got - ref_out)
        assert (diff <= limit).all(), float((diff / limit).max())
    # one walked key tile left out (the fourth from the end of each query
    # tile's walk): the check rejects it in every row whose own walk (the
    # tiles holding an unmasked key for it) covers >= 4 tiles, as any such
    # row's walk holds that tile
    bad = _np(flash_attention_emulated(q, k, v, drop_tile=-4, **opts))
    limit = tol * np.abs(want).max(-1, keepdims=True)
    over = (np.abs(bad - want) > limit).any(-1)                 # [N, Sq, H]
    keys = np.flatnonzero
    ok = _allowed(sq, sk, causal, window)
    lo = np.array([keys(r)[0] for r in ok]) // KT
    hi = np.array([keys(r)[-1] for r in ok]) // KT
    long = hi - lo + 1 >= 4
    assert long.any() and over[:, long].all()


@pytest.mark.parametrize("seed", range(4))
def test_flash_plan_covers_each_unmasked_pair_once(seed):
    """Over random (Sq, Sk, causal, window): the walked tiles cover
    every unmasked (query, key) pair exactly once, and each holds one; a
    tile is marked for a mask exactly when it holds a masked pair (keys
    past Sk count as masked)."""
    rng = np.random.default_rng(seed)
    for _ in range(40):
        sk = int(rng.integers(1, 700))
        sq = int(rng.integers(1, sk + 1))
        causal = bool(rng.integers(2))
        window = int(rng.choice([0, 0, 1, 17, 64, 100, 300]))
        plan = _flash_launch.flash_plan(sq, sk, causal=causal, window=window)
        assert [t.q0 for t in plan] == list(range(0, sq, QT))
        assert plan[-1].q1 == sq
        ok = np.zeros((sq, -(-sk // KT) * KT), bool)
        ok[:, :sk] = _allowed(sq, sk, causal, window)
        seen = np.zeros(ok.shape, int)
        for t in plan:
            assert t.kt1 > t.kt0 and len(t.masked) == t.kt1 - t.kt0
            for kt, masked in zip(range(t.kt0, t.kt1), t.masked):
                block = ok[t.q0:t.q1, kt * KT:(kt + 1) * KT]
                assert block.any(), (sq, sk, t, kt)      # no dead tile
                assert masked == (not block.all()), (sq, sk, t, kt)
                seen[t.q0:t.q1, kt * KT:(kt + 1) * KT] += 1
        assert (seen[ok] == 1).all() and seen.max() <= 1


@pytest.mark.parametrize("hd", _flash_launch.HEAD_DIMS)
@pytest.mark.parametrize("dt,path", [(torch.bfloat16, "mma"),
                                     (torch.float32, "simt")],
                         ids=["bf16", "f32"])
def test_flash_path_rule(dt, path, hd):
    """bf16 on the tensor cores, f32 on the CUDA cores, at every head dim;
    every path walks query tiles of ``QUERY_TILE`` rows."""
    assert _flash_launch.path_for(dt) == path
    sq = 3 * QT - 5
    plan = _flash_launch.flash_plan(sq, sq + hd, causal=True, window=0)
    assert [(t.q0, t.q1) for t in plan] == [(0, QT), (QT, 2 * QT),
                                            (2 * QT, sq)]
