"""CPU evidence for the tensor-core paths of the port's kernels: plain-torch
emulations that walk the CUDA kernels' tiles, held to the plain versions
and to the JAX package's oracles (``repro.kernels.ref``) with the
tolerances that the chip check (``chip_smoke.py``) and
``tests/test_torch_gpu.py`` hold the kernels to, plus the pure-Python
rules that pick each launch's path.

- The grouped GEMM's bf16 tile (``_gemm_launch.wgmma_emulated``): 64-deep
  K slabs summed into f32, one cast; held as |emulated - plain| <=
  2e-2 (1 + |plain|).
- Its decode-sized tiles (``_gemm_launch.skinny_emulated``): the cluster
  plan (``_gemm_launch.skinny_plan``), each rank's contraction slice in
  k16 steps (``mma_skinny``) or 32-deep slabs (``skinny``) summed in f32,
  the ranks merged in rank order, one cast; held as |emulated - plain| <=
  tol (1 + |plain|), tol 2e-2 in bf16 and 2e-4 in f32 (the chip check's
  ``QTOL``); the plan covers every contraction row once.
- Its CUDA-core tile for M > 32 (``_gemm_launch.tiled_emulated``, path
  ``tiled``: every f32 call and the bf16 calls whose pointers or strides
  the tensor cores cannot take): (64 MH) x 128 output tiles, each split's
  contraction in 16-deep slabs summed in f32, the split-K partials added in
  split order, one cast; held as the decode-sized tiles are, and the same
  check must reject the output with one output tile left out (in every row
  of that tile) and with one split left out (in every output row).
- The bf16-q paged prefill
  (``paged_prefill_attention.paged_prefill_attention_emulated``): 64-row
  query tiles, 64-token K/V tiles through the table, f32 max, sum and
  accumulator, P rounded to bf16 (int8 pools: K scale on the scores, V
  scale on P); held as |emulated - plain| <= 2e-2 times each output row's
  max |plain|, and the same check must reject the plain output with the
  first 64-token tile of every row longer than 256 keys left out.
- The f32-q paged prefill on the CUDA cores
  (``paged_prefill_attention.paged_prefill_attention_simt_emulated``,
  path ``prefill_simt``: every f32 chunk of a mesh's paged path): 32-row
  query tiles, 32-token K/V tiles (16 at head dim 128) through the table,
  queries pre-scaled, f32 max, sum and accumulator, P unrounded; held as
  |emulated - plain| <= 1e-4 (the chip check's f32 tolerance) times each
  output row's max |plain|, and the same check must reject the emulation
  with one K/V tile left out, in every row that tile holds keys of.
- ``quant_matmul``'s tensor-core paths
  (``quant_matmul.quant_matmul_emulated``): the kernel's split of the groups
  (``_quant_launch.mma_plan``), each group's k16 steps summed in f32 on the
  codes (int4 rows by the kernel's nibble arithmetic), scaled once per
  group, the splits added in order; held as |emulated - plain| <= 2e-2 (1 +
  |plain|), and the same check must reject the output with a group or a
  whole split left out, in every output row.
- ``quant_matmul``'s CUDA-core path (``quant_matmul.
  quant_matmul_simt_emulated``, ``simt``: f32 x, every quantized
  projection of a mesh's f32 paged path): the groups split over CTAs
  (``_quant_launch.split_count``) at decode-sized T, each group's product a
  128-row slab (32 above; int4 a slab's low nibbles, then its high ones) in
  f32, scaled once, the splits added in order by the reduce kernel; held as
  |emulated - plain| <= 2e-4 (1 + |plain|) (the chip check's ``QTOL``),
  rejecting a group or a whole split left out in every output row.
- The grouped GEMM's ragged entry (``_gemm_launch.ragged_emulated``, the
  MoE's compacted expert product): the walk of its tiles
  (``_gemm_launch.ragged_walk``: decode-sized, each group's rows in 8-row
  passes; prefill-sized, slots mapped to (group, row block) over the
  offsets) covering every output element once, each tile's rows masked at
  its segment's end and summed in f32 in the kernel's steps, the rows past
  offsets[-1] zero; held to ``moe_gmm_ragged_plain`` and, segment by
  segment, to the JAX ``moe_gmm_ref`` as the grouped GEMM is, with empty,
  one-row and longer-than-a-tile segments, and the same check must reject
  the output with one row tile left out.
- ``paged_decode_attention``'s ``decode_split`` kernel
  (``paged_decode_attention.paged_decode_attention_emulated``): pieces of
  the table (``_paged_launch.decode_plan``), token groups each with f32
  max, sum and accumulator, the groups and then the pieces merged in
  order; held as the prefill is, the check rejecting the output with a
  piece left out in every lane it touches.

The same numpy inputs go to both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.decode.paged_cache import quantize_kv  # noqa: E402
from repro_torch.kernels import (_gemm_launch, _paged_launch,  # noqa: E402
                                 _quant_launch)
from repro_torch.kernels._decode_launch import CHUNK  # noqa: E402
from repro_torch.kernels.block_diag_matmul import \
    block_diag_matmul_plain  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention_emulated, decode_attention_plain)
from repro_torch.kernels.moe_gmm import (moe_gmm_plain,  # noqa: E402
                                         moe_gmm_ragged_plain)
from repro_torch.kernels.paged_decode_attention import (  # noqa: E402
    paged_decode_attention_emulated, paged_decode_attention_plain)
from repro_torch.kernels.paged_prefill_attention import (  # noqa: E402
    paged_prefill_attention_emulated, paged_prefill_attention_plain,
    paged_prefill_attention_simt_emulated, simt_tile)
from repro_torch.kernels.quant_matmul import (  # noqa: E402
    quant_matmul_emulated, quant_matmul_plain, quant_matmul_simt_emulated,
    quantize_blockwise)

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


#: the chip check's tolerances by dtype (``chip_smoke.QTOL``)
GEMM_TOL = {torch.bfloat16: TOL, torch.float32: 2e-4}


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("g,k,n,pad,path", [
    (2, 200, 72, 0, "mma_skinny"),      # ragged K and N, one cluster slab
    (3, 70, 40, 2, "mma_skinny"),       # K = 70 in a 72-wide buffer
    (1, 4100, 33, 0, "skinny"),         # odd N: w rows not 16-byte aligned
    (4, 384, 384, 0, "mma_skinny")])    # the mLSTM's q/k/v, 64 columns
@pytest.mark.parametrize("m", [1, 8, 20, 32])
def test_skinny_emulation_matches_plain_and_jax(dt, g, k, n, pad, path, m):
    rng = np.random.default_rng(m + k + n)
    x = torch.from_numpy(rng.standard_normal((g, m, k + pad), np.float32)) \
        .to(dt)[..., :k]
    w = torch.from_numpy(rng.standard_normal((g, k, n), np.float32)
                         / np.sqrt(k)).to(dt)
    want_path = path if dt == torch.bfloat16 else "skinny"
    assert _gemm_launch.path_for(x, w) == want_path
    _, _, splits, _ = _gemm_launch.skinny_plan(want_path, g, m, k, n, 132)
    assert splits > 1                    # the merge is on the walk
    got = _gemm_launch.skinny_emulated(x, w)
    assert got.shape == (g, m, n) and got.dtype == dt
    tol = GEMM_TOL[dt]
    for want in (block_diag_matmul_plain(x, w).float().numpy(),
                 np.asarray(jref.block_diag_matmul_ref(_jnp(x), _jnp(w)),
                            np.float32)):
        diff = np.abs(_np(got) - want)
        assert (diff <= tol * (1 + np.abs(want))).all(), diff.max()


def _tiled_case(dt, g, m, k, n, x_width, w_width):
    """x [g, m, k] and w [g, k, n] cut from buffers ``x_width`` and
    ``w_width`` wide (a bf16 row stride that is no multiple of 16 bytes
    keeps the call off the tensor cores)."""
    rng = np.random.default_rng(m + k + n)
    x = torch.from_numpy(rng.standard_normal((g, m, x_width), np.float32)) \
        .to(dt)[..., :k]
    w = torch.from_numpy(rng.standard_normal((g, k, w_width), np.float32)
                         / np.sqrt(k)).to(dt)[..., :n]
    return x, w


@pytest.mark.parametrize("dt,g,m,k,n,x_width,w_width", [
    (torch.float32, 2, 65, 200, 72, 200, 72),      # one 128-row tile
    (torch.float32, 3, 171, 72, 130, 72, 130),     # 64-row tiles, ragged N
    (torch.float32, 1, 200, 1000, 96, 1000, 96),   # ragged last slab
    (torch.bfloat16, 2, 171, 64, 200, 70, 200),    # x rows 140 B apart
    (torch.bfloat16, 2, 100, 300, 50, 300, 50)],   # w rows 100 B apart
    ids=["f32-m65", "f32-m171", "f32-m200", "bf16-x140B", "bf16-w100B"])
def test_tiled_emulation_matches_plain_and_jax(dt, g, m, k, n, x_width,
                                               w_width):
    """The CUDA-core tile with K split over CTAs, held to both plain
    versions and both JAX oracles; the check rejects a dropped output tile
    in every row of that tile and a dropped split in every output row."""
    x, w = _tiled_case(dt, g, m, k, n, x_width, w_width)
    assert _gemm_launch.path_for(x, w) == "tiled"
    _, tm, splits, _ = _gemm_launch._tiling("tiled", g, m, k, n, 132, "t")
    assert splits > 1                    # the split-K reduce is on the walk
    got = _gemm_launch.tiled_emulated(x, w)
    assert got.shape == (g, m, n) and got.dtype == dt
    tol = GEMM_TOL[dt]
    limit = lambda want: tol * (1 + np.abs(want))
    for plain, oracle in (
            (block_diag_matmul_plain, jref.block_diag_matmul_ref),
            (moe_gmm_plain, jref.moe_gmm_ref)):
        for want in (plain(x, w).float().numpy(),
                     np.asarray(oracle(_jnp(x), _jnp(w)), np.float32)):
            diff = np.abs(_np(got) - want)
            assert (diff <= limit(want)).all(), diff.max()
    want = _np(block_diag_matmul_plain(x, w))
    ri, ci = (m - 1) // tm, (n - 1) // 128
    bad = _np(_gemm_launch.tiled_emulated(x, w, drop_tile=(g - 1, ri, ci)))
    rows, cols = slice(ri * tm, m), slice(ci * 128, n)
    assert (np.abs(bad - want) > limit(want))[g - 1, rows, cols] \
        .any(-1).all()
    assert np.array_equal(np.delete(bad, g - 1, 0), np.delete(_np(got), g - 1,
                                                              0))
    bad = _np(_gemm_launch.tiled_emulated(x, w, drop_split=splits - 1))
    assert (np.abs(bad - want) > limit(want)).any(-1).all()


@pytest.mark.parametrize("path", ["mma_skinny", "skinny"])
@pytest.mark.parametrize("g,m,k,n,n_sm", [
    (4, 8, 384, 384, 132), (2, 8, 1024, 2816, 132), (2, 8, 2816, 1024, 132),
    (2, 32, 4096, 640, 132), (1, 1, 8192, 72, 132), (3, 5, 70, 33, 132),
    (1, 17, 1, 1, 132), (1, 8, 0, 5, 132), (64, 32, 4096, 4096, 132),
    (1, 8, 100000, 128, 1000), (2, 8, 384, 384, 1)])
@pytest.mark.parametrize("cols", [None, 64, 128])
def test_skinny_plan_covers_the_contraction(path, g, m, k, n, n_sm, cols):
    """Every contraction row is in exactly one rank's slice, every slice is
    non-empty and whole steps, no cluster has more than 8 CTAs; the tensor-
    core tile covers the call's rows in one row tile, the CUDA-core tile
    takes 8 rows a tile; a forced width is kept."""
    rows, width, splits, per = _gemm_launch.skinny_plan(
        path, g, m, k, n, n_sm, cols=cols)
    step = _gemm_launch.SKINNY_STEP[path]
    assert 1 <= splits <= _gemm_launch.MAX_SPLITS == 8
    assert per % step == 0 and per >= step
    if path == "mma_skinny":
        assert rows >= m and rows in (8, 16, 32) and width in (64, 128)
    else:
        assert rows == 8 and width in (32, 64, 128)
    assert width == (cols or width)
    covered = np.zeros(k, int)
    for rank in range(splits):
        lo, hi = rank * per, min(k, (rank + 1) * per)
        assert hi > lo or k == 0
        covered[lo:hi] += 1
    assert (covered == 1).all()


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
        "decode rows f32": (x[:, :32, :64].float(), w.float()),
        "decode rows 2 B off": (x[:, :32, 1:65], w),
    }[cut]


@pytest.mark.parametrize("cut,path", [
    ("aligned", "wgmma"), ("f32", "tiled"), ("decode rows", "mma_skinny"),
    ("decode rows f32", "skinny"), ("decode rows 2 B off", "skinny"),
    ("row stride 140 B", "tiled"), ("pointer 2 B off", "tiled"),
    ("broadcast group", "tiled"), ("w row stride 100 B", "tiled"),
    ("one group", "wgmma")])
def test_gemm_path_rule(cut, path):
    """The path depends on dtype, shape and alignment alone, decided before
    any launch (these are CPU tensors: nothing launches)."""
    assert _gemm_launch.path_for(*_gemm_args(cut)) == path


#: the ragged entry's cases: (R, segment rows by group); the rows past the
#: last segment are the dropped assignments (zero rows)
RAGGED_CASES = {"decode": (40, [0, 1, 20, 0, 12, 0]),
                "prefill": (300, [0, 1, 150, 0, 100])}


def _ragged_case(dt, which, k=72, n=130):
    r, counts = RAGGED_CASES[which]
    rng = np.random.default_rng(r + k)
    x = torch.from_numpy(rng.standard_normal((r, k), np.float32)).to(dt)
    w = torch.from_numpy(rng.standard_normal((len(counts), k, n), np.float32)
                         / np.sqrt(k)).to(dt)
    return x, w, [0] + np.cumsum(counts).tolist()


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("which", ["decode", "prefill"])
def test_ragged_emulation_matches_plain_and_jax(dt, which):
    """The ragged entry's tiles, held to ``moe_gmm_ragged_plain`` and to
    the JAX oracle segment by segment (empty, one-row and
    longer-than-a-tile segments; zero rows past the last); the check
    rejects the output with one row tile of the longest segment left out,
    in every row of that tile."""
    x, w, off = _ragged_case(dt, which)
    r, n = x.shape[0], w.shape[2]
    assert _gemm_launch.ragged_path_for(x, w) == f"ragged_{which}"
    got = _gemm_launch.ragged_emulated(x, w, off)
    plain = moe_gmm_ragged_plain(x, w, torch.tensor(off, dtype=torch.int32))
    assert got.shape == plain.shape == (r, n) and got.dtype == dt
    limit = lambda want: GEMM_TOL[dt] * (1 + np.abs(want))
    want = _np(plain)
    assert (np.abs(_np(got) - want) <= limit(want)).all()
    assert not _np(got)[off[-1]:].any() and not want[off[-1]:].any()
    for g, (lo, hi) in enumerate(zip(off, off[1:])):
        if hi > lo:
            seg = np.asarray(jref.moe_gmm_ref(_jnp(x[None, lo:hi]),
                                              _jnp(w[g:g + 1]))[0],
                             np.float32)
            assert (np.abs(_np(got)[lo:hi] - seg) <= limit(seg)).all()
    walk = _gemm_launch.ragged_walk(off, r, n, f"ragged_{which}", dt)
    drop = next(i for i, t in enumerate(walk) if t[0] == 2)
    _, r0, r1, c0, c1 = walk[drop]
    assert r1 - r0 > 1
    bad = _np(_gemm_launch.ragged_emulated(x, w, off, drop_tile=drop))
    assert (np.abs(bad - want) > limit(want))[r0:r1, c0:c1].any(-1).all()
    assert np.array_equal(np.delete(bad, np.s_[r0:r1], 0),
                          np.delete(_np(got), np.s_[r0:r1], 0))


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("r,counts", [
    (32, [0] * 50 + [2, 3, 0, 9, 1] + [0] * 5), (64, [64] + [0] * 59),
    (4096, [68] * 60), (4096, [0, 4000, 0, 1]), (130, [1] * 7),
    (65, [])], ids=["decode32", "decode64-one", "prefill4096",
                    "prefill-skew", "prefill-ones", "all-dropped"])
def test_ragged_walk_covers_every_element_once(dt, r, counts):
    """The walk writes every output element exactly once (products on the
    segments, zeros past offsets[-1]) within the launch's static slots,
    each tile inside one segment, whatever the offsets."""
    n = 300
    off = [0] + np.cumsum(counts).tolist() if counts else [0]
    path = "ragged_decode" if r <= _gemm_launch.RAGGED_DECODE_R \
        else "ragged_prefill"
    walk = _gemm_launch.ragged_walk(off, r, n, path, dt)
    seen = np.zeros((r, n), int)
    g = len(off) - 1
    for gi, r0, r1, c0, c1 in walk:
        seen[r0:r1, c0:c1] += 1
        lo, hi = (off[gi], off[gi + 1]) if gi < g else (off[-1], r)
        assert lo <= r0 < r1 <= hi
    assert (seen == 1).all()
    if path == "ragged_prefill":
        bm = _gemm_launch.ragged_tile_rows(r, g, dt)
        assert len({(t[0], t[1]) for t in walk}) <= \
            _gemm_launch.ragged_slots(r, g, bm)


@pytest.mark.parametrize("r,g,dt,path,rows", [
    (32, 60, torch.bfloat16, "ragged_decode", None),
    (64, 60, torch.float32, "ragged_decode", None),
    (65, 60, torch.bfloat16, "ragged_prefill", 64),
    (4096, 60, torch.bfloat16, "ragged_prefill", 128),
    (8192, 60, torch.bfloat16, "ragged_prefill", 192),
    (4096, 60, torch.float32, "ragged_prefill", 128),
    (1024, 60, torch.float32, "ragged_prefill", 64)])
def test_ragged_path_rule(r, g, dt, path, rows):
    """The tiling follows from R alone (never the offsets), the prefill
    tile's rows from R / G and the dtype."""
    x, w = torch.zeros(r, 16, dtype=dt), torch.zeros(g, 16, 8, dtype=dt)
    assert _gemm_launch.ragged_path_for(x, w) == path
    if rows:
        assert _gemm_launch.ragged_tile_rows(r, g, dt) == rows


@pytest.mark.parametrize("dt,chunk,path", [
    (torch.bfloat16, True, "prefill_mma"),
    (torch.float32, True, "prefill_simt"),
    (torch.bfloat16, False, "decode_split"),
    (torch.float32, False, "decode_split")])
def test_paged_path_rule(dt, chunk, path):
    assert _paged_launch.path_for(dt, chunk) == path


# ------------------------------------------------------- paged prefill
def _prefill_case(kind, *, hd, c, g, b=4, h=8, kh=2, bs=16, nb=24,
                  qdt=torch.bfloat16):
    """GQA 4 with ``qdt`` q (bf16 pools for kind "bf16", f32 for "f32"):
    lane 0 a null table at positions from 0, lanes 1-3 alias lane 1's first
    four blocks, lane 1's rows pass 256 keys, lane 3's chunk runs past the
    table."""
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
                                               np.float32)).to(qdt),
        tables=torch.from_numpy(tables.astype(np.int32)),
        positions=torch.from_numpy(
            (starts[:, None] + np.arange(c)).astype(np.int32)))
    if kind == "int8":
        (k, ks), (v, vs) = quantize_kv(kf), quantize_kv(vf)
        case.update(k=k, v=v, kw=dict(k_scale=ks, v_scale=vs))
    else:
        dt = torch.bfloat16 if kind == "bf16" else torch.float32
        case.update(k=kf.to(dt), v=vf.to(dt), kw={})
    return case


def _row_limit(want, tol=TOL):
    return tol * np.abs(want).max(-1, keepdims=True)


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


#: the chip check's f32 attention tolerance (``chip_smoke.TOL["f32"]``)
F32_TOL = 1e-4


@pytest.mark.parametrize("kind", ["f32", "int8"])
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("c,g,softcap", [(1, 1, 0.0), (33, 2, 30.0)])
def test_prefill_simt_emulation_matches_plain_and_jax(kind, hd, c, g,
                                                      softcap):
    """The f32-q prefill's tiles against the plain version and the JAX
    oracle; the check rejects the output with the second K/V tile left
    out, in every query row with a key in it (and in no other row), on the
    lanes with a table (lane 0's null table repeats one block, so its
    tiles are copies of each other)."""
    cs = _prefill_case(kind, hd=hd, c=c, g=g, qdt=torch.float32)
    args = (cs["q"], cs["k"], cs["v"], cs["tables"], cs["positions"])
    kw = dict(cs["kw"], softcap=softcap)
    assert _paged_launch.path_for(cs["q"].dtype, True) == "prefill_simt"
    got = _np(paged_prefill_attention_simt_emulated(*args, **kw))
    want = _np(paged_prefill_attention_plain(*args, **kw))
    assert got.shape == tuple(cs["q"].shape)
    oracle = np.stack([np.asarray(jref.paged_prefill_attention_ref(
        _jnp(cs["q"][i]), _jnp(cs["k"][i]), _jnp(cs["v"][i]),
        _jnp(cs["tables"]), _jnp(cs["positions"]),
        **{n: _jnp(s[i]) for n, s in cs["kw"].items()}, softcap=softcap),
        np.float32) for i in range(g)])
    for ref_out in (want, oracle):
        diff = np.abs(got - ref_out)
        assert (diff <= _row_limit(ref_out, F32_TOL)).all(), diff.max()
    tile = simt_tile(hd)
    bad = _np(paged_prefill_attention_simt_emulated(*args, drop_tile=1,
                                                    **kw))
    over = (np.abs(bad - want) > _row_limit(want, F32_TOL)).any((-2, -1))
    hit = _np(cs["positions"]) >= tile                       # [B, C]
    over, hit = over[:, 1:], hit[1:]
    assert hit.any() and over[:, hit].all() and not over[:, ~hit].any()


# ---------------------------------------------------------- quant GEMM
def _quant_case(*, g, t, bits, group, d=256, e=208):
    rng = np.random.default_rng(t + group + bits + g)
    w = torch.from_numpy(rng.standard_normal((g, d, e), np.float32)
                         / np.sqrt(d))
    q, s = quantize_blockwise(w, bits=bits, group=group)
    x = torch.from_numpy(rng.standard_normal((g, t, d), np.float32)) \
        .bfloat16()
    return x, q, s


def _quant_limit(want):
    return TOL * (1 + np.abs(want))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("group", [32, 128])
@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("t", [1, 8, 33, 200])
def test_quant_emulation_matches_plain_and_jax(bits, group, g, t):
    """E = 208 is not a multiple of the 128-column tile; T 1 and 8 split the
    groups (mma_skinny), 33 and 200 do not (mma_tile)."""
    x, q, s = _quant_case(g=g, t=t, bits=bits, group=group)
    got = quant_matmul_emulated(x, q, s)
    assert got.shape == (g, t, 208) and got.dtype == torch.bfloat16
    want = _np(quant_matmul_plain(x, q, s))
    oracle = np.stack([np.asarray(jref.quant_matmul_ref(
        _jnp(x[i]), jnp.asarray(q[i].numpy()), jnp.asarray(s[i].numpy()),
        bits=bits), np.float32) for i in range(g)])
    for ref_out in (want, oracle):
        diff = np.abs(_np(got) - ref_out)
        assert (diff <= _quant_limit(ref_out)).all(), diff.max()
    # a kernel that skips the last group, or the last split, fails the same
    # check in every output row
    n_g = 256 // group
    _, splits, per = _quant_launch.mma_plan(g, t, 208, n_g, 132)
    last = range((splits - 1) * per, n_g)
    for drop in ({n_g - 1}, set(last)):
        bad = _np(quant_matmul_emulated(x, q, s, drop_group=drop))
        assert (np.abs(bad - want) > _quant_limit(want)).any(-1).all()


#: the chip check's f32 quant tolerance (``chip_smoke.QTOL``)
QUANT_F32_TOL = 2e-4


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("group", [32, 128])
@pytest.mark.parametrize("t", [1, 8, 33, 200])
def test_quant_simt_emulation_matches_plain_and_jax(bits, group, t):
    """f32 x on the CUDA-core path, two branches: T 1 and 8 split the groups
    over CTAs (and reduce in order), 33 and 200 do not; E = 208 is not a
    multiple of the 32- or 64-column tiles."""
    x, q, s = _quant_case(g=2, t=t, bits=bits, group=group)
    x = x.float()
    assert _quant_launch.path_for(x.dtype, t, 256, 208, group, bits) == \
        "simt"
    got = quant_matmul_simt_emulated(x, q, s)
    assert got.shape == (2, t, 208) and got.dtype == torch.float32
    want = _np(quant_matmul_plain(x, q, s))
    oracle = np.stack([np.asarray(jref.quant_matmul_ref(
        _jnp(x[i]), jnp.asarray(q[i].numpy()), jnp.asarray(s[i].numpy()),
        bits=bits), np.float32) for i in range(2)])
    limit = lambda w: QUANT_F32_TOL * (1 + np.abs(w))
    for ref_out in (want, oracle):
        diff = np.abs(_np(got) - ref_out)
        assert (diff <= limit(ref_out)).all(), diff.max()
    n_g = 256 // group
    splits = _quant_launch.split_count(2, t, 208, n_g, 132)
    assert (splits > 1) == (t <= _quant_launch.DECODE_T)
    per = -(-n_g // splits)
    for drop in ({n_g - 1}, set(range((splits - 1) * per, n_g))):
        bad = _np(quant_matmul_simt_emulated(x, q, s, drop_group=drop))
        assert (np.abs(bad - want) > limit(want)).any(-1).all()


@pytest.mark.parametrize("g,t,e,n_g", [
    (1, 8, 2048, 16), (2, 8, 1024, 8), (1, 1, 2048, 64), (2, 32, 96, 3),
    (1, 17, 208, 1), (3, 8, 16, 5), (1, 33, 2048, 16), (2, 1024, 1024, 8)])
def test_quant_mma_plan_covers_every_group_once(g, t, e, n_g):
    rows, splits, per = _quant_launch.mma_plan(g, t, e, n_g, 132)
    assert 1 <= splits <= _quant_launch.MAX_SPLITS
    spans = [range(i * per, min(n_g, (i + 1) * per)) for i in range(splits)]
    assert all(len(r) > 0 for r in spans)
    assert [gi for r in spans for gi in r] == list(range(n_g))
    if t > _quant_launch.DECODE_T:
        # 128-row tiles unless they leave more than half of 132 SMs idle
        assert splits == 1 and rows == {(1, 33): 64, (2, 1024): 128}[(g, t)]
    else:
        assert rows in (8, 16, 32) and t <= rows and (rows == 8 or 2 * t > rows)
    if (g, t, e) == (1, 8, 2048):                  # LAYER decode
        assert (splits, per) == (8, 2)


@pytest.mark.parametrize("xdt,t,d,e,group,bits,aligned,path", [
    (torch.bfloat16, 8, 2048, 2048, 128, 8, True, "mma_skinny"),
    (torch.bfloat16, 32, 2048, 2048, 128, 4, True, "mma_skinny"),
    (torch.bfloat16, 33, 2048, 2048, 128, 8, True, "mma_tile"),
    (torch.bfloat16, 1024, 1024, 1024, 32, 4, True, "mma_tile"),
    (torch.bfloat16, 8, 64, 48, 16, 8, True, "mma_skinny"),
    (torch.float32, 8, 2048, 2048, 128, 8, True, "simt"),
    (torch.float32, 1024, 2048, 2048, 128, 4, True, "simt"),
    (torch.bfloat16, 8, 64, 40, 64, 8, True, "simt"),        # E % 16
    (torch.bfloat16, 8, 64, 48, 8, 8, True, "simt"),         # group < 16
    (torch.bfloat16, 8, 64, 48, 16, 4, True, "simt"),        # int4: < 32
    (torch.bfloat16, 8, 96, 48, 24, 8, True, "simt"),        # group % 16
    (torch.bfloat16, 64, 96, 48, 48, 8, True, "mma_tile"),   # group 48
    (torch.bfloat16, 8, 512, 48, 256, 8, True, "simt"),      # group > 128
    (torch.bfloat16, 8, 2048, 2048, 128, 8, False, "simt"),  # a pointer
])
def test_quant_path_rule(xdt, t, d, e, group, bits, aligned, path):
    assert _quant_launch.path_for(xdt, t, d, e, group, bits,
                                  aligned) == path


# -------------------------------------------------------- paged decode
def _decode_case(kind, *, hd, h, kh, g, b=8, bs=16, nb=24):
    """Lane 0 has length 0 (null table); lanes 1-3 alias lane 1's first
    three blocks; lengths 1, bs, a piece boundary - 1, at and + 1, and the
    full table."""
    rng = np.random.default_rng(hd + h + g)
    p_blocks = 1 + b * nb
    kf = torch.from_numpy(rng.standard_normal((g, p_blocks, bs, kh, hd),
                                              np.float32))
    vf = torch.from_numpy(rng.standard_normal((g, p_blocks, bs, kh, hd),
                                              np.float32))
    tables = rng.permutation(np.arange(1, p_blocks)).reshape(b, nb)
    tables[2:4, :3] = tables[1, :3]
    tables[0] = 0
    item = {"f32": 4, "bf16": 2, "int8": 1}[kind]
    _, _, pieces, piece = _paged_launch.decode_plan(
        h=h, kh=kh, hd=hd, kv_item=item, b=b, g=1, nb=nb, bs=bs, n_sm=132)
    assert pieces > 1
    lengths = [0, 1, bs, piece - 1, piece, piece + 1, nb * bs, 300]
    qdt = torch.bfloat16 if kind == "bf16" else torch.float32
    case = dict(
        q=torch.from_numpy(rng.standard_normal((g, b, h, hd), np.float32))
        .to(qdt), tables=torch.from_numpy(tables.astype(np.int32)),
        lengths=torch.tensor(lengths, dtype=torch.int32), piece=piece)
    if kind == "int8":
        (k, ks), (v, vs) = quantize_kv(kf), quantize_kv(vf)
        case.update(k=k, v=v, kw=dict(k_scale=ks, v_scale=vs))
    else:
        case.update(k=kf.to(qdt), v=vf.to(qdt), kw={})
    return case


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("heads,g,softcap", [((8, 8), 1, 0.0),
                                             ((8, 2), 2, 30.0)])
def test_decode_emulation_matches_plain_and_jax(kind, hd, heads, g,
                                                softcap):
    h, kh = heads
    cs = _decode_case(kind, hd=hd, h=h, kh=kh, g=g)
    args = (cs["q"], cs["k"], cs["v"], cs["tables"], cs["lengths"])
    kw = dict(cs["kw"], softcap=softcap)
    got = _np(paged_decode_attention_emulated(*args, **kw))
    want = _np(paged_decode_attention_plain(*args, **kw))
    assert got.shape == tuple(cs["q"].shape)
    oracle = np.stack([np.asarray(jref.paged_decode_attention_ref(
        _jnp(cs["q"][i]), _jnp(cs["k"][i]), _jnp(cs["v"][i]),
        _jnp(cs["tables"]), _jnp(cs["lengths"]),
        **{n: _jnp(s[i]) for n, s in cs["kw"].items()}, softcap=softcap),
        np.float32) for i in range(g)])
    # the JAX oracle averages every key of a length-0 lane; the kernel and
    # the plain version write 0 there
    oracle[:, 0] = 0
    tol = {"f32": 1e-4, "bf16": TOL, "int8": 1e-3}[kind]
    for ref_out in (want, oracle):
        diff = np.abs(got - ref_out)
        assert (diff <= tol * np.abs(ref_out).max(-1, keepdims=True)).all(), \
            diff.max()
    assert (got[:, 0] == 0).all()
    # a kernel that skips a piece fails the check in every lane that piece
    # holds keys of
    lengths = cs["lengths"].numpy()
    for drop in (0, 1):
        bad = _np(paged_decode_attention_emulated(*args, drop_piece=drop,
                                                  **kw))
        hit = lengths > drop * cs["piece"]
        over = (np.abs(bad - want) > tol * np.abs(want).max(
            -1, keepdims=True)).any((-2, -1))                 # [G, B]
        assert hit.any() and over[:, hit].all() and not over[:, ~hit].any()


@pytest.mark.parametrize("h,kh,hd,item", [
    (32, 32, 64, 2), (16, 16, 128, 2), (32, 32, 64, 1), (16, 16, 128, 4),
    (8, 2, 32, 4), (6, 2, 32, 2), (32, 1, 64, 2), (12, 3, 64, 1)])
@pytest.mark.parametrize("nb,b", [(64, 8), (1, 1), (300, 2)])
def test_decode_plan(h, kh, hd, item, nb, b):
    """Heads per CTA fit a warp and eight rows; the pieces are whole blocks,
    at most eight (one cluster), each non-empty, and cover the table."""
    bs = 16
    hg, rt, pieces, piece = _paged_launch.decode_plan(
        h=h, kh=kh, hd=hd, kv_item=item, b=b, g=1, nb=nb, bs=bs, n_sm=132)
    vec = _paged_launch.load_elements(item)
    assert kh % hg == 0 and (h // kh) % rt == 0 and hg & (hg - 1) == 0
    assert hg * hd // vec <= 32 and hg * rt <= _paged_launch.DECODE_ROWS
    assert 1 <= pieces <= _paged_launch.MAX_PIECES and piece % bs == 0
    assert (pieces - 1) * piece < nb * bs <= pieces * piece
    if (h, kh, hd, item, nb, b) == (32, 32, 64, 2, 64, 8):   # stablelm bf16
        assert (hg, rt, pieces, piece) == (4, 1, 5, 208)


# ------------------------------------------------- dense decode attention
def _slab_lengths(L: int):
    """A rank's slab lengths of a length-sharded cache: empty (0), one
    slot, either side of the 256-slot pieces, whole; and the two ranks'
    slabs of a ring window of W = 1.5 L that has wrapped, whose valid slots
    are a prefix of the global slots: clamp(W - r * L, 0, L)."""
    ring = [min(max(3 * L // 2 - r * L, 0), L) for r in (0, 1)]
    return [0, 1, CHUNK - 1, CHUNK, CHUNK + 1, L] + ring


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("hd,heads", [(64, (8, 8)), (128, (8, 2))])
@pytest.mark.parametrize("softcap", [0.0, 50.0])
def test_dense_decode_emulation_with_lse(dt, hd, heads, softcap):
    """``decode_attention_emulated`` (256-slot pieces, one CTA each, token
    groups merged per piece, the pieces merged by ``decode_merge_kernel``,
    each row's log-sum-exp) against the plain version and the JAX oracle;
    a length-0 slab gives 0 and -inf, never NaN; a kernel that drops a
    piece fails the check in every row that piece holds slots of."""
    h, kh = heads
    L = 600                                         # three pieces
    rng = np.random.default_rng(hd + h)
    qdt = torch.bfloat16 if dt == "bf16" else torch.float32
    lengths = _slab_lengths(L)
    b = len(lengths)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, np.float32)).to(qdt)
               for s in ((b, h, hd), (b, L, kh, hd), (b, L, kh, hd)))
    length = torch.tensor(lengths, dtype=torch.int32)
    got, got_lse = decode_attention_emulated(q, k, v, length, softcap=softcap)
    want, want_lse = decode_attention_plain(q, k, v, length, softcap=softcap,
                                            return_lse=True)
    oracle = np.array(jref.decode_attention_ref(
        _jnp(q), _jnp(k), _jnp(v), _jnp(length), softcap=softcap),
        np.float32)
    oracle[0] = 0          # the JAX oracle averages a length-0 row's keys
    tol = TOL if dt == "bf16" else 1e-5
    for ref_out in (_np(want), oracle):
        diff = np.abs(_np(got) - ref_out)
        assert (diff <= tol * np.abs(ref_out).max(-1, keepdims=True)
                + 1e-30).all(), diff.max()
    assert not torch.isnan(got).any() and not torch.isnan(got_lse).any()
    assert (_np(got[0]) == 0).all() and torch.isneginf(got_lse[0]).all()
    np.testing.assert_allclose(got_lse[1:].numpy(), want_lse[1:].numpy(),
                               rtol=1e-5, atol=1e-5)
    for drop in (0, 1, 2):
        bad, bad_lse = decode_attention_emulated(q, k, v, length,
                                                 softcap=softcap,
                                                 drop_piece=drop)
        hit = np.array(lengths) > drop * CHUNK
        over = (np.abs(_np(bad) - _np(want)) > tol * np.abs(_np(want)).max(
            -1, keepdims=True)).any((-2, -1)) | (np.abs(
                (bad_lse - want_lse).nan_to_num().numpy()) > 1e-3).any(-1)
        assert hit.any() and over[hit].all() and not over[~hit].any(), drop
