"""Port tests that need the card: the hand-written CUDA kernels (paged
attention at head dims 32, 64 and 128; the int8/int4 quant GEMM; the flash
attention forward; the kernel-op layer's decode attention, grouped GEMM and
scan; the grouped GEMM's ragged entry, and the MoE's compacted serving
product through it with no host sync) against their plain PyTorch
versions, the paged serving
path on CUDA against the same path on the CPU, with and without weight
quantization and MoE, and a training step (flash forward, chunked
backward) on CUDA against the CPU.  Every test is marked ``gpu`` and skips
without a CUDA device (a CUDA kernel has no CPU mode).  This file imports neither jax
nor the JAX package, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.decode.paged_cache import quantize_kv  # noqa: E402
from repro_torch.decode.paged_model import quantize_attn_params  # noqa: E402
from repro_torch.engine import (LAYER, SEMANTIC, FixedPolicy,  # noqa: E402
                                PlacementEngine, Request, TorchBackend)
from repro_torch.kernels import (_gemm_launch, _paged_launch,  # noqa: E402
                                 _quant_launch)
from repro_torch.kernels.flash_attention import FLASH_TOL  # noqa: E402
from repro_torch.kernels.paged_decode_attention import (  # noqa: E402
    paged_decode_attention, paged_decode_attention_plain)
from repro_torch.kernels.paged_prefill_attention import (  # noqa: E402
    paged_prefill_attention, paged_prefill_attention_plain)
from repro_torch.kernels.quant_matmul import (  # noqa: E402
    quant_matmul, quant_matmul_plain, quantize_blockwise)

pytestmark = pytest.mark.gpu

# f32: summation order; bf16: one bf16 rounding of outputs ~1; int8 with
# f32 queries: the same dequantized products in another order.  Each held
# as tol times the largest |plain| of the output row: attention outputs are
# softmax averages, far below 1 over long rows
TOL = {"f32": 1e-4, "bf16": 2e-2, "int8": 1e-3}


def _row_limit(want, tol):
    """tol times the largest |plain| of each output (last-dim) row."""
    return tol * want.float().abs().amax(-1, keepdim=True)


def _within_rows(got, want, tol):
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= _row_limit(want, tol)).all()), float(diff.max())


def _kernels_per_call(fn, wrapper, kernel, reps=10, tries=5):
    """CUDA kernels one call of ``fn`` launches: the launches ``wrapper``
    counts (its ``launches``) over ``reps`` calls, per call, once the
    profiler shows that those calls ran no kernel whose name lacks
    ``kernel`` and no more records of it than launches.  Record counts are
    not the count: the tracer on the card loses records (all, part, or one
    of a profile); a profile with no kernel record is taken again."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        before = wrapper.launches
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        launches = wrapper.launches - before
        seen = {e.key: e.count for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.count > 0}
        if seen:
            others = [k for k in seen if kernel not in k]
            assert not others, f"kernels other than {kernel}: {others}"
            assert sum(seen.values()) <= launches, (seen, launches)
            assert launches % reps == 0, launches
            return launches // reps
    raise AssertionError(f"the profiler recorded no kernel in {tries} "
                         "profiles")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _case(dev, kind, *, g, b=4, h=8, kh=4, hd=64, bs=16, nb=6, c=40):
    """Pools with a branch dim, tables aliasing the first two blocks, a
    length-0 pad row with a null table, and chunk positions that run past
    the table for the last lane."""
    gen = torch.Generator(device=dev).manual_seed(5)
    qdt = torch.bfloat16 if kind == "bf16" else torch.float32
    p_blocks = 1 + b * nb
    kf = torch.randn(g, p_blocks, bs, kh, hd, generator=gen, device=dev)
    vf = torch.randn(g, p_blocks, bs, kh, hd, generator=gen, device=dev)
    rng = np.random.default_rng(5)
    tables = rng.permutation(np.arange(1, p_blocks)).reshape(b, nb)
    tables[1:, :2] = tables[1, :2]
    tables[0] = 0
    lengths = np.asarray([0] + list(rng.integers(1, nb * bs + 1, b - 1)))
    starts = np.minimum(rng.integers(0, nb * bs, b), nb * bs - 8)
    case = dict(
        tables=torch.tensor(tables, dtype=torch.int32, device=dev),
        lengths=torch.tensor(lengths, dtype=torch.int32, device=dev),
        positions=torch.tensor(starts[:, None] + np.arange(c),
                               dtype=torch.int32, device=dev),
        q=torch.randn(g, b, h, hd, generator=gen, device=dev).to(qdt),
        qc=torch.randn(g, b, c, h, hd, generator=gen, device=dev).to(qdt))
    if kind == "int8":
        (k, ks), (v, vs) = quantize_kv(kf), quantize_kv(vf)
        case.update(k=k, v=v, kw=dict(k_scale=ks, v_scale=vs))
    else:
        case.update(k=kf.to(qdt), v=vf.to(qdt), kw={})
    return case


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("g", [1, 2], ids=["one", "branches"])
@pytest.mark.parametrize("hd", [32, 64, 128])
def test_kernels_match_plain(dev, kind, g, hd):
    cs = _case(dev, kind, g=g, hd=hd)
    sq = (lambda t: t[0]) if g == 1 else (lambda t: t)
    kw = {k: sq(v) for k, v in cs["kw"].items()}
    args = (sq(cs["k"]), sq(cs["v"]), cs["tables"])
    before = (paged_decode_attention.launches,
              paged_prefill_attention.launches)
    paths = dict(_paged_launch.PATH_LAUNCHES)
    for kern, plain, q, pos in (
            (paged_decode_attention, paged_decode_attention_plain,
             sq(cs["q"]), cs["lengths"]),
            (paged_prefill_attention, paged_prefill_attention_plain,
             sq(cs["qc"]), cs["positions"])):
        got = kern(q, *args, pos, **kw)
        want = plain(q, *args, pos, **kw)
        torch.cuda.synchronize()
        assert got.shape == q.shape and got.dtype == q.dtype
        _within_rows(got, want, TOL[kind])
    assert (paged_decode_attention.launches,
            paged_prefill_attention.launches) == (before[0] + 1,
                                                  before[1] + 1)
    prefill = "prefill_mma" if kind == "bf16" else "prefill_simt"
    paths["decode_split"] += 1
    paths[prefill] += 1
    assert _paged_launch.PATH_LAUNCHES == paths
    # the pad row (length 0) is exactly zero
    out = paged_decode_attention(sq(cs["q"]), *args, cs["lengths"], **kw)
    assert bool((out[..., 0, :, :] == 0).all())


def _prefill_edge_case(dev, kind, *, hd, c, g=2, b=4, h=32, kh=8, bs=16,
                       nb=24):
    """GQA 4 over two branches with bf16 q: lane 0 a length-0 row (null
    table, positions from 0), lanes 1-3 alias lane 1's first four blocks,
    lane 1's rows pass 256 keys, lane 3's chunk runs past the table."""
    gen = torch.Generator(device=dev).manual_seed(hd + c)
    p_blocks = 1 + b * nb
    kf = torch.randn(g, p_blocks, bs, kh, hd, generator=gen, device=dev)
    vf = torch.randn(g, p_blocks, bs, kh, hd, generator=gen, device=dev)
    rng = np.random.default_rng(hd + c)
    tables = rng.permutation(np.arange(1, p_blocks)).reshape(b, nb)
    tables[2:, :4] = tables[1, :4]
    tables[0] = 0
    starts = np.asarray([0, 300, 100, nb * bs - c // 2])
    case = dict(
        tables=torch.tensor(tables, dtype=torch.int32, device=dev),
        positions=torch.tensor(starts[:, None] + np.arange(c),
                               dtype=torch.int32, device=dev),
        q=torch.randn(g, b, c, h, hd, generator=gen,
                      device=dev).to(torch.bfloat16))
    if kind == "int8":
        (k, ks), (v, vs) = quantize_kv(kf), quantize_kv(vf)
        case.update(k=k, v=v, kw=dict(k_scale=ks, v_scale=vs))
    else:
        case.update(k=kf.to(torch.bfloat16), v=vf.to(torch.bfloat16), kw={})
    return case


@pytest.mark.parametrize("kind", ["bf16", "int8"])
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("c", [1, 33, 64, 128])
def test_prefill_tensor_core_path_edges(dev, kind, hd, c):
    """The bf16-q prefill takes the tensor-core kernel and matches its
    plain version within 2e-2 of each output row's max |plain|; the same
    check rejects, in every query row with more than 256 keys, the plain
    output with the row's first 64-token K/V tile left out."""
    cs = _prefill_edge_case(dev, kind, hd=hd, c=c)
    args = (cs["q"], cs["k"], cs["v"], cs["tables"], cs["positions"])
    before = dict(_paged_launch.PATH_LAUNCHES)
    got = paged_prefill_attention(*args, **cs["kw"])
    want = paged_prefill_attention_plain(*args, **cs["kw"])
    torch.cuda.synchronize()
    before["prefill_mma"] += 1
    assert _paged_launch.PATH_LAUNCHES == before
    assert got.shape == cs["q"].shape and got.dtype == torch.bfloat16
    _within_rows(got, want, TOL["bf16"])
    nb, bs = cs["tables"].shape[1], cs["k"].shape[2]
    keys = (cs["positions"] + 1).clamp(max=nb * bs)            # [B, C]
    long = keys > 256
    if bool(long.any()):
        drop = 64 // bs
        bad = paged_prefill_attention_plain(
            cs["q"], cs["k"], cs["v"], cs["tables"][:, drop:].contiguous(),
            cs["positions"] - 64, **cs["kw"])
        over = ((bad.float() - want.float()).abs()
                > _row_limit(want, TOL["bf16"])).any(-1).any(-1)  # [G, B, C]
        assert bool(over[:, long].all())


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("heads", [(32, 32), (8, 2)], ids=["mha", "gqa4"])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_decode_split_edges(dev, kind, hd, heads, softcap):
    """Every decode step takes decode_split, one CUDA kernel per call, over
    two branches: lengths 0 (null table), 1, bs, a piece boundary - 1, at
    and + 1, the full table, blocks aliased across lanes; within tol of
    each output row's max |plain|, the pad lane exactly 0, and the check
    rejects the plain output with each long lane's first 64-token tile
    left out."""
    h, kh = heads
    b, bs, nb, g = 8, 16, 40, 2
    qdt = torch.bfloat16 if kind == "bf16" else torch.float32
    item = {"f32": 4, "bf16": 2, "int8": 1}[kind]
    _, _, _, piece = _paged_launch.decode_plan(
        h=h, kh=kh, hd=hd, kv_item=item, b=b, g=g, nb=nb, bs=bs,
        n_sm=torch.cuda.get_device_properties(dev).multi_processor_count)
    gen = torch.Generator(device=dev).manual_seed(hd + h)
    p_blocks = 1 + b * nb
    kf = torch.randn(g, p_blocks, bs, kh, hd, generator=gen, device=dev)
    vf = torch.randn(g, p_blocks, bs, kh, hd, generator=gen, device=dev)
    rng = np.random.default_rng(hd)
    tables = rng.permutation(np.arange(1, p_blocks)).reshape(b, nb)
    tables[2:, :3] = tables[1, :3]
    tables[0] = 0
    lengths = [0, 1, bs, piece - 1, piece, piece + 1, nb * bs, 300]
    tables = torch.tensor(tables, dtype=torch.int32, device=dev)
    lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
    q = torch.randn(g, b, h, hd, generator=gen, device=dev).to(qdt)
    if kind == "int8":
        (k, ks), (v, vs) = quantize_kv(kf), quantize_kv(vf)
        kw = dict(k_scale=ks, v_scale=vs)
    else:
        k, v, kw = kf.to(qdt), vf.to(qdt), {}
    kw["softcap"] = softcap
    paths = dict(_paged_launch.PATH_LAUNCHES)
    got = paged_decode_attention(q, k, v, tables, lengths, **kw)
    want = paged_decode_attention_plain(q, k, v, tables, lengths, **kw)
    torch.cuda.synchronize()
    paths["decode_split"] += 1
    assert _paged_launch.PATH_LAUNCHES == paths
    assert got.shape == q.shape and got.dtype == qdt
    _within_rows(got, want, TOL[kind])
    assert bool((got[:, 0] == 0).all())
    assert _kernels_per_call(
        lambda: paged_decode_attention(q, k, v, tables, lengths, **kw),
        paged_decode_attention, "paged_decode_split_kernel") == 1
    long = lengths > 256
    bad = paged_decode_attention_plain(q, k, v, tables[:, 64 // bs:]
                                       .contiguous(), lengths - 64, **kw)
    over = ((bad.float() - want.float()).abs()
            > _row_limit(want, TOL[kind])).any(-1).any(-1)     # [G, B]
    assert bool(over[:, long].all())


def test_kernel_rejects_what_it_cannot_take(dev):
    cs = _case(dev, "f32", g=1)
    with pytest.raises(ValueError, match="pool dtype"):
        paged_decode_attention(cs["q"][0], cs["k"][0].half(),
                               cs["v"][0].half(), cs["tables"],
                               cs["lengths"])
    with pytest.raises(ValueError, match="int32"):
        paged_decode_attention(cs["q"][0], cs["k"][0], cs["v"][0],
                               cs["tables"].long(), cs["lengths"])


# f32 x: the JAX kernel test's 2e-4 (another summation order); bf16 x: one
# bf16 rounding of outputs of order 1, held as |a - b| <= 2e-2 (1 + |b|)
QTOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("g", [1, 2], ids=["one", "branches"])
@pytest.mark.parametrize("t,d,e", [(1, 256, 96), (8, 2048, 2048),
                                   (8, 1152, 2048), (200, 1024, 1024),
                                   (37, 64, 40)])
def test_quant_matmul_matches_plain(dev, xdt, bits, g, t, d, e):
    gen = torch.Generator(device=dev).manual_seed(t + d)
    w = torch.randn(g, d, e, generator=gen, device=dev) / d ** 0.5
    q, s = quantize_blockwise(w, bits=bits)
    x = torch.randn(g, t, d, generator=gen, device=dev).to(xdt)
    before = quant_matmul.launches
    sq = (lambda a: a[0]) if g == 1 else (lambda a: a)
    paths = dict(_quant_launch.PATH_LAUNCHES)
    got = quant_matmul(sq(x), sq(q), sq(s))
    want = quant_matmul_plain(sq(x), sq(q), sq(s))
    torch.cuda.synchronize()
    assert quant_matmul.launches == before + 1
    paths[_quant_launch.path_for(xdt, t, d, e, d // s.shape[1], bits)] += 1
    assert _quant_launch.PATH_LAUNCHES == paths
    assert got.shape == want.shape and got.dtype == xdt
    torch.testing.assert_close(got.float(), want.float(), atol=QTOL[xdt],
                               rtol=QTOL[xdt])


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("group", [32, 128])
@pytest.mark.parametrize("g", [1, 2], ids=["one", "branches"])
@pytest.mark.parametrize("t", [1, 8, 17, 32, 33, 200])
def test_quant_matmul_tensor_core_edges(dev, bits, group, g, t):
    """bf16 x takes the tensor-core paths (T <= 32: mma_skinny, its groups
    split over a cluster; above: mma_tile), one CUDA kernel per call, at E
    = 208 (not a multiple of the 128-column tile) and ragged T, within
    2e-2 (1 + |plain|); the same check rejects the plain output with the
    last group of each split left out, in every output row."""
    d, e = 512, 208
    gen = torch.Generator(device=dev).manual_seed(t + group + bits)
    w = torch.randn(g, d, e, generator=gen, device=dev) / d ** 0.5
    q, s = quantize_blockwise(w, bits=bits, group=group)
    x = torch.randn(g, t, d, generator=gen, device=dev).bfloat16()
    path = "mma_skinny" if t <= 32 else "mma_tile"
    assert _quant_launch.path_for(x.dtype, t, d, e, group, bits) == path
    paths = dict(_quant_launch.PATH_LAUNCHES)
    got = quant_matmul(x, q, s)
    want = quant_matmul_plain(x, q, s)
    torch.cuda.synchronize()
    paths[path] += 1
    assert _quant_launch.PATH_LAUNCHES == paths
    limit = QTOL[torch.bfloat16] * (1 + want.float().abs())
    assert bool(((got.float() - want.float()).abs() <= limit).all())
    assert _kernels_per_call(lambda: quant_matmul(x, q, s), quant_matmul,
                             "qmm_mma_kernel") == 1
    n_g = d // group
    _, splits, per = _quant_launch.mma_plan(
        g, t, e, n_g, torch.cuda.get_device_properties(dev)
        .multi_processor_count)
    xd = x.clone()
    for i in range(splits):
        gi = min(n_g, (i + 1) * per) - 1
        xd[..., gi * group:(gi + 1) * group] = 0
    bad = quant_matmul_plain(xd, q, s)
    assert bool(((bad.float() - want.float()).abs() > limit).any(-1).all())


def test_quant_matmul_rejects_what_it_cannot_take(dev):
    q, s = quantize_blockwise(torch.randn(64, 32, device=dev), bits=8)
    with pytest.raises(ValueError, match="f32/bf16"):
        quant_matmul(torch.randn(4, 64, device=dev).half(), q, s)
    with pytest.raises(ValueError, match="line up"):
        quant_matmul(torch.randn(4, 64, device=dev), q, s[:, :16])


def _small(name):
    if name == "qwen2-moe-a2.7b":
        return get_config(name).reduced()
    return get_config("stablelm-1.6b").reduced().replace(
        d_model=128, n_heads=4, n_kv_heads=2, head_dim=32, d_ff=256,
        vocab_size=256)


@pytest.mark.parametrize("name,kv,wq", [
    ("stablelm-1.6b", "f32", None), ("stablelm-1.6b", "int8", None),
    ("qwen2-moe-a2.7b", "f32", "int8"), ("qwen2-moe-a2.7b", "int8", "int4")],
    ids=["f32", "int8", "moe-wq8", "moe-wq4-int8"])
@pytest.mark.parametrize("arm", [LAYER, SEMANTIC], ids=["layer", "semantic"])
def test_backend_on_cuda_matches_cpu(dev, arm, name, kv, wq):
    """The same f32 weights serve the same tokens through the kernels on
    the card and through the plain versions on the CPU."""
    cfg = _small(name)
    outs = []
    for device in ("cpu", dev):
        tb = TorchBackend(cfg, cache_len=64, max_batch=4, block_size=8,
                          scan_tokens=4, prefill_chunk=16, kv_dtype=kv,
                          weight_quant=wq, arms=(arm,), device=device)
        if outs:
            with torch.no_grad():
                for p, q in zip(tb.models[arm].parameters(),
                                cpu_model.parameters()):
                    p.copy_(q)
            if wq is not None:
                # the scheduler quantized its private copy at construction,
                # from the weights just overwritten: quantize it again
                sched = tb._paged[arm]
                sched.params, sched.quant_telemetry = quantize_attn_params(
                    tb.models[arm].grouped_views(), int(wq[3:]))
        cpu_model = tb.models[arm]
        rng = np.random.default_rng(3)
        head = rng.integers(0, cfg.vocab_size, 19)
        reqs = [Request(rid=i, app_id=0, sla_s=5.0, max_new=6 + i,
                        tokens=np.concatenate([head, rng.integers(
                            0, cfg.vocab_size, 3 + 2 * i)]).astype(np.int32))
                for i in range(5)]
        eng = PlacementEngine(FixedPolicy(arm, placement=None), tb)
        eng.submit(reqs[:2])
        eng.drain()
        eng.submit(reqs[2:])
        eng.drain()
        outs.append([r.output for r in reqs])
        assert eng.summary()["prefix_hit_rate"] > 0
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------- flash attention
FLASH_CASES = [
    # (n, sq, sk, h, kh, hd, causal, window, softcap)
    (2, 256, 256, 4, 4, 32, True, 0, 0.0),
    (2, 256, 256, 8, 2, 64, True, 0, 0.0),          # GQA 4:1
    (1, 128, 384, 4, 1, 128, True, 0, 0.0),         # MQA, Sq < Sk
    (2, 300, 300, 4, 2, 64, True, 100, 30.0),       # window + softcap
    (1, 200, 333, 4, 2, 128, False, 0, 0.0),        # non-causal, ragged
    (3, 77, 77, 2, 2, 32, True, 16, 0.0),           # ragged, tiny window
    # long walks over both branches (interior tiles unmasked)
    (1, 1024, 1024, 4, 2, 64, True, 0, 0.0),
    (1, 1000, 1500, 4, 4, 128, True, 0, 0.0),
    (1, 1024, 1024, 2, 1, 64, True, 300, 0.0),
]


@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_flash_attention_matches_plain(dev, kind, case):
    """The kernel against ``flash_attention_plain`` on the same CUDA
    tensors, within ``FLASH_TOL`` of each output row's max |plain|, with
    strided (non-contiguous) q, k and v; bf16 on the tensor-core path, f32
    on the CUDA-core path, one CUDA kernel per call.  On the long cases the
    check must also reject the plain output with each row's first 64 keys
    left out, in every row at position >= 256."""
    from repro_torch.kernels import _flash_launch
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    n, sq, sk, h, kh, hd, causal, window, softcap = case
    dt = torch.bfloat16 if kind == "bf16" else torch.float32
    gen = torch.Generator(device=dev).manual_seed(11)
    # q, k, v as slices of one projection output, as a fused qkv would be
    qkv = torch.randn(n, sk, h + 2 * kh, hd, generator=gen,
                      device=dev).to(dt)
    q, k, v = qkv[:, sk - sq:, :h], qkv[:, :, h:h + kh], qkv[:, :, h + kh:]
    before = flash_attention.launches
    paths = dict(_flash_launch.PATH_LAUNCHES)
    opts = dict(causal=causal, window=window, softcap=softcap)
    got = flash_attention(q, k, v, **opts)
    want = flash_attention_plain(q, k, v, **opts)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    paths["mma" if kind == "bf16" else "simt"] += 1
    assert _flash_launch.PATH_LAUNCHES == paths
    assert got.shape == q.shape and got.dtype == dt
    _within_rows(got, want, FLASH_TOL[dt])
    assert _kernels_per_call(lambda: flash_attention(q, k, v, **opts),
                             flash_attention, "flash_attention_kernel") == 1
    if sq >= 1000 and not window:
        bad = flash_attention_plain(q, k[:, 64:], v[:, 64:], **opts)
        long = torch.arange(sq, device=dev) + sk - sq >= 256
        over = ((bad.float() - want.float()).abs()
                > _row_limit(want, FLASH_TOL[dt])).any(-1)      # [N, Sq, H]
        assert bool(over[:, long].all())


def test_flash_attention_branches_share_a_launch(dev):
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    gen = torch.Generator(device=dev).manual_seed(12)
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn(2, 3, 130, 4, 64, generator=gen,
                               device=dev).to(dt) for _ in range(3))
        before = flash_attention.launches
        got = flash_attention(q, k, v, window=50)
        assert flash_attention.launches == before + 1
        want = torch.stack([flash_attention_plain(q[i], k[i], v[i],
                                                  window=50)
                            for i in range(2)])
        _within_rows(got, want, FLASH_TOL[dt])


def test_flash_attention_rejects_what_it_cannot_take(dev):
    from repro_torch.kernels.flash_attention import flash_attention
    q = torch.randn(1, 64, 2, 64, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(torch.randn(1, 64, 2, 48, device=dev),
                        *(torch.randn(1, 64, 2, 48, device=dev),) * 2)
    with pytest.raises(ValueError, match="Sq <= Sk"):
        flash_attention(q, q[:, :32], q[:, :32])
    with pytest.raises(ValueError, match="dtype"):
        flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="dense"):
        flash_attention(q, q, torch.randn(1, 64, 2, 128, device=dev)[..., ::2])


def test_attention_backward_through_kernel_matches_plain(dev):
    """``models.attention.attention`` on the card (kernel forward, chunked
    recompute backward) against plain autograd through
    ``flash_attention_plain``: outputs and q/k/v grads to 1e-4 (f32)."""
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.models.attention import attention
    gen = torch.Generator(device=dev).manual_seed(13)
    mk = lambda *s: torch.randn(*s, generator=gen, device=dev)
    q0, k0, v0 = mk(2, 2048, 4, 64), mk(2, 2048, 2, 64), mk(2, 2048, 2, 64)
    w = mk(2, 2048, 4, 64)
    grads = []
    for fn in (attention, flash_attention_plain):
        q, k, v = (t.clone().requires_grad_() for t in (q0, k0, v0))
        out = fn(q, k, v, window=700, softcap=30.0)
        (out * w).sum().backward()
        grads.append([out.detach(), q.grad, k.grad, v.grad])
    for a, b in zip(*grads):
        assert float((a - b).abs().max()) <= 1e-4 * (1 + float(b.abs().max()))


@pytest.mark.parametrize("mode", ["fsdp", "semantic"])
def test_train_step_on_cuda_matches_cpu(dev, mode):
    """Reduced stablelm at S = 2048 (the flash path): one runner
    ``value_and_grad`` on the card and on the CPU from the same weights;
    loss to rel 1e-5, grads to 1e-4 of each leaf's largest; the kernel is
    launched twice per layer with remat (forward and recompute)."""
    from repro_torch import bridge
    from repro_torch.dist import api as A
    from repro_torch.kernels.flash_attention import flash_attention
    cfg = get_config("stablelm-1.6b").reduced().replace(dtype="float32")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (1, 2049)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    out = []
    for device in ("cpu", dev):
        r = A.build_runner(cfg, mode, device=device)
        tree = r.init(seed=0)
        if out:
            bridge.load_params(r.model, out[0][2])
        before = flash_attention.launches
        loss, grads = r.value_and_grad(
            tree, {k: torch.from_numpy(v).to(device) for k, v in
                   batch.items()}, remat=True)
        if device != "cpu":
            assert flash_attention.launches - before == 2 * cfg.n_layers
        out.append((float(loss), bridge.tree_to_numpy(grads),
                    bridge.tree_to_numpy(tree)))
    (l0, g0, _), (l1, g1, _) = out
    assert abs(l1 - l0) <= 1e-5 * abs(l0)

    def close(a, b):
        if isinstance(a, dict):
            for k in a:
                close(a[k], b[k])
            return
        assert np.abs(a - b).max() <= 1e-4 * (1 + np.abs(a).max())
    close(g0, g1)


# ------------------------------------------------------ the kernel-op layer
# |kernel - plain| <= tol (1 + |plain|): f32 another summation order, bf16
# one bf16 rounding of the outputs
OPS_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}


def _limit(want, dt, rows=False):
    """tol (1 + |plain|); with ``rows`` tol times the largest |plain| of
    each last-dim row.  Decode takes the second: its outputs are softmax
    averages over many slots, far below 1, where tol (1 + |plain|) would
    pass a kernel that drops a 256-slot piece."""
    mag = want.float().abs()
    return OPS_TOL[dt] * (mag.amax(-1, keepdim=True) if rows else 1 + mag)


def _within(got, want, dt, rows=False):
    assert got.shape == want.shape and got.dtype == want.dtype
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= _limit(want, dt, rows)).all()), float(diff.max())


GEMM_CASES = [
    # (G, M, K, N, x sliced from a wider buffer)
    (2, 8, 1024, 640, False),        # decode rows: K split in a cluster
    (4, 8, 384, 384, False),         # the mLSTM's q/k/v
    (2, 32, 4096, 640, False),       # 32 rows, 64-column tiles, long K
    (1, 1, 8192, 72, True),          # one row, strided x, long K
    (3, 5, 70, 33, False),           # ragged everywhere, odd N (scalar w)
    (2, 200, 96, 130, True),         # 128-row tiles, strided x
    (4, 171, 128, 72, False),        # MoE capacity: 64-row tiles
    (1, 40, 48, 256, True),          # 64-row tiles, split K
    (2, 130, 37, 64, False),         # ragged contraction
    (1, 1, 1, 1, False),
]


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", GEMM_CASES,
                         ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("op", ["block_diag_matmul", "moe_gmm"])
def test_grouped_matmul_matches_plain(dev, op, case, dt):
    import importlib
    mod = importlib.import_module(f"repro_torch.kernels.{op}")
    kern, plain = getattr(mod, op), getattr(mod, f"{op}_plain")
    g, m, k, n, strided = case
    gen = torch.Generator(device=dev).manual_seed(m + k)
    x = torch.randn(g, m, k + (8 if strided else 0), generator=gen,
                    device=dev).to(dt)[..., :k]
    w = (torch.randn(g, k, n, generator=gen, device=dev) / k ** 0.5).to(dt)
    path = _gemm_launch.path_for(x, w)
    before, paths = kern.launches, dict(_gemm_launch.PATH_LAUNCHES)
    got = kern(x, w)
    want = plain(x, w)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    paths[path] += 1
    assert _gemm_launch.PATH_LAUNCHES == paths
    _within(got, want, dt)
    if m <= _gemm_launch.SKINNY_M:
        # decode-sized: one kernel, the splits merged in its cluster
        assert path == ("mma_skinny" if dt == torch.bfloat16 and k % 8 == 0
                        and n % 8 == 0 else "skinny")
        assert _kernels_per_call(
            lambda: kern(x, w), kern,
            "gemm_skinny_mma_kernel" if path == "mma_skinny"
            else "gemm_skinny_fma_kernel") == 1


@pytest.mark.parametrize("m", [33, 64, 65, 171, 200, 2048])
@pytest.mark.parametrize("k", [64, 72, 200])
def test_grouped_matmul_tensor_core_path_edges(dev, m, k):
    """bf16 with M > 32 and aligned strides takes the wgmma tile: N = 200
    (not a multiple of the 128-column tile), ragged K, x strided for odd
    M, moe_gmm and block_diag_matmul in turn."""
    import importlib
    op = "moe_gmm" if m % 2 else "block_diag_matmul"
    mod = importlib.import_module(f"repro_torch.kernels.{op}")
    kern, plain = getattr(mod, op), getattr(mod, f"{op}_plain")
    gen = torch.Generator(device=dev).manual_seed(m + k)
    dt = torch.bfloat16
    x = torch.randn(2, m, k + 8 * (m % 2), generator=gen,
                    device=dev).to(dt)[..., :k]
    w = (torch.randn(2, k, 200, generator=gen, device=dev) / k ** 0.5).to(dt)
    assert _gemm_launch.path_for(x, w) == "wgmma"
    before = dict(_gemm_launch.PATH_LAUNCHES)
    got = kern(x, w)
    want = plain(x, w)
    torch.cuda.synchronize()
    before["wgmma"] += 1
    assert _gemm_launch.PATH_LAUNCHES == before
    _within(got, want, dt)


@pytest.mark.parametrize("case", [
    # (G, M, K, N, how x is cut, path)
    (2, 200, 70, 64, "dense", "tiled"),       # row stride 140 B
    (2, 171, 64, 96, "offset", "tiled"),      # pointer 2 B past alignment
    (3, 100, 64, 40, "f32", "tiled"),         # f32 stays on CUDA cores
    (2, 20, 64, 200, "dense", "mma_skinny"),  # decode rows
    (2, 20, 64, 200, "offset", "skinny"),     # decode rows, 2 B off
    (2, 20, 64, 200, "f32", "skinny"),        # decode rows in f32
    (1, 64, 2048, 128, "dense", "wgmma"),     # one tile: split K
])
def test_grouped_matmul_path_rule(dev, case):
    """Calls the tensor-core tile cannot take keep the CUDA-core paths
    (decided before the launch) and still match the plain version."""
    from repro_torch.kernels.block_diag_matmul import (
        block_diag_matmul, block_diag_matmul_plain)
    g, m, k, n, cut, path = case
    dt = torch.float32 if cut == "f32" else torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(m + k + n)
    x = torch.randn(g, m, k + 1, generator=gen, device=dev).to(dt)
    x = x[..., 1:] if cut == "offset" else x[..., :k].contiguous()
    w = (torch.randn(g, k, n, generator=gen, device=dev) / k ** 0.5).to(dt)
    assert _gemm_launch.path_for(x, w) == path
    before = dict(_gemm_launch.PATH_LAUNCHES)
    got = block_diag_matmul(x, w)
    want = block_diag_matmul_plain(x, w)
    torch.cuda.synchronize()
    before[path] += 1
    assert _gemm_launch.PATH_LAUNCHES == before
    _within(got, want, dt)


RAGGED_CASES = [
    # (R, segment rows by group, K, N): the rows past the segments are the
    # dropped assignments, written as zeros
    (32, [0] * 50 + [2, 3, 0, 9, 1] + [0] * 5, 2048, 1408),  # LAYER decode
    (64, [1] * 60 + [4], 1024, 704),                   # SEMANTIC decode
    (40, [0, 1, 20, 0, 12, 0], 72, 136),    # empty, one-row, long segments
    (64, [64], 96, 200),                    # one group, 8 passes
    (300, [0, 1, 150, 0, 100], 72, 136),
    (4096, [68] * 60, 256, 192),            # a prefill chunk's R
    (1000, [0, 900, 0, 1], 200, 64),        # one segment of many tiles
    (129, [0, 0, 0], 64, 64),               # every assignment dropped
]


def _ragged_kernel_name(path, dt):
    if path == "ragged_decode":
        return "gemm_ragged_skinny_kernel"
    return "gemm_wgmma_kernel" if dt == torch.bfloat16 \
        else "gemm_tiled_kernel"


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", RAGGED_CASES,
                         ids=lambda c: f"R{c[0]}-G{len(c[1])}-{c[2]}x{c[3]}")
def test_moe_gmm_ragged_matches_plain(dev, case, dt):
    """The ragged entry against its plain version: each segment's rows,
    the zero rows past offsets[-1] (the output's memory holds NaNs before
    the call), one launch on the path R picks, one CUDA kernel a call."""
    from repro_torch.kernels.moe_gmm import (moe_gmm_ragged,
                                             moe_gmm_ragged_plain)
    r, counts, k, n = case
    gen = torch.Generator(device=dev).manual_seed(r + k)
    x = torch.randn(r, k, generator=gen, device=dev).to(dt)
    w = (torch.randn(len(counts), k, n, generator=gen, device=dev)
         / k ** 0.5).to(dt)
    off = torch.tensor([0] + np.cumsum(counts).tolist(), dtype=torch.int32,
                       device=dev)
    path = _gemm_launch.ragged_path_for(x, w)
    before, paths = moe_gmm_ragged.launches, dict(_gemm_launch.PATH_LAUNCHES)
    torch.full((r, n), float("nan"), dtype=dt, device=dev)   # freed dirty
    got = moe_gmm_ragged(x, w, off)
    want = moe_gmm_ragged_plain(x, w, off)
    torch.cuda.synchronize()
    assert moe_gmm_ragged.launches == before + 1
    paths[path] += 1
    assert _gemm_launch.PATH_LAUNCHES == paths
    _within(got, want, dt)
    assert not bool(got[sum(counts):].any())
    assert _kernels_per_call(lambda: moe_gmm_ragged(x, w, off),
                             moe_gmm_ragged,
                             _ragged_kernel_name(path, dt)) == 1


def test_moe_gmm_ragged_rejects_what_it_cannot_take(dev):
    """bf16 rows not 16-byte aligned (the tensor-core tiles' copies), a
    dense last dim missing, offsets of the wrong type or length, tensors
    on two devices: each raises before any launch."""
    from repro_torch.kernels.moe_gmm import moe_gmm_ragged
    x = torch.randn(40, 64, device=dev)
    w = torch.randn(3, 64, 130, device=dev)
    off = torch.tensor([0, 10, 10, 30], dtype=torch.int32, device=dev)
    before = moe_gmm_ragged.launches
    with pytest.raises(ValueError, match="16-byte"):
        moe_gmm_ragged(x.bfloat16(), w.bfloat16(), off)
    with pytest.raises(ValueError, match="dense"):
        moe_gmm_ragged(x, w.transpose(1, 2).contiguous().transpose(1, 2),
                       off)
    with pytest.raises(ValueError, match="offsets"):
        moe_gmm_ragged(x, w, off.long())
    with pytest.raises(ValueError, match="offsets"):
        moe_gmm_ragged(x, w, off[:3])
    with pytest.raises(ValueError, match="tensors on"):
        moe_gmm_ragged(x, w, off.cpu())
    assert moe_gmm_ragged.launches == before


def test_compact_moe_apply_has_no_host_sync(dev):
    """The MoE serving path on the card (``no_grad``: the compacted
    dispatch and three ragged launches) under
    ``torch.cuda.set_sync_debug_mode("error")``, which raises on any host
    read of a device value, against the same call on the CPU (the plain
    product); G = 2 branches, a capacity that drops."""
    import dataclasses

    from repro_torch.kernels.moe_gmm import moe_gmm_ragged
    from repro_torch.models import moe as MOE
    cfg = get_config("qwen2-moe-a2.7b").reduced().replace(dtype="float32")
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=0.5))
    gen = torch.Generator().manual_seed(4)
    shapes = MOE.moe_shapes(cfg)

    def draw(tree):
        return {k: draw(v) if isinstance(v, dict) else torch.randn(
            (2,) + tuple(v), generator=gen) * 0.1 for k, v in tree.items()}
    params = draw(shapes)
    x = torch.randn(2, 24, cfg.d_model, generator=gen)
    with torch.no_grad():
        want, _ = MOE.moe_apply(params, x, cfg)
        on_dev = {k: ({j: t.to(dev) for j, t in v.items()}
                      if isinstance(v, dict) else v.to(dev))
                  for k, v in params.items()}
        xd = x.to(dev)
        torch.cuda.synchronize()
        before = moe_gmm_ragged.launches
        torch.cuda.set_sync_debug_mode("error")
        try:
            got, _ = MOE.moe_apply(on_dev, xd, cfg)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert moe_gmm_ragged.launches == before + 3
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-4,
                               rtol=1e-4)


DECODE_CASES = [
    # (B, H, K, L, hd, softcap, lengths): one split (L <= 256) and several
    (3, 4, 4, 96, 64, 0.0, (96, 0, 1)),
    (3, 8, 2, 600, 128, 50.0, (600, 0, 257)),     # GQA 4, three splits
    (2, 6, 2, 300, 32, 0.0, (1, 300)),            # GQA 3: head groups of 1
    (2, 16, 1, 513, 64, 30.0, (513, 256)),        # GQA 16: two groups of 8
    (2, 4, 2, 40, 128, 0.0, (0, 0)),
]


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", DECODE_CASES,
                         ids=lambda c: "-".join(map(str, c[:6])))
def test_decode_attention_matches_plain(dev, case, dt):
    """The kernel against its plain version on the same CUDA tensors, K and
    V read as strided halves of one fused [B, L, 2K, hd] cache; length-0
    rows exactly 0.  The same check rejects, in every lane longer than a
    piece, the plain output with the lane's first 256 slots dropped."""
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_plain)
    b, h, kh, L, hd, cap, lens = case
    gen = torch.Generator(device=dev).manual_seed(L + hd)
    q = torch.randn(b, h, hd, generator=gen, device=dev).to(dt)
    kv = torch.randn(b, L, 2 * kh, hd, generator=gen, device=dev).to(dt)
    k, v = kv[:, :, :kh], kv[:, :, kh:]
    length = torch.tensor(lens, dtype=torch.int32, device=dev)
    before = decode_attention.launches
    got = decode_attention(q, k, v, length, softcap=cap)
    want = decode_attention_plain(q, k, v, length, softcap=cap)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    _within(got, want, dt, rows=True)
    assert bool((got[length == 0] == 0).all())
    long = length > 256
    if bool(long.any()):
        bad = decode_attention_plain(q, k[:, 256:], v[:, 256:],
                                     (length - 256).clamp(min=0),
                                     softcap=cap)
        over = ((bad.float() - want.float()).abs()
                > _limit(want, dt, rows=True)).flatten(1).any(1)
        assert bool(over[long].all())


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", DECODE_CASES,
                         ids=lambda c: "-".join(map(str, c[:6])))
def test_decode_attention_lse_matches_plain(dev, case, dt):
    """The kernel's log-sum-exp entry (one piece and the merge pass) against
    the plain version's: the output as above, the f32 lse within 1e-3
    absolute (bf16 inputs: the plain scores round the same inputs in
    another order; lse is a log of a sum, so an absolute tolerance), and
    a length-0 row (an empty slab of a length-sharded cache) 0 and -inf,
    never NaN; one launch a call."""
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_plain)
    b, h, kh, L, hd, cap, lens = case
    gen = torch.Generator(device=dev).manual_seed(L + hd + 1)
    q = torch.randn(b, h, hd, generator=gen, device=dev).to(dt)
    k = torch.randn(b, L, kh, hd, generator=gen, device=dev).to(dt)
    v = torch.randn(b, L, kh, hd, generator=gen, device=dev).to(dt)
    length = torch.tensor([0] + list(lens[1:]), dtype=torch.int32,
                          device=dev)
    before = decode_attention.launches
    got, lse = decode_attention(q, k, v, length, softcap=cap,
                                return_lse=True)
    want, want_lse = decode_attention_plain(q, k, v, length, softcap=cap,
                                            return_lse=True)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (b, h)
    _within(got, want, dt, rows=True)
    assert not bool(torch.isnan(lse).any() or torch.isnan(got).any())
    assert bool((got[0] == 0).all() and torch.isneginf(lse[0]).all())
    live = length > 0
    assert bool(((lse[live] - want_lse[live]).abs() <= 1e-3).all())


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 37, 3, 5), (1, 100, 16, 8),
                                   (3, 1, 4, 4)])
def test_ssm_scan_matches_plain(dev, shape, dt):
    """Each step a rounded multiply then a rounded add, as the plain loop:
    the kernel equals it bit for bit."""
    from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_plain
    gen = torch.Generator(device=dev).manual_seed(shape[1])
    a = (0.7 + 0.299 * torch.rand(shape, generator=gen, device=dev)).to(dt)
    b = torch.randn(shape, generator=gen, device=dev).to(dt)
    before = ssm_scan.launches
    got = ssm_scan(a, b)
    want = ssm_scan_plain(a, b)
    torch.cuda.synchronize()
    assert ssm_scan.launches == before + 1
    assert got.dtype == dt and torch.equal(got, want)


def test_ops_launch_once_per_call(dev):
    """Every op of ``repro_torch.kernels.ops`` on CUDA tensors launches its
    kernel once; with ``use_kernels(False)`` none, and the oracle's
    result."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.block_diag_matmul import block_diag_matmul
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.moe_gmm import moe_gmm
    from repro_torch.kernels.ssm_scan import ssm_scan
    gen = torch.Generator(device=dev).manual_seed(21)
    r = lambda *s: torch.randn(*s, generator=gen, device=dev)
    qz, sz = quantize_blockwise(r(64, 32), bits=8)
    calls = [
        (flash_attention, ops.flash_attention, ref.flash_attention_ref,
         (r(1, 64, 2, 64), r(1, 64, 2, 64), r(1, 64, 2, 64))),
        (block_diag_matmul, ops.block_diag_matmul, ref.block_diag_matmul_ref,
         (r(2, 8, 64), r(2, 64, 32))),
        (moe_gmm, ops.moe_gmm, ref.moe_gmm_ref, (r(3, 20, 64), r(3, 64, 16))),
        (ssm_scan, ops.ssm_scan, ref.ssm_scan_ref,
         (r(1, 9, 4, 4).sigmoid(), r(1, 9, 4, 4))),
        (decode_attention, ops.decode_attention, ref.decode_attention_ref,
         (r(2, 4, 64), r(2, 32, 2, 64), r(2, 32, 2, 64),
          torch.tensor([32, 5], dtype=torch.int32, device=dev))),
        (quant_matmul, ops.quant_matmul, ref.quant_matmul_ref,
         (r(4, 64), qz, sz)),
    ]
    for wrapper, op, oracle, args in calls:
        before = wrapper.launches
        op(*args)
        assert wrapper.launches == before + 1, op.__name__
        ops.use_kernels(False)
        try:
            off = op(*args)
        finally:
            ops.use_kernels(True)
        assert wrapper.launches == before + 1, op.__name__
        assert torch.equal(off, oracle(*args)), op.__name__


def test_op_kernels_reject_what_they_cannot_take(dev):
    from repro_torch.kernels.block_diag_matmul import block_diag_matmul
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.moe_gmm import moe_gmm
    from repro_torch.kernels.ssm_scan import ssm_scan
    x, w = torch.randn(2, 8, 16, device=dev), torch.randn(2, 16, 4, device=dev)
    with pytest.raises(ValueError, match="dtypes"):
        block_diag_matmul(x.half(), w.half())
    with pytest.raises(ValueError, match="dtypes"):
        moe_gmm(x, w.bfloat16())
    with pytest.raises(ValueError, match="tensors on"):
        moe_gmm(x, w.cpu())
    with pytest.raises(ValueError, match="dense"):
        block_diag_matmul(x, torch.randn(2, 16, 8, device=dev)[..., ::2])
    with pytest.raises(ValueError, match="G, M, K"):
        block_diag_matmul(x, torch.randn(2, 15, 4, device=dev))
    a = torch.rand(1, 8, 4, 4, device=dev)
    with pytest.raises(ValueError, match="dtypes"):
        ssm_scan(a, a.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        ssm_scan(a.transpose(2, 3), a.transpose(2, 3))
    with pytest.raises(ValueError, match="tensors on"):
        ssm_scan(a, a.cpu())
    q, kv = torch.randn(2, 4, 64, device=dev), \
        torch.randn(2, 16, 2, 64, device=dev)
    length = torch.tensor([3, 16], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        decode_attention(q[..., :48], kv[..., :48], kv[..., :48], length)
    with pytest.raises(ValueError, match="int32"):
        decode_attention(q, kv, kv, length.long())
    with pytest.raises(ValueError, match="tensors on"):
        decode_attention(q, kv, kv, length.cpu())
    with pytest.raises(ValueError, match="dtypes"):
        decode_attention(q, kv.bfloat16(), kv.bfloat16(), length)


# ------------------------------------------------------------ gang path
@pytest.mark.parametrize("name", ["stablelm-1.6b", "gemma2-27b"])
@pytest.mark.parametrize("arm", ["layer", "semantic"])
def test_dense_cache_decode_through_kernel(dev, name, arm):
    """The gang path's decode steps on CUDA: every attention layer's step
    launches ``decode_attention`` once (the semantic arm's branches folded
    into its batch), and the logits equal the same steps through
    ``decode_attention_plain`` (reduced f32 models; gemma2 past its 16-slot
    local ring, softcap 50)."""
    from repro_torch.kernels import decode_attention as DEC
    from repro_torch.models import layers as ML
    from repro_torch.models.model import build_model
    cfg = get_config(name).reduced()
    if arm == "semantic":
        cfg = cfg.semantic(2)
    model = build_model(cfg, device=dev).reset_parameters(
        torch.Generator(device=dev).manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (3, 24), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))

    def run():
        cache = model.init_cache(3, 32)
        out = []
        for i in range(toks.shape[1]):
            lg, cache = model.decode_step(None, cache, toks[:, i:i + 1], i)
            out.append(lg)
        return torch.cat(out, 1)

    DEC.decode_attention.launches = 0
    got = run()
    assert DEC.decode_attention.launches == cfg.n_layers * toks.shape[1]
    saved = ML.decode_attention
    ML.decode_attention = DEC.decode_attention_plain
    try:
        want = run()
    finally:
        ML.decode_attention = saved
    _within_rows(got, want, TOL["f32"])


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("t", [8, 128])
def test_mlstm_projection_through_kernel(dev, dt, t):
    """The mLSTM's per-head projection at xlstm-125m's widths (4 heads of
    384; the semantic arm's 2 x 2) through ``block_diag_matmul`` and its
    gradient kernels, against the plain einsum: the forward and both
    gradients within tol (1 + |plain|) on the path the rows take: at T 8
    the forward and dx = dy @ w^T on the decode-sized tile, dw (384 rows)
    on the tensor-core or tiled one."""
    from repro_torch.kernels.block_diag_matmul import block_diag_matmul
    from repro_torch.models.xlstm import BlockDiagMatmul
    tol = 2e-4 if dt == torch.float32 else 2e-2
    gen = torch.Generator(device=dev).manual_seed(2)
    x0 = torch.randn(4, t, 384, device=dev, generator=gen).to(dt)
    w0 = (torch.randn(4, 384, 384, device=dev, generator=gen)
          / 384 ** 0.5).to(dt)
    dy = torch.randn(4, t, 384, device=dev, generator=gen).to(dt)
    x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
    before = block_diag_matmul.launches
    paths = dict(_gemm_launch.PATH_LAUNCHES)
    out = BlockDiagMatmul.apply(x, w)
    out.backward(dy)
    assert block_diag_matmul.launches == before + 3
    bf16 = dt == torch.bfloat16
    rows_path = ("mma_skinny" if bf16 else "skinny") if t <= 32 else (
        "wgmma" if bf16 else "tiled")
    paths[rows_path] += 2
    paths["wgmma" if bf16 else "tiled"] += 1
    assert _gemm_launch.PATH_LAUNCHES == paths
    xr, wr = x0.float().requires_grad_(), w0.float().requires_grad_()
    ref = torch.einsum("gtd,gde->gte", xr, wr)
    ref.backward(dy.float())
    for got, want in ((out, ref), (x.grad, xr.grad), (w.grad, wr.grad)):
        diff = (got.float() - want).abs()
        assert bool((diff <= tol * (1 + want.abs())).all()), \
            float(diff.max())
