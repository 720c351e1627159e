"""The port's dry run (``repro_torch.launch.dryrun``: one rank of a mesh
traced on the meta device in a fake world) against the JAX package's
input shapes and specs, and against counts made by hand.

- ``INPUT_SHAPES`` and ``input_specs`` equal the reference's (keys, shapes,
  dtypes) on all ten configs and four shapes, and with ``batch_override``;
- the bytes a rank holds (parameters, AdamW moments, its rows of the
  batch, its cache) equal the reference's specs applied to its
  ``jax.eval_shape`` trees, for every config's default mode on one pod and
  two, with no trace;
- a traced train step of the tiny config on 1 x 1 counts exactly the flops
  of its GEMMs, its flash forwards' unmasked pairs and remat's recompute;
- each kernel's meta branch returns its plain version's shapes and dtypes
  and counts one predicted launch on the card's path, the real counters
  untouched; the ragged MoE product's adds its worst-case work, counted
  by hand;
- a full-width production run (stablelm-1.6b ``decode_32k``, one pod)
  completes; the fake world refuses to start inside a running one and
  leaves none behind.

The collectives a traced step records are held to a real gloo world in
``tests/test_torch_multi.py``.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from repro.configs.base import ASSIGNED  # noqa: E402
from repro.configs.base import get_config as jget  # noqa: E402
from repro.dist import api as japi  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim.adamw import adamw_init as jadamw_init  # noqa: E402
from repro_torch.configs.base import get_config as tget  # noqa: E402
from repro_torch.dist import api as tapi  # noqa: E402
from repro_torch.kernels import _flash_launch, _gemm_launch, cost  # noqa: E402
from repro_torch.kernels.block_diag_matmul import (  # noqa: E402
    block_diag_matmul, block_diag_matmul_plain)
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention, decode_attention_plain)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_plain)
from repro_torch.kernels.moe_gmm import moe_gmm_ragged  # noqa: E402
from repro_torch.launch import dryrun as TDR  # noqa: E402
from repro_torch.launch.mesh import fake_mesh, make_production_mesh  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402


class FakeMesh:
    """What the reference's recipes read of a mesh: ``shape``."""

    def __init__(self, shape):
        self.shape = dict(shape)


def _meta_shape(t):
    return tuple(t.shape), str(t.dtype).replace("torch.", "")


# ---------------------------------------------------------------- inputs
@pytest.mark.parametrize("name", ASSIGNED)
def test_input_specs_match_jax(name):
    """Keys, shapes and dtypes of every shape's inputs (meta tensors on the
    port's side), at the global batch and at a batch override."""
    assert {k: dataclasses.astuple(v) for k, v in TM.INPUT_SHAPES.items()} \
        == {k: dataclasses.astuple(v) for k, v in JM.INPUT_SHAPES.items()}
    jcfg, tcfg = jget(name), tget(name)
    for shape in JM.INPUT_SHAPES:
        for override in (None, 3):
            want = JM.input_specs(jcfg, JM.INPUT_SHAPES[shape],
                                  batch_override=override)
            got = TM.input_specs(tcfg, TM.INPUT_SHAPES[shape],
                                 batch_override=override)
            assert all(t.device.type == "meta" for t in got.values())
            assert {k: _meta_shape(v) for k, v in got.items()} == \
                {k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}


# ------------------------------------------------------------ bytes a rank
def _spec_bytes(tree, specs, sizes) -> int:
    """The reference's spec arithmetic: each leaf's bytes over the sizes
    of the axes its spec splits."""
    leaves = jax.tree.leaves(tree)
    spec_leaves = jax.tree.leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    total = 0
    for leaf, spec in zip(leaves, spec_leaves):
        n = int(np.prod(leaf.shape)) * np.dtype(leaf.dtype).itemsize
        for e in spec:
            for ax in (e if isinstance(e, tuple) else (e,)):
                n //= sizes.get(ax, 1) if ax else 1
        total += n
    return total


@functools.lru_cache(maxsize=None)
def _jax_rank_bytes(name, multi_pod):
    """The reference's bytes a rank, by part and shape, built as its dry
    run builds them before lowering (``repro.launch.dryrun.run_dryrun``; its
    mode, window and moment dtype rules are the port's copies: importing
    that module would force 512 host devices on this process's JAX)."""
    cfg = jget(name)
    sizes = make_production_mesh(multi_pod=multi_pod).shape
    mesh = FakeMesh(sizes)
    mode = TDR.default_mode(name)
    kw = {}
    if mode == "pipeline" and cfg.moe is not None \
            and cfg.moe.n_experts % 16 == 0:
        kw["expert_parallel"] = True
    runner = japi.build_runner(cfg, mode, mesh, **kw)
    params = jax.eval_shape(lambda: runner.model.init(jax.random.PRNGKey(0)))
    p_specs = runner.param_specs(params)
    opt = jax.eval_shape(lambda: jadamw_init(params, TDR.opt_dtype_for(cfg)))
    o_specs = japi.make_opt_specs(p_specs)
    if multi_pod and cfg.param_count() > 100e9:
        o_specs = japi.pod_shard_opt_specs(o_specs, params, mesh)
    out = {"param_bytes": _spec_bytes(params, p_specs, sizes),
           "opt_bytes": _spec_bytes((opt.m, opt.v), (o_specs.m, o_specs.v),
                                    sizes)}
    for shape in JM.INPUT_SHAPES:
        if (name, shape) == ("whisper-base", "long_500k"):
            continue
        s = JM.INPUT_SHAPES[shape]
        batch = JM.input_specs(runner.cfg, s)
        out[shape, "batch_bytes"] = _spec_bytes(
            batch, japi.batch_specs(runner.cfg, mesh, batch), sizes)
        if s.kind == "decode":
            wo = TDR.window_for(cfg, shape)
            cache = jax.eval_shape(
                lambda: runner.init_cache(s.global_batch, s.seq_len, wo))
            out[shape, "cache_bytes"] = _spec_bytes(
                cache, runner.cache_specs(cache), sizes)
    return out


@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod1", "pod2"])
@pytest.mark.parametrize("name", ASSIGNED)
def test_rank_bytes_match_reference_specs(name, multi_pod):
    """Parameters, AdamW moments (bf16 and split over 'pod' too past 100 B
    parameters on two pods), each shape's rows of the batch and the decode
    shapes' caches: the bytes rank 0 holds equal the reference's specs
    applied to its eval_shape trees (the port's step counter is a Python
    int, not a leaf)."""
    want = _jax_rank_bytes(name, multi_pod)
    dims = make_production_mesh(multi_pod=multi_pod).dims
    cfg = tget(name)
    mode = TDR.default_mode(name)
    kw = {}
    if mode == "pipeline" and cfg.moe is not None \
            and cfg.moe.n_experts % 16 == 0:
        kw["expert_parallel"] = True
    pod_opt = multi_pod and cfg.param_count() > 100e9
    with fake_mesh(dims) as mesh:
        runner = tapi.build_runner(cfg, mode, mesh, device="meta", **kw)
        for shape in TM.INPUT_SHAPES:
            if (name, shape) == ("whisper-base", "long_500k"):
                continue
            s = TM.INPUT_SHAPES[shape]
            got = TDR.rank_arguments(
                runner, s, window=TDR.window_for(cfg, shape),
                opt_dtype=TDR.opt_dtype_for(cfg), pod_opt=pod_opt)["parts"]
            assert got["param_bytes"] == want["param_bytes"], shape
            assert got["batch_bytes"] == want[shape, "batch_bytes"], shape
            if s.kind == "train":
                assert got["opt_bytes"] == want["opt_bytes"]
            if s.kind == "decode":
                assert got["cache_bytes"] == want[shape, "cache_bytes"], \
                    shape
    assert not dist.is_initialized()


# ------------------------------------------------------------ traced flops
def _tiny():
    return tget("stablelm-1.6b").reduced().replace(
        d_model=64, n_heads=2, n_kv_heads=2, head_dim=32, d_ff=128,
        vocab_size=128)


def test_train_step_flops_match_analytic_count():
    """A remat train step of the tiny config at B 1 x S 2048 on 1 x 1 (the
    flash path): its flops are the GEMMs' (the block projections forward,
    recomputed and backward, the chunked attention backward's recompute
    and vjp over every 1024 x 1024 block, the head's forward and
    backward) plus the flash forwards' 4 hd flops per unmasked pair, run
    once forward and once recomputed.  The recompute stops at the last
    tensor the backward reads (``checkpoint``'s early stop), so each
    superblock's MLP down-projection is not rerun."""
    cfg = _tiny().replace(dtype="float32")
    b, s = 1, 2048
    d, h, kv, hd, ff, v = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                           cfg.d_ff, cfg.vocab_size)
    n_layers, tokens = cfg.n_layers, b * s
    proj = 2 * d * h * hd + 2 * 2 * d * kv * hd + 2 * h * hd * d \
        + 3 * 2 * d * ff                               # q, k, v, o; swiglu
    blocks = tokens * n_layers * proj
    chunked = 4 * b * h * s * s * hd                   # QK^T and PV, all
    head = 2 * tokens * d * v
    pairs = s * (s + 1) // 2
    flash = 4 * hd * pairs * h * b
    with fake_mesh((1, 1)) as mesh:
        runner = tapi.build_runner(cfg, "fsdp", mesh, device="meta")
        rec = TDR.dryrun_rank(runner, TM.InputShape("t", s, b, "train"),
                              remat=True)
    recompute = blocks - n_layers * 2 * tokens * ff * d
    assert rec["aten_flops"] == 3 * blocks + recompute \
        + n_layers * 3 * chunked + 3 * head
    assert rec["kernel_flops"] == 2 * n_layers * flash
    assert rec["flops"] == rec["aten_flops"] + rec["kernel_flops"]
    assert rec["kernels"]["flash_attention"] == {
        "launches": 2 * n_layers, "paths": {"simt": 2 * n_layers}}
    # parameters and f32 moments, the batch's tokens and labels
    n_params = sum(t.numel() for t in TM.build_model(
        cfg, device="meta").parameters())
    assert rec["param_bytes"] == 4 * n_params
    assert rec["opt_bytes"] == 8 * n_params
    assert rec["batch_bytes"] == 2 * 4 * tokens
    assert rec["peak_bytes"] >= rec["argument_bytes"] + rec["temp_bytes"] \
        - rec["batch_bytes"] > rec["argument_bytes"]


# ------------------------------------------------------------ meta branches
def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("dtype,flash_path,gemm_path", [
    (torch.float32, "simt", "skinny"), (torch.bfloat16, "mma", "mma_skinny")])
def test_meta_branches_shape_and_count_like_the_card(dtype, flash_path,
                                                     gemm_path):
    """Each wrapper on meta tensors: its plain version's shapes and dtypes,
    one predicted launch in ``dry_launches`` and under the card's path in
    ``DRY_PATH_LAUNCHES``, its work in ``cost.DRYRUN``; the real counters
    do not move."""
    real = (flash_attention.launches, decode_attention.launches,
            block_diag_matmul.launches, dict(_flash_launch.PATH_LAUNCHES),
            dict(_gemm_launch.PATH_LAUNCHES))
    cost.reset_dryrun()
    cpu = lambda t: torch.zeros(t.shape, dtype=t.dtype)
    q, k = _meta(2, 256, 4, 32, dtype=dtype), _meta(2, 256, 2, 32, dtype=dtype)
    before = (flash_attention.dry_launches,
              dict(_flash_launch.DRY_PATH_LAUNCHES))
    got = flash_attention(q, k, k)
    want = flash_attention_plain(cpu(q), cpu(k), cpu(k))
    assert _meta_shape(got) == _meta_shape(want) and got.is_meta
    assert flash_attention.dry_launches == before[0] + 1
    assert _flash_launch.DRY_PATH_LAUNCHES[flash_path] == \
        before[1][flash_path] + 1
    flops = cost.flash_cost(2, 256, 256, 4, 2, 32, q.element_size(),
                            causal=True, window=0)[0]
    assert cost.DRYRUN["flops"] == flops

    qd, kd = _meta(3, 4, 64, dtype=dtype), _meta(3, 600, 2, 64, dtype=dtype)
    length = _meta(3, dtype=torch.int32)
    for lse in (False, True):
        n = decode_attention.dry_launches
        got = decode_attention(qd, kd, kd, length, return_lse=lse)
        want = decode_attention_plain(cpu(qd), cpu(kd), cpu(kd),
                                      torch.full((3,), 600), return_lse=lse)
        got, want = (got, want) if lse else ((got,), (want,))
        assert [_meta_shape(t) for t in got] == [_meta_shape(t) for t in want]
        assert decode_attention.dry_launches == n + 1

    x, w = _meta(4, 8, 96, dtype=dtype), _meta(4, 96, 96, dtype=dtype)
    before = (block_diag_matmul.dry_launches,
              dict(_gemm_launch.DRY_PATH_LAUNCHES))
    got = block_diag_matmul(x, w)
    assert _meta_shape(got) == _meta_shape(block_diag_matmul_plain(cpu(x),
                                                                   cpu(w)))
    assert block_diag_matmul.dry_launches == before[0] + 1
    assert _gemm_launch.DRY_PATH_LAUNCHES[gemm_path] == \
        before[1][gemm_path] + 1
    # the launchers' checks run: a head dim the kernel lacks raises
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(_meta(1, 8, 2, 48), _meta(1, 8, 2, 48),
                        _meta(1, 8, 2, 48))
    assert real == (flash_attention.launches, decode_attention.launches,
                    block_diag_matmul.launches,
                    dict(_flash_launch.PATH_LAUNCHES),
                    dict(_gemm_launch.PATH_LAUNCHES))


@pytest.mark.parametrize("dtype,r,path", [
    (torch.float32, 32, "ragged_decode"),
    (torch.bfloat16, 4096, "ragged_prefill"),
    (torch.bfloat16, 40, "ragged_decode")])
def test_ragged_meta_branch_counts_its_worst_case(dtype, r, path):
    """``moe_gmm_ragged`` on meta tensors: the [R, N] output, one predicted
    launch under its tiling, and the worst case of its work (the offsets
    are unknown on meta), by hand: 2 R K N flops; the weights of min(G, R)
    experts, x's R rows and the output's R rows."""
    g, k, n = 60, 2048, 1408
    x, w = _meta(r, k, dtype=dtype), _meta(g, k, n, dtype=dtype)
    off = _meta(g + 1, dtype=torch.int32)
    real = (moe_gmm_ragged.launches, dict(_gemm_launch.PATH_LAUNCHES))
    before = (moe_gmm_ragged.dry_launches,
              dict(_gemm_launch.DRY_PATH_LAUNCHES))
    cost.reset_dryrun()
    got = moe_gmm_ragged(x, w, off)
    assert got.is_meta and _meta_shape(got) == ((r, n), str(dtype)[6:])
    assert moe_gmm_ragged.dry_launches == before[0] + 1
    assert _gemm_launch.DRY_PATH_LAUNCHES[path] == before[1][path] + 1
    item = x.element_size()
    assert cost.DRYRUN["flops"] == 2 * r * k * n
    assert cost.DRYRUN["bytes"] == (min(g, r) * k * n + r * k + r * n) * item
    assert real == (moe_gmm_ragged.launches,
                    dict(_gemm_launch.PATH_LAUNCHES))
    with pytest.raises(ValueError, match="offsets"):
        moe_gmm_ragged(x, w, _meta(g, dtype=torch.int32))


# -------------------------------------------------------------- production
def test_production_decode_run_and_fake_world():
    """stablelm-1.6b ``decode_32k`` on one pod's (16, 16) mesh: a rank holds
    its 8 rows of the 32768-slot cache and gathers the weights on use; the
    fake world refuses to start inside a running one and is gone after."""
    rec = TDR.run_dryrun("stablelm-1.6b", "decode_32k", save=False,
                         verbose=False)
    cfg = tget("stablelm-1.6b")
    assert rec["n_devices"] == 256 and rec["ranks"].keys() == {"0"}
    assert rec["cache_bytes"] == 2 * cfg.n_layers * 8 * 32768 \
        * cfg.n_kv_heads * cfg.hd * 2
    assert rec["kernels"]["decode_attention"]["launches"] == cfg.n_layers
    assert rec["collectives"]["all_gather"]["calls"] > 0
    assert rec["peak_bytes"] > rec["argument_bytes"]
    assert not dist.is_initialized()
    with fake_mesh((2, 2), rank=3) as mesh:
        assert mesh.rank == 3 and mesh.coords == {"data": 1, "model": 1}
        with pytest.raises(RuntimeError, match="already running"):
            with fake_mesh((2, 2)):
                pass
        assert dist.is_initialized()
    assert not dist.is_initialized()
