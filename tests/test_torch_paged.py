"""Port paged cache and paged forwards against the JAX package.

Host logic (chain hashes, the refcounted allocator, the prefix index) must
be EXACTLY equal on the same op sequence; int8 codes and scales bit-equal
(``jnp.round`` and ``torch.round`` both round half to even); write slots
equal.  The paged forwards run the JAX model-level functions with
``interpret=False``, which on the CPU dispatch to the dense ``ref`` paths,
on bridged weights.  Tolerances on logits:

  * f32 KV 1e-4: the same float32 math with another summation order
    (matmul, einsum, softmax) over two layers;
  * int8 KV 1e-3: quantize-on-write rounds K/V to codes, so a last-ulp
    difference in a K/V value can move a code by one step (amax/127).

Token streams are compared exactly only after checking that the JAX run's
smallest top-2 logit margin clears that tolerance.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.decode import paged_cache as jpc  # noqa: E402
from repro.decode import paged_model as jpm  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.base import ArchConfig as TArchConfig  # noqa: E402
from repro_torch.decode import paged_cache as tpc  # noqa: E402
from repro_torch.decode import paged_model as tpm  # noqa: E402


def port_cfg(cfg):
    """The same architecture as a port config object."""
    return TArchConfig(**{f.name: getattr(cfg, f.name)
                          for f in dataclasses.fields(cfg)})


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------- host logic
@pytest.mark.parametrize("seed", range(3))
def test_chain_hashes_equal(seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 50_000, int(rng.integers(0, 70)))
    for bs in (1, 4, 16):
        assert tpc.chain_hashes(toks, bs) == jpc.chain_hashes(toks, bs)


@pytest.mark.parametrize("seed", range(4))
def test_allocator_and_index_equal_on_same_ops(seed):
    """One random sequence of alloc / share / free / insert / match /
    match_full on both packages' allocator + prefix index: every return
    value, eviction callback, delta message and counter is identical."""
    rng = np.random.default_rng(seed)
    bs = 4
    sides = []
    for mod in (jpc, tpc):
        log = []
        idx = mod.PrefixIndex(bs)
        idx.on_delta = lambda kind, h, log=log: log.append(("delta", kind, h))
        alloc = mod.BlockAllocator(
            14, bs, on_evict=lambda b, k, log=log, idx=idx: (
                log.append(("evict", b)), idx.drop(k)))
        sides.append((alloc, idx, log))
    heads = [rng.integers(0, 6, 12) for _ in range(3)]
    live = [[] for _ in sides]
    for step in range(120):
        op = rng.random()
        n = int(rng.integers(1, 5))
        seq = np.concatenate([heads[int(rng.integers(3))],
                              rng.integers(0, 6, int(rng.integers(0, 9)))])
        for (alloc, idx, log), handles in zip(sides, live):
            if op < 0.35:
                ids = alloc.alloc(n)
                log.append(("alloc", ids))
                if ids is not None:
                    handles.append((ids, seq[:len(ids) * bs]))
            elif op < 0.6 and handles:
                ids, toks = handles.pop(0)
                log.append(("insert", idx.insert(toks, ids, alloc)))
                alloc.free(ids[::-1])
            elif op < 0.8:
                full, tail = idx.match(seq)
                log.append(("match", full, tail, idx.match_full(seq)))
                if full:
                    alloc.share(full)
                    alloc.free(full)
            log.append(("state", alloc.free_blocks, alloc.evictable_blocks,
                        alloc.used_blocks, len(idx)))
    assert sides[0][2] == sides[1][2]


def test_quantize_kv_bit_equal():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 2, 32)).astype(np.float32)
    # ties: x / scale lands exactly on .5 for these entries
    x[0, 0, 0, :4] = [127.0, 0.5, 1.5, -2.5]
    x[1, 1, 1] = 0.0                       # an all-zero vector (scale 0)
    jq, js = jpc.quantize_kv(jnp.asarray(x))
    tq, ts = tpc.quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(ts.numpy().view(np.uint32),
                                  np.asarray(js).view(np.uint32))


def test_write_slots_equal():
    rng = np.random.default_rng(1)
    b, nb, bs, c = 5, 6, 4, 8
    tables = rng.integers(0, 30, (b, nb)).astype(np.int32)
    lengths = rng.integers(0, nb * bs, b).astype(np.int32)
    active = np.asarray([True, False, True, True, False])
    starts = rng.integers(0, nb * bs, b).astype(np.int32)
    n_tok = rng.integers(0, c + 1, b).astype(np.int32)
    j = jpc.write_slots(jnp.asarray(lengths), jnp.asarray(tables),
                        jnp.asarray(active), bs)
    t = tpc.write_slots(torch.from_numpy(lengths), torch.from_numpy(tables),
                        torch.from_numpy(active), bs)
    for a, e in zip(t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(e))
    j = jpc.chunk_write_slots(jnp.asarray(starts), jnp.asarray(n_tok),
                              jnp.asarray(tables), bs, c)
    t = tpc.chunk_write_slots(torch.from_numpy(starts),
                              torch.from_numpy(n_tok),
                              torch.from_numpy(tables), bs, c)
    for a, e in zip(t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(e))


@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_copy_blocks_and_pool_bytes_equal(tiny_cfg, kv):
    """COW block copies move the same bytes (int8 codes and scales ride
    along unrequantized) and both packages count the same block bytes."""
    rng = np.random.default_rng(2)
    jmodel = jbuild(tiny_cfg)
    jpool = jmodel.init_cache(6, 4)
    if kv == "int8":
        jpool = jpc.quantize_pool(jpool)
    jpool = jax.tree.map(
        lambda x: jnp.asarray(rng.integers(-100, 100, x.shape), x.dtype),
        jpool)
    tpool = bridge.pool_from_numpy(np_tree(jpool))
    src, dst = np.asarray([3, 1, 0, 0], np.int32), \
        np.asarray([2, 5, 0, 0], np.int32)
    jout = jpc.copy_blocks(jpool, jnp.asarray(src), jnp.asarray(dst))
    tout = tpc.copy_blocks(tpool, torch.from_numpy(src),
                           torch.from_numpy(dst))
    for pos, entry in jout.items():
        for name, leaf in entry.items():
            np.testing.assert_array_equal(tout[pos][name].numpy(),
                                          np.asarray(leaf), err_msg=name)
    assert tpc.pool_block_bytes(tout) == jpc.pool_block_bytes(jout)
    assert tpc.int8_kv_capacity_ratio(32) == jpc.int8_kv_capacity_ratio(32)


# ------------------------------------------------------------ paged forwards
def _clone(pool):
    return {k: {n: v.clone() for n, v in e.items()} for k, e in pool.items()}


def _setup(cfg, arm, kv, seed=3, num_blocks=17, bs=4):
    jcfg = cfg if arm == "layer" else cfg.semantic(2)
    jmodel = jbuild(jcfg)
    params = jmodel.init(jax.random.PRNGKey(seed))
    jpool = jmodel.init_cache(num_blocks, bs)
    tmodel = bridge.model_from_params(port_cfg(jcfg), np_tree(params))
    tpool = tmodel.init_pool(num_blocks, bs)
    if kv == "int8":
        jpool = jpc.quantize_pool(jpool)
        tpool = tpc.quantize_pool(tpool)
    return jmodel, params, jpool, tmodel, tpool


@pytest.mark.parametrize("kv", ["f32", "int8"])
@pytest.mark.parametrize("arm", ["layer", "semantic"])
def test_paged_forwards_match_jax(tiny_cfg, arm, kv):
    check_paged_forwards(tiny_cfg, arm, kv, 1e-4 if kv == "f32" else 1e-3)


def check_paged_forwards(tiny_cfg, arm, kv, tol):
    """Two prefill chunks (ragged lanes, an idle lane), then a K=4 decode
    loop with mixed budgets and a pad row: chunk logits and teacher-forced
    decode logits to ``tol``, then the decode loop's tokens, lengths and
    budgets exactly."""
    jmodel, params, jpool, tmodel, tpool = _setup(tiny_cfg, arm, kv)
    rng = np.random.default_rng(7)
    vocab = tiny_cfg.vocab_size
    tables = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 11, 12],
                         [0, 0, 0, 0]], np.int32)
    jchunk = jax.jit(jpm.make_prefill_chunk_fn(jmodel, interpret=False))
    jstep = jax.jit(lambda p, c, t, bt, ln, a: jpm.paged_decode_logits(
        jmodel, p, c, t, bt, ln, a, interpret=False))
    tchunk = tpm.make_prefill_chunk_fn(tmodel)
    lengths = np.zeros(4, np.int32)
    for n_tok in (np.asarray([8, 5, 3, 0], np.int32),
                  np.asarray([4, 6, 0, 0], np.int32)):
        toks = rng.integers(0, vocab, (4, 8)).astype(np.int32)
        jl, jpool = jchunk(params, jpool, jnp.asarray(toks),
                           jnp.asarray(lengths), jnp.asarray(n_tok),
                           jnp.asarray(tables))
        tl, tpool = tchunk(tpool, torch.from_numpy(toks),
                           torch.from_numpy(lengths), torch.from_numpy(n_tok),
                           torch.from_numpy(tables))
        live = n_tok > 0
        np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                                   atol=tol, rtol=tol)
        last = np.asarray(jl)
        lengths = lengths + n_tok

    # decode: lane 2 stopped prefilling early, lane 3 is a pad row
    tok0 = last.argmax(-1).astype(np.int32)[:, None]
    remaining = np.asarray([4, 2, 3, 0], np.int32)
    tpool_scan = _clone(tpool)
    jp, tok, lens, rem, margins = jpool, tok0, lengths, remaining, []
    tp = tpool
    for _ in range(4):
        active = rem > 0
        jl, jp = jstep(params, jp, jnp.asarray(tok), jnp.asarray(tables),
                       jnp.asarray(lens), jnp.asarray(active))
        tl, tp = tpm.paged_decode_logits(
            tmodel, tp, torch.from_numpy(tok), torch.from_numpy(tables),
            torch.from_numpy(lens), torch.from_numpy(active))
        jl = np.asarray(jl)
        np.testing.assert_allclose(tl.numpy()[active], jl[active], atol=tol,
                                   rtol=tol)
        top2 = np.sort(jl[active], axis=-1)[:, -2:]
        margins.extend(top2[:, 1] - top2[:, 0])
        nxt = jl.argmax(-1).astype(np.int32)
        tok = np.where(active, nxt, tok[:, 0])[:, None]
        lens = lens + active
        rem = rem - active
    assert min(margins) > tol, "near-tie: exact tokens would be unfair"

    jdec = jax.jit(jpm.make_decode_fn(jmodel, scan_tokens=4,
                                      interpret=False))
    tdec = tpm.make_decode_fn(tmodel, scan_tokens=4)
    _, jtok, jlen, jrem, jtoks = jdec(
        params, jpool, jnp.asarray(tok0), jnp.asarray(tables),
        jnp.asarray(lengths), jnp.asarray(remaining))
    _, ttok, tlen, trem, ttoks = tdec(
        tpool_scan, torch.from_numpy(tok0), torch.from_numpy(tables),
        torch.from_numpy(lengths), torch.from_numpy(remaining))
    for row, r in enumerate(remaining):
        np.testing.assert_array_equal(ttoks.numpy()[row, :r],
                                      np.asarray(jtoks)[row, :r])
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    np.testing.assert_array_equal(trem.numpy(), np.asarray(jrem))
    np.testing.assert_array_equal(ttok.numpy()[remaining > 0],
                                  np.asarray(jtok)[remaining > 0])
