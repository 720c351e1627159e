"""Paged KV-cache management: refcounted block allocator + prefix index,
and the torch ops on the paged pool.

The host logic (:class:`BlockAllocator`, :class:`PrefixIndex`,
:func:`chain_hashes`, :data:`NULL_BLOCK`) is a verbatim copy of
``repro.decode.paged_cache``: the same block ids, refcounts, LRU eviction
order and chain hashes (integer-tuple hashing is PYTHONHASHSEED-independent).

The pool is a dict ``{"pos<i>": {"k", "v"}}`` of tensors in the reference
layout ``[(Bb,) N_sb, P, bs, K, hd]``; an int8 pool adds ``"k_scale"`` /
``"v_scale"`` leaves ``[(Bb,) N_sb, P, bs, K]``.  Physical block 0 is the
null block: padded table entries and the writes of inactive lanes land there
and are never read.  Where the JAX package rebuilt the pool with
``.at[].set``, these ops update it in place (``index_put_``) and return it.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

#: reserved physical block id — scratch target for padded/inactive writes
NULL_BLOCK = 0

#: chain-hash of the empty prefix (the root parent of every chain)
ROOT_HASH = 0


def chain_hashes(tokens, block_size: int) -> List[int]:
    """Block-hash chain of a token sequence — the cache-status sync wire
    format.  ``h_j = hash((h_{j-1},) + chunk_j)`` over complete
    ``block_size`` chunks, rooted at :data:`ROOT_HASH`.  Integer-tuple
    hashing is PYTHONHASHSEED-independent, so producer (PrefixIndex delta
    stream) and consumer (the placement layer's replica index) agree without
    shipping raw tokens."""
    toks = [int(t) for t in tokens]
    out: List[int] = []
    h = ROOT_HASH
    for j in range(len(toks) // block_size):
        h = hash((h,) + tuple(toks[j * block_size:(j + 1) * block_size]))
        out.append(h)
    return out


class BlockAllocator:
    """Refcounted free-list allocator over the physical block pool of one arm.

    Pure host-side bookkeeping (device arrays never see the free list).
    Invariants, property-tested in tests/test_decode.py: a block is never
    handed out twice while live, every fully-dereferenced block becomes
    allocatable again, ``NULL_BLOCK`` is never handed out (nor freeable), and
    ``free + evictable + live == num_blocks - 1`` at every step.

    ``on_evict(block, key)`` fires when ``alloc`` reclaims an evictable
    block, so the prefix index can drop the stale mapping before the block's
    contents are overwritten.
    """

    def __init__(self, num_blocks: int, block_size: int,
                 on_evict: Optional[Callable[[int, object], None]] = None):
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is the null block)")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.on_evict = on_evict
        self._free: List[int] = list(range(num_blocks - 1, NULL_BLOCK, -1))
        self._ref: Dict[int, int] = {}            # live block -> refcount
        self._key: Dict[int, object] = {}         # block -> prefix-index key
        self._evictable: "OrderedDict[int, object]" = OrderedDict()

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def evictable_blocks(self) -> int:
        return len(self._evictable)

    @property
    def available_blocks(self) -> int:
        """Blocks an all-or-nothing ``alloc`` could hand out right now."""
        return len(self._free) + len(self._evictable)

    @property
    def used_blocks(self) -> int:
        return len(self._ref)

    def refcount(self, block: int) -> int:
        return self._ref.get(block, 0)

    def can_alloc(self, n: int) -> bool:
        return n <= self.available_blocks

    def alloc(self, n: int) -> Optional[List[int]]:
        """Pop n fresh blocks (refcount 1 each), or None with NO side effect
        (no partial pops, no evictions) if the pool cannot cover all n.
        Never-used blocks go first; under shortage the least-recently-parked
        evictable blocks are reclaimed, dropping their prefix-index entries
        via ``on_evict``."""
        if n > self.available_blocks:
            return None
        ids: List[int] = []
        for _ in range(n):
            if self._free:
                b = self._free.pop()
            else:
                b, key = self._evictable.popitem(last=False)   # LRU first
                del self._key[b]
                if self.on_evict is not None:
                    self.on_evict(b, key)
            self._ref[b] = 1
            ids.append(b)
        return ids

    def share(self, ids: Sequence[int]) -> None:
        """Take a reference on cached blocks (a prefix hit).  Live blocks
        gain a reference; evictable blocks resurrect (keeping their index
        key).  Sharing a free/unknown block is an error — its contents are
        not a cached prefix."""
        for b in ids:
            if b in self._ref:
                self._ref[b] += 1
            elif b in self._evictable:
                del self._evictable[b]
                self._ref[b] = 1
            else:
                raise ValueError(f"share of non-cached block {b}")

    def free(self, ids: Sequence[int]) -> None:
        """Drop one reference per id.  A block whose last reference drops
        parks on the evictable LRU if its content is registered in the
        prefix index, else returns to the free list.  Freeing the null
        block, a free block, or more references than were taken raises."""
        for b in ids:
            if b == NULL_BLOCK:
                raise ValueError("free of the reserved null block")
            if b not in self._ref:
                raise ValueError(f"double free / foreign block {b}")
            self._ref[b] -= 1
            if self._ref[b] == 0:
                del self._ref[b]
                if b in self._key:
                    self._evictable[b] = self._key[b]      # parked as MRU
                else:
                    self._free.append(b)

    def register(self, block: int, key: object) -> None:
        """Attach a prefix-index key to a LIVE block: when its last
        reference drops it becomes evictable cache instead of free."""
        if block not in self._ref:
            raise ValueError(f"register of non-live block {block}")
        self._key[block] = key

    def blocks_for(self, n_tokens: int) -> int:
        """Physical blocks needed to hold n_tokens cache slots."""
        return -(-n_tokens // self.block_size)


class PrefixIndex:
    """Block-granularity prefix cache over token-id chunks.

    A cached sequence is a chain of keys ``key_j = (key_{j-1}, chunk_j)``
    where ``chunk_j`` is the tuple of ``block_size`` token ids filling
    logical block j (root parent is ``None``).  ``match`` walks the chain
    greedily; ``insert`` registers a retired/preempted lane's full blocks.

    The exact nested-tuple keys double as hashes (no collision handling
    needed at this scale) and the child map per parent is what enables the
    *partial* tail match: a cached block whose first R < block_size tokens
    equal the prompt's remaining tail can be copy-on-write-mapped, saving R
    prefill tokens at the cost of one block copy.
    """

    def __init__(self, block_size: int):
        self.block_size = block_size
        # parent key -> {chunk tuple -> physical block}
        self._children: Dict[object, Dict[Tuple[int, ...], int]] = {}
        # exact key -> chain hash, mirrored for the cache-status delta
        # stream: ``on_delta("add"|"drop", chain_hash)`` fires on every
        # registration / reclaim so the placement layer can keep a global
        # block-hash -> replica index without ever snapshotting the index.
        self._hashes: Dict[object, int] = {}
        self.on_delta = None  # type: Optional[callable]

    def _chain_hash(self, key: object) -> int:
        """Chain hash of a nested-tuple key — a pure function of the key
        (``chain_hashes`` on the flattened tokens gives the same value), so
        it can be recomputed even after a parent entry was dropped."""
        if key is None:
            return ROOT_HASH
        h = self._hashes.get(key)
        if h is None:
            parent, chunk = key
            h = hash((self._chain_hash(parent),) + chunk)
            self._hashes[key] = h
        return h

    def __len__(self) -> int:
        return sum(len(c) for c in self._children.values())

    def match_full(self, tokens) -> List[int]:
        """Longest cached full-block chain covering a *committed* history.

        Unlike :meth:`match` this may cover **every** complete block — there
        is no leave-one-token rule, because the caller (the cache-store ship
        path) already holds the first generated token and needs no tail
        prefill.  A trailing partial block (``len(tokens) % block_size``
        tokens) is never matchable and stays the caller's to ship; when the
        history is an exact block multiple, the receiver's next write lands
        in a *fresh* block, so covering the whole history is write-safe.
        """
        bs = self.block_size
        toks = [int(t) for t in tokens]
        full: List[int] = []
        parent = None
        pos = 0
        while pos + bs <= len(toks):
            chunk = tuple(toks[pos:pos + bs])
            child = self._children.get(parent, {}).get(chunk)
            if child is None:
                break
            full.append(child)
            parent = (parent, chunk)
            pos += bs
        return full

    def match(self, tokens) -> Tuple[List[int], Optional[Tuple[int, int]]]:
        """Longest cached head of ``tokens``.

        Returns ``(full_blocks, tail)``: ``full_blocks`` are chain blocks
        whose whole content is a prompt prefix (share these); ``tail`` is
        ``(block, R)`` when a child block's first ``R`` tokens extend the
        match partially (copy-on-write this one), else None.  At least one
        token is always left uncovered so the tail prefill produces the
        last-position logits that seed decoding.
        """
        bs = self.block_size
        toks = [int(t) for t in tokens]
        full: List[int] = []
        parent = None
        pos = 0
        # full blocks: stop before covering the whole prompt (leave >= 1)
        while pos + bs < len(toks):
            chunk = tuple(toks[pos:pos + bs])
            child = self._children.get(parent, {}).get(chunk)
            if child is None:
                break
            key = (parent, chunk)
            full.append(child)
            parent = key
            pos += bs
        # partial tail: best common-prefix child of the last matched key
        rem = toks[pos:]
        cap = len(rem) - 1                       # leave >= 1 token uncovered
        best_r, best_b = 0, None
        for chunk, block in self._children.get(parent, {}).items():
            r = 0
            for a, b in zip(chunk, rem[:cap]):
                if a != b:
                    break
                r += 1
            if r > best_r:
                best_r, best_b = r, block
        # best_r < bs always: a child matching a full bs tokens of rem would
        # have been taken by the full-block loop above (same children dict)
        if best_r > 0:
            return full, (best_b, best_r)
        return full, None

    def insert(self, tokens, block_ids: Sequence[int],
               alloc: BlockAllocator) -> int:
        """Register the full blocks of a committed token history.  Chunks
        already present keep their existing block (the newcomer's duplicate
        frees normally — no key, so it returns to the free list).  Returns
        the number of newly registered blocks."""
        bs = self.block_size
        toks = [int(t) for t in tokens]
        parent = None
        added = 0
        for j in range(len(toks) // bs):
            chunk = tuple(toks[j * bs:(j + 1) * bs])
            key = (parent, chunk)
            kids = self._children.setdefault(parent, {})
            if chunk not in kids:
                kids[chunk] = block_ids[j]
                alloc.register(block_ids[j], key)
                added += 1
                if self.on_delta is not None:
                    self.on_delta("add", self._chain_hash(key))
            parent = key
        return added

    def drop(self, key: object) -> None:
        """Forget one mapping (its block is being reclaimed)."""
        parent, chunk = key
        kids = self._children.get(parent)
        if kids is not None and chunk in kids:
            del kids[chunk]
            if not kids:
                del self._children[parent]
            if self.on_delta is not None:
                self.on_delta("drop", self._chain_hash(key))
        self._hashes.pop(key, None)


def quantize_kv(x: torch.Tensor):
    """Symmetric per-token int8 quantization of K/V vectors [..., hd]: one
    f32 scale per (token, kv head), the amax over the head dim.  Returns
    ``(codes int8 [..., hd], scales f32 [...])``; dequant is
    ``codes * scales[..., None]``.  Rounds half to even, as ``jnp.round``
    does, so codes and scales equal the JAX package's bit for bit."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = amax / 127.0
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(xf / safe[..., None]), -127, 127)
    return q.to(torch.int8), scale


def quantize_pool(pool: Dict) -> Dict:
    """Convert a freshly initialized float pool to the int8 layout: every
    ``{"k", "v"}`` entry becomes ``{"k" int8, "k_scale" f32 [..., P, bs, K],
    "v", "v_scale"}``.  A token slot shrinks from ``itemsize*hd`` to
    ``hd + 4`` bytes per kv head."""
    out = {}
    for name, node in pool.items():
        if set(node) == {"k", "v"}:
            out[name] = {
                "k": torch.zeros(node["k"].shape, dtype=torch.int8,
                                 device=node["k"].device),
                "k_scale": torch.zeros(node["k"].shape[:-1],
                                       dtype=torch.float32,
                                       device=node["k"].device),
                "v": torch.zeros(node["v"].shape, dtype=torch.int8,
                                 device=node["v"].device),
                "v_scale": torch.zeros(node["v"].shape[:-1],
                                       dtype=torch.float32,
                                       device=node["v"].device),
            }
        else:
            out[name] = quantize_pool(node)
    return out


def int8_kv_capacity_ratio(head_dim: int, scale_bytes: int = 4) -> float:
    """Effective-capacity multiplier of the int8 KV layout over f32: an f32
    token slot is ``4*hd`` bytes per kv head, an int8 slot ``hd`` code bytes
    plus one f32 scale — ``4*hd / (hd + 4)``."""
    return (4.0 * head_dim) / (head_dim + scale_bytes)


def _leaves(pool: Dict, prefix=()):
    for k, v in pool.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def meta_like(pool: Dict) -> Dict:
    """The pool's leaves, shapes and dtypes, on the meta device."""
    return {k: meta_like(v) if isinstance(v, dict) else
            torch.empty(v.shape, dtype=v.dtype, device="meta")
            for k, v in pool.items()}


def pool_block_bytes(pool: Dict) -> int:
    """Pool bytes per physical block, summed over every layer and leaf.
    Scale leaves ([..., P, bs, K]) have their physical axis at -3, KV leaves
    at -4."""
    total = 0
    for path, leaf in _leaves(pool):
        p = leaf.shape[-3] if path[-1].endswith("_scale") else leaf.shape[-4]
        total += (leaf.numel() // p) * leaf.element_size()
    return total


def _at(path, ids: torch.Tensor):
    """Index of physical blocks ``ids`` in the leaf at ``path``: scale
    leaves ([..., P, bs, K]) have their physical axis at -3, KV leaves at
    -4."""
    tail = 2 if path[-1].endswith("_scale") else 3
    return (Ellipsis, ids) + (slice(None),) * tail


def copy_blocks(pool: Dict, src: torch.Tensor, dst: torch.Tensor) -> Dict:
    """Copy physical blocks ``dst[i] := src[i]`` in every pool leaf, in
    place — the copy-on-write resolve for a partially matched block.
    Padded pairs point both ids at the null block.  int8 codes copy
    bit-exactly and their scale leaves ride along (no requantization)."""
    src, dst = src.long(), dst.long()
    for path, leaf in _leaves(pool):
        leaf[_at(path, dst)] = leaf[_at(path, src)]
    return pool


def gather_blocks(pool: Dict, ids: torch.Tensor) -> Dict:
    """The payload of physical blocks ``ids`` [n] from every pool leaf — the
    wire format of a cache-store shipment: a dict with the pool's structure
    whose leaves have the physical axis replaced by ``n``.  int8 code
    leaves and their ``_scale`` leaves are extracted verbatim, so a shipped
    quantized block is never requantized in flight."""
    ids = ids.long()
    out: Dict = {}
    for path, leaf in _leaves(pool):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf[_at(path, ids)]
    return out


def scatter_blocks(pool: Dict, payload: Dict, ids: torch.Tensor) -> Dict:
    """Write a :func:`gather_blocks` payload into physical blocks ``ids`` of
    ``pool``, in place — the receiver half of a shipment.  Padded entries
    point at the null block (whose contents are garbage by design), so one
    unconditional scatter serves any pow2-bucketed wave width."""
    ids = ids.long()
    for path, leaf in _leaves(pool):
        src = payload
        for k in path:
            src = src[k]
        leaf[_at(path, ids)] = src
    return pool


def write_slots(lengths: torch.Tensor, block_tables: torch.Tensor,
                active: torch.Tensor, block_size: int):
    """(physical block, in-block offset) [B] int32 for each lane's next
    token write.  Inactive lanes route to the null block, so a step issues
    one unconditional scatter; distinct active lanes own distinct write
    blocks (shared prefix blocks are never write targets)."""
    b = lengths.shape[0]
    logical = (lengths // block_size).clamp(0, block_tables.shape[1] - 1)
    wb = block_tables[torch.arange(b, device=lengths.device), logical.long()]
    wo = lengths % block_size
    wb = torch.where(active, wb, torch.full_like(wb, NULL_BLOCK))
    wo = torch.where(active, wo, torch.zeros_like(wo))
    return wb.int(), wo.int()


def chunk_write_slots(starts: torch.Tensor, n_tok: torch.Tensor,
                      block_tables: torch.Tensor, block_size: int,
                      chunk: int):
    """Per-token write slots [B, chunk] int32 for one prefill chunk:
    ``starts`` [B] first absolute position, ``n_tok`` [B] valid tokens;
    padded token slots and idle lanes route to the null block."""
    ar = torch.arange(chunk, device=starts.device)
    pos = starts[:, None] + ar[None, :]
    valid = ar[None, :] < n_tok[:, None]
    logical = (pos // block_size).clamp(0, block_tables.shape[1] - 1)
    wb = torch.gather(block_tables, 1, logical.long())
    wb = torch.where(valid, wb, torch.full_like(wb, NULL_BLOCK))
    wo = torch.where(valid, pos % block_size, torch.zeros_like(pos))
    return wb.int(), wo.int()
