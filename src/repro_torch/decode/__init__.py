"""repro_torch.decode — paged-KV continuous-batching decode for the real
backend, as ``repro.decode`` lays it out:

  * ``paged_cache``  — physical KV blocks, the refcounted
    ``BlockAllocator``, the block-granular ``PrefixIndex`` and the pool ops
    (copy-on-write ``copy_blocks``; ``gather_blocks`` / ``scatter_blocks``,
    the two halves of a block shipment).
  * ``paged_model``  — chunked prefill into the pool and the K-step decode
    loop, through the paged attention kernels.
  * ``scheduler``    — ``PagedArmScheduler``: EDF joins with prefix hits,
    chunked prefill, decode, preemption; ``role=`` splits it into the
    prefill and decode workers of a disaggregated fleet.
  * ``cache_store``  — ``CacheStore``, the block-shipping pipe between a
    prefill and a decode worker, and its ``RequestBlockBuffer`` ledger.
"""
from repro_torch.decode.cache_store import (CacheStore, RequestBlockBuffer,
                                            Shipment)
from repro_torch.decode.paged_cache import (NULL_BLOCK, ROOT_HASH,
                                            BlockAllocator, PrefixIndex,
                                            chain_hashes, chunk_write_slots,
                                            copy_blocks, gather_blocks,
                                            int8_kv_capacity_ratio,
                                            pool_block_bytes, quantize_kv,
                                            quantize_pool, scatter_blocks,
                                            write_slots)
from repro_torch.decode.paged_model import (make_decode_fn,
                                            make_prefill_chunk_fn,
                                            paged_decode_logits,
                                            quantize_attn_params,
                                            supports_paged_decode)
from repro_torch.decode.scheduler import Lane, PagedArmScheduler

__all__ = [
    "NULL_BLOCK", "ROOT_HASH", "BlockAllocator", "CacheStore", "Lane",
    "PagedArmScheduler", "PrefixIndex", "RequestBlockBuffer", "Shipment",
    "chain_hashes", "chunk_write_slots",
    "copy_blocks", "gather_blocks", "int8_kv_capacity_ratio",
    "make_decode_fn", "make_prefill_chunk_fn", "paged_decode_logits",
    "pool_block_bytes", "quantize_attn_params", "quantize_kv",
    "quantize_pool", "scatter_blocks", "supports_paged_decode", "write_slots",
]
