"""Gemma-2-27B [arXiv:2408.00118] — 46L d_model=4608 32H (GQA kv=16)
d_ff=36864, vocab=256000; alternating local (window 4096) / global attention,
attn logit softcap 50, final softcap 30, post-sublayer norms, head_dim=128.

46 layers is not divisible by the (local, global) superblock of 2 — the
published model starts with a local layer and alternates; we model 46 = 23
superblocks of (local, global).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256000,
    pattern=(("attn_local", "dense"), ("attn", "dense")),
    sliding_window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    post_norms=True,
    embed_scale=True,
    tie_embeddings=True,
    rope_theta=10_000.0,
    norm_type="rmsnorm",
    mlp_type="swiglu",
    dtype="bfloat16",
    source="arXiv:2408.00118",
))
