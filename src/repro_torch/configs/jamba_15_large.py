"""Jamba-1.5-Large (398B total) [arXiv:2403.19887] — 72L d_model=8192 64H
(GQA kv=8) d_ff=24576, vocab=65536; hybrid Mamba+attention at 1:7 ratio
(one attention layer per 8-layer superblock), MoE 16 experts top-2 on every
other layer."""
from repro_torch.configs.base import ArchConfig, MoEConfig, register

# 8-layer superblock: attention at position 3 (1:7 attn:mamba), MoE on odd
# positions (every other layer), dense FFN on even.
_PATTERN = tuple(
    ("attn" if i == 3 else "mamba", "moe" if i % 2 == 1 else "dense")
    for i in range(8)
)

CONFIG = register(ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    pattern=_PATTERN,
    moe=MoEConfig(n_experts=16, top_k=2),
    rope_theta=10_000.0,
    norm_type="rmsnorm",
    mlp_type="swiglu",
    ssm_d_state=16,
    ssm_expand=2,
    dtype="bfloat16",
    source="arXiv:2403.19887",
))
