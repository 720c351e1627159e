"""Qwen1.5-MoE-A2.7B [hf:Qwen/Qwen1.5-MoE-A2.7B] — 24L d_model=2048 16H
(GQA kv=16) moe_d_ff=1408, vocab=151936; 60 routed experts top-4 + shared
expert (4x1408=5632 hidden)."""
from repro_torch.configs.base import ArchConfig, MoEConfig, register

CONFIG = register(ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=151936,
    pattern=(("attn", "moe"),),
    moe=MoEConfig(n_experts=60, top_k=4, n_shared=4, d_ff=1408),
    rope_theta=1_000_000.0,
    norm_type="rmsnorm",
    mlp_type="swiglu",
    dtype="bfloat16",
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
))
