"""StableLM-2-1.6B [hf:stabilityai/stablelm-2-1_6b] — 24L d_model=2048 32H
(MHA, kv=32) d_ff=5632, vocab=100352."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="stablelm-1.6b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=5632,
    vocab_size=100352,
    pattern=(("attn", "dense"),),
    rope_theta=10_000.0,
    norm_type="layernorm",
    mlp_type="swiglu",
    dtype="bfloat16",
    source="hf:stabilityai/stablelm-2-1_6b",
))
