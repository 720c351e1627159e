"""StarCoder2-15B [arXiv:2402.19173] — 40L d_model=6144 48H (GQA kv=4)
d_ff=24576, vocab=49152; RoPE, layernorm, gelu MLP."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    d_ff=24576,
    vocab_size=49152,
    pattern=(("attn", "dense"),),
    rope_theta=100_000.0,
    norm_type="layernorm",
    mlp_type="gelu",
    dtype="bfloat16",
    source="arXiv:2402.19173",
))
