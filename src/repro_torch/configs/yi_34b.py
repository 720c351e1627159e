"""Yi-34B [arXiv:2403.04652] — llama-arch GQA: 60L d_model=7168 56H (kv=8)
d_ff=20480, vocab=64000."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="yi-34b",
    family="dense",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    pattern=(("attn", "dense"),),
    rope_theta=5_000_000.0,
    norm_type="rmsnorm",
    mlp_type="swiglu",
    dtype="bfloat16",
    source="arXiv:2403.04652",
))
