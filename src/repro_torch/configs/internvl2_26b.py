"""InternVL2-26B [arXiv:2404.16821] — InternLM2-20B language backbone: 48L
d_model=6144 48H (GQA kv=8) d_ff=16384, vocab=92553 (padded 92560); InternViT
vision encoder is a STUB per the assignment: input_specs provides precomputed
patch embeddings (256 tokens post pixel-shuffle, d=3200) and a linear
projector maps them into the LM."""
from repro_torch.configs.base import ArchConfig, FrontendConfig, register

CONFIG = register(ArchConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=92560,           # 92553 padded to a multiple of 16
    pattern=(("attn", "dense"),),
    frontend=FrontendConfig(kind="vision", n_tokens=256, d_frontend=3200),
    rope_theta=1_000_000.0,
    norm_type="rmsnorm",
    mlp_type="swiglu",
    dtype="bfloat16",
    source="arXiv:2404.16821",
))
