"""Whisper-base [arXiv:2212.04356] — enc-dec, 6+6L d_model=512 8H d_ff=2048,
vocab=51865 (padded to 51872 for 16-way sharding); mel-spectrogram + conv
frontend is a STUB per the assignment: input_specs provides precomputed frame
embeddings [B, 1500, 512]."""
from repro_torch.configs.base import ArchConfig, FrontendConfig, register

CONFIG = register(ArchConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,                 # decoder layers
    n_enc_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=51872,           # 51865 padded to a multiple of 16
    pattern=(("attn", "dense"),),
    frontend=FrontendConfig(kind="audio", n_tokens=1500, d_frontend=512),
    norm_type="layernorm",
    mlp_type="gelu",
    dtype="bfloat16",
    source="arXiv:2212.04356",
))
