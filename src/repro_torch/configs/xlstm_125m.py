"""xLSTM-125M [arXiv:2405.04517] — 12L d_model=768, 4 heads, sLSTM + mLSTM
blocks (no separate FFN for mLSTM blocks; sLSTM blocks carry a 4/3-d FFN).
Superblock of 6: one sLSTM at position 2, mLSTM elsewhere (≈1:5 ratio)."""
from repro_torch.configs.base import ArchConfig, register

_PATTERN = tuple(
    ("slstm" if i == 2 else "mlstm", "none") for i in range(6)
)

CONFIG = register(ArchConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    pattern=_PATTERN,
    norm_type="layernorm",
    mlp_type="gelu",
    ssm_expand=2,
    dtype="bfloat16",
    source="arXiv:2405.04517",
))
