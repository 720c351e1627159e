"""Architecture config system.

Every assigned architecture gets one ``ArchConfig`` in ``src/repro_torch/configs/<id>.py``
with the exact published dimensions (source cited in the file).  A config fully
determines the model: the repeating "superblock" pattern (list of
(mixer, ffn) kinds), attention geometry, MoE geometry, and modality frontend.

Three derived views exist per config:
  - ``reduced()``     — smoke-test variant (<=2 superblocks, d_model<=512, <=4 experts)
  - ``semantic(B)``   — the paper's semantic-split variant: B independent
                        block-diagonal branches (SplitNet-style), each of width
                        d_model/B, with the vocab partitioned across branches.
  - the config itself — the full model, used only via AOT dry-run.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

# (mixer, ffn) kinds composing one block.
MIXERS = ("attn", "attn_local", "mamba", "mlstm", "slstm")
FFNS = ("dense", "moe", "none")


def _ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    n_shared: int = 0          # shared (always-on) experts
    d_ff: int = 0              # per-expert hidden dim (0 -> use arch d_ff)
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class FrontendConfig:
    """Stubbed modality frontend (audio frames / vision patches).

    Per the assignment, the conv/mel codec and the ViT are NOT implemented;
    ``input_specs`` provides precomputed embeddings of shape
    [batch, n_tokens, d_frontend] and a linear projector maps them to d_model.
    """
    kind: str                  # 'audio' | 'vision'
    n_tokens: int              # frames / patches fed to the backbone
    d_frontend: int            # embedding dim coming out of the stub


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                      # 0 -> d_model // n_heads
    # Superblock: repeating pattern of (mixer, ffn) pairs; len divides n_layers.
    pattern: Tuple[Tuple[str, str], ...] = (("attn", "dense"),)
    moe: Optional[MoEConfig] = None
    frontend: Optional[FrontendConfig] = None
    # encoder-decoder (whisper): n_layers counts DECODER layers; encoder gets
    # n_enc_layers of plain self-attention blocks.
    n_enc_layers: int = 0
    # attention details
    rope_theta: float = 10_000.0
    sliding_window: int = 0                # window for 'attn_local' mixers
    attn_softcap: float = 0.0              # gemma2 attn logit soft-capping
    final_softcap: float = 0.0             # gemma2 final logit soft-capping
    causal: bool = True
    # norms / mlp
    norm_type: str = "rmsnorm"             # rmsnorm | layernorm
    mlp_type: str = "swiglu"               # swiglu | gelu
    norm_eps: float = 1e-5
    post_norms: bool = False               # gemma2 post-sublayer norms
    embed_scale: bool = False              # gemma2 sqrt(d) embedding scaling
    tie_embeddings: bool = False
    # ssm
    ssm_d_state: int = 16
    ssm_d_conv: int = 4
    ssm_expand: int = 2
    # expert parallelism: mesh axis experts are sharded over ('' = off);
    # set by the pipeline runner, consumed by models.moe
    expert_parallel_axis: str = ""
    # semantic-split bookkeeping (set on derived variants)
    n_branches: int = 1
    dtype: str = "float32"
    source: str = ""                       # citation

    # ---------------------------------------------------------------- helpers
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def n_superblocks(self) -> int:
        assert self.n_layers % len(self.pattern) == 0, (
            f"{self.name}: n_layers={self.n_layers} not divisible by "
            f"pattern len {len(self.pattern)}")
        return self.n_layers // len(self.pattern)

    @property
    def is_encdec(self) -> bool:
        return self.n_enc_layers > 0

    @property
    def has_decode(self) -> bool:
        return True  # all assigned archs are (or contain) decoders

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------ param count
    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS in the roofline)."""
        d, ff, hd = self.d_model, self.d_ff, self.hd
        qkv = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
        out = self.n_heads * hd * d
        attn = qkv + out
        if self.mlp_type == "swiglu":
            dense_ffn = 3 * d * ff
        else:
            dense_ffn = 2 * d * ff
        d_in = self.ssm_expand * d
        mamba = (d * 2 * d_in                       # in_proj
                 + d_in * self.ssm_d_conv           # conv
                 + d_in * (2 * self.ssm_d_state + 1) + d_in  # ssm params (B,C,dt)
                 + d_in * d)                        # out_proj
        hd_in = d_in // max(self.n_heads, 1)
        mlstm = (d * 2 * d_in + d_in * self.ssm_d_conv
                 + 3 * d_in * hd_in + d_in * d)     # up, conv, blockdiag qkv, out
        slstm = 4 * d * d + 2 * int(4 / 3 * d) * d  # 4 gates + FFN(4/3 d)
        total = 0
        for mixer, ffn in self.pattern:
            if mixer in ("attn", "attn_local"):
                total += attn
            elif mixer == "mamba":
                total += mamba
            elif mixer == "mlstm":
                total += mlstm
            elif mixer == "slstm":
                total += slstm
            if ffn == "dense":
                total += dense_ffn
            elif ffn == "moe":
                m = self.moe
                eff = m.d_ff or ff
                total += d * m.n_experts + m.n_experts * 3 * d * eff
                if m.n_shared:
                    total += 3 * d * (m.n_shared * eff)
        total *= self.n_superblocks
        if self.is_encdec:
            # encoder blocks: self-attn + dense ffn; decoder adds cross-attn
            total += self.n_enc_layers * (attn + dense_ffn)
            total += self.n_layers * attn  # cross-attention in every dec layer
        total += self.vocab_size * d  # embedding
        if not self.tie_embeddings:
            total += self.vocab_size * d
        if self.frontend is not None:
            total += self.frontend.d_frontend * d
        if self.n_branches > 1:
            total *= self.n_branches  # per-branch dims already divided by B
        return total

    def active_param_count(self) -> int:
        """Params active per token (MoE: top_k + shared experts only)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        eff = m.d_ff or self.d_ff
        d = self.d_model
        n_moe = sum(1 for _, f in self.pattern if f == "moe") * self.n_superblocks
        inactive = (m.n_experts - m.top_k) * 3 * d * eff * n_moe
        return self.param_count() - inactive

    # ------------------------------------------------------------- reductions
    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: <=2 superblocks, d_model<=512, <=4 experts."""
        d = min(self.d_model, 256)
        heads = max(1, min(self.n_heads, 4))
        kv = max(1, min(self.n_kv_heads, heads))
        hd = max(d // heads, 32)
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(
                self.moe, n_experts=min(self.moe.n_experts, 4),
                top_k=min(self.moe.top_k, 2),
                n_shared=min(self.moe.n_shared, 1),
                d_ff=min(self.moe.d_ff or self.d_ff, 4 * d) or 2 * d)
        fe = None
        if self.frontend is not None:
            fe = dataclasses.replace(self.frontend, n_tokens=16,
                                     d_frontend=min(self.frontend.d_frontend, 128))
        return self.replace(
            name=self.name + "-smoke",
            n_layers=len(self.pattern) * min(self.n_superblocks, 2),
            d_model=d, n_heads=heads, n_kv_heads=kv, head_dim=hd,
            d_ff=min(self.d_ff, 4 * d) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            sliding_window=min(self.sliding_window, 16) if self.sliding_window else 0,
            moe=moe, frontend=fe,
            n_enc_layers=min(self.n_enc_layers, 2),
            dtype="float32",
        )

    def semantic(self, n_branches: int = 16) -> "ArchConfig":
        """The paper's semantic split: B block-diagonal branches.

        Each branch is a full-depth model of width d_model/B whose vocab slice
        is vocab/B; indivisible head/expert counts are padded up (documented in
        DESIGN.md).  This is a *different model* (SplitNet) that would be
        trained separately — accuracy drops, latency drops.
        """
        b = n_branches
        d = _ceil_to(self.d_model, b) // b
        heads = max(1, _ceil_to(self.n_heads, b) // b)
        kv = max(1, _ceil_to(self.n_kv_heads, b) // b)
        hd = self.hd  # head_dim preserved; branch width = heads*hd implied
        moe = None
        if self.moe is not None:
            ne = max(1, _ceil_to(self.moe.n_experts, b) // b)
            moe = dataclasses.replace(
                self.moe, n_experts=ne, top_k=min(self.moe.top_k, ne),
                n_shared=1 if self.moe.n_shared else 0,
                d_ff=max(1, _ceil_to(self.moe.d_ff or self.d_ff, b) // b))
        fe = self.frontend
        return self.replace(
            name=self.name + f"-sem{b}",
            d_model=d, n_heads=heads, n_kv_heads=kv, head_dim=hd,
            d_ff=_ceil_to(self.d_ff, b) // b if self.d_ff else 0,
            vocab_size=_ceil_to(self.vocab_size, b) // b,
            sliding_window=self.sliding_window,
            moe=moe, frontend=fe, n_branches=b,
        )


# ----------------------------------------------------------------- registry
_REGISTRY: dict = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    if not _REGISTRY:
        _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch '{name}'; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> Sequence[str]:
    if not _REGISTRY:
        _load_all()
    return sorted(_REGISTRY)


ASSIGNED = (
    "phi3.5-moe-42b-a6.6b", "yi-34b", "gemma2-27b", "qwen2-moe-a2.7b",
    "jamba-1.5-large-398b", "whisper-base", "stablelm-1.6b", "xlstm-125m",
    "internvl2-26b", "starcoder2-15b",
)


def _load_all() -> None:
    import importlib
    mods = [
        "phi35_moe", "yi_34b", "gemma2_27b", "qwen2_moe", "jamba_15_large",
        "whisper_base", "stablelm_16b", "xlstm_125m", "internvl2_26b",
        "starcoder2_15b", "paper_workloads",
    ]
    for m in mods:
        importlib.import_module(f"repro_torch.configs.{m}")
