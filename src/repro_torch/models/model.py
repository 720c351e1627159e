"""Model facade of the paged serving and training paths:
``build_model(cfg)`` -> ``Model`` (one branch) or ``SemanticModel`` (the
paper's semantic split).

Both are ``nn.Module``s whose parameter names follow the JAX param pytree
paths (``embed.tok``, ``blocks.pos0.mix.wq``, ``blocks.pos0.ffn.router``,
``final_norm.w``, ...).
Superblock leaves stay stacked ``[N_sb, ...]`` as in JAX, and
``SemanticModel`` carries a leading branch dim ``[Bb, ...]`` on every leaf
where the JAX package ``jax.vmap``-ed a single-branch model.  Weights are
random draws from an explicit ``torch.Generator`` or loaded in place
(``repro_torch.bridge``).

The training surface follows the JAX ``Model``: ``hidden``,
``chunk_logits``, ``forward``, ``loss`` and ``loss_chunked`` take an
explicit ``params`` tree (``param_tree()``: nested dicts of the parameters
in the JAX layout), so gradients come back as a tree of the same paths.

This slice runs decoder-only stacks of global attention with dense, MoE or
no FFNs; other mixers and modality frontends raise.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.moe import moe_shapes

#: elements drawn per ``torch.randn`` call in ``reset_parameters``: bounds
#: the f32 temporaries of a large leaf (qwen2-moe's [24, 60, 2048, 1408]
#: expert leaf would otherwise take 2 x 16.6 GB in f32)
INIT_CHUNK = 1 << 28


def _check_supported(cfg: ArchConfig) -> None:
    for mixer, ffn in cfg.pattern:
        if mixer != "attn":
            raise NotImplementedError(
                f"{cfg.name}: mixer {mixer!r} is ported in a later slice "
                "(legacy gang path and the rest of the zoo)")
        if ffn not in ("dense", "moe", "none"):
            raise ValueError(ffn)
    if cfg.is_encdec or cfg.frontend is not None:
        raise NotImplementedError(
            f"{cfg.name}: enc-dec and modality frontends come in a later "
            "slice")


def _block_shapes(cfg: ArchConfig, ffn: str) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {"mix_norm": L.norm_shapes(cfg),
         "mix": {"wq": (d, h * hd), "wk": (d, kv * hd), "wv": (d, kv * hd),
                 "wo": (h * hd, d)}}
    if cfg.post_norms:
        p["mix_post_norm"] = L.norm_shapes(cfg)
    if ffn != "none":
        p["ffn_norm"] = L.norm_shapes(cfg)
        p["ffn"] = L.mlp_shapes(cfg) if ffn == "dense" else moe_shapes(cfg)
        if cfg.post_norms:
            p["ffn_post_norm"] = L.norm_shapes(cfg)
    return p


def param_shapes(cfg: ArchConfig) -> dict:
    """Nested dict of leaf shapes in the JAX param-tree layout (one branch;
    block leaves carry the leading ``N_sb`` dim)."""
    n = cfg.n_superblocks
    lead = lambda t: {k: lead(v) for k, v in t.items()} \
        if isinstance(t, dict) else (n,) + t
    embed = {"tok": (cfg.vocab_size, cfg.d_model)}
    if not cfg.tie_embeddings:
        embed["head"] = (cfg.d_model, cfg.vocab_size)
    blocks = {f"pos{i}": lead(_block_shapes(cfg, ffn))
              for i, (_, ffn) in enumerate(cfg.pattern)}
    return {"embed": embed, "blocks": blocks,
            "final_norm": L.norm_shapes(cfg)}


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean (or ``mask``-weighted) token cross-entropy in f32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    if mask is not None:
        return -(ll * mask).sum() / mask.sum().clamp_min(1.0)
    return -ll.mean()


def _chunked_ce(model, params, h: torch.Tensor, labels: torch.Tensor,
                chunk: int) -> torch.Tensor:
    """CE over sequence chunks of the final hidden states, never holding
    [B, S, vocab] logits.  ``h``: [B, S, d] (or [Bb, B, S, d] for semantic
    models: ``model.chunk_logits`` merges branches per chunk).  The last
    chunk may be short (the JAX version pads it with ignored positions)."""
    seq_axis = h.dim() - 2
    s = h.shape[seq_axis]
    chunk = min(chunk, s)
    total = h.new_zeros((), dtype=torch.float32)
    for c0 in range(0, s, chunk):
        logits = model.chunk_logits(params, h.narrow(seq_axis, c0, min(
            chunk, s - c0)))
        logp = torch.log_softmax(logits.float(), dim=-1)
        lc = labels[:, c0:c0 + chunk].long()
        total = total - torch.gather(logp, -1, lc[..., None]).sum()
    return total / (labels.shape[0] * s)


class ParamTree(nn.Module):
    """One node of the parameter tree: leaves are parameters, subtrees are
    child nodes (a MoE node holds both: ``router`` beside ``experts``).  It
    indexes and iterates like a dict, so parameter names are the JAX tree
    paths.  Parameters are created without grad (serving); training turns
    it on with ``requires_grad_()``."""

    def __init__(self, tree: dict, lead: tuple, dtype, device):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, ParamTree(v, lead, dtype, device))
            else:
                self.register_parameter(k, nn.Parameter(
                    torch.empty(lead + tuple(v), dtype=dtype, device=device),
                    requires_grad=False))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def keys(self) -> List[str]:
        return [*self._parameters, *self._modules]

    def items(self):
        return [(k, self[k]) for k in self.keys()]


def _view_tree(node: ParamTree, fn) -> dict:
    """Plain nested dict of ``fn(leaf)`` over a parameter subtree."""
    return {k: _view_tree(v, fn) if isinstance(v, ParamTree) else fn(v)
            for k, v in node.items()}


class _PagedLM(nn.Module):
    """Shared parameter tree, pool factory and training forward;
    ``n_branches`` leading dim (absent for the single-branch ``Model``)."""

    def __init__(self, cfg: ArchConfig, branch_cfg: ArchConfig,
                 branch_lead: tuple, device):
        super().__init__()
        _check_supported(branch_cfg)
        self.cfg = cfg
        self.branch_cfg = branch_cfg
        self._lead = branch_lead
        dtype = L.torch_dtype(cfg)
        tree = param_shapes(branch_cfg)
        self.embed = ParamTree(tree["embed"], branch_lead, dtype, device)
        self.blocks = ParamTree(tree["blocks"], branch_lead, dtype, device)
        self.final_norm = ParamTree(tree["final_norm"], branch_lead, dtype,
                                    device)
        self._views: Optional[tuple] = None

    @property
    def device(self) -> torch.device:
        return self.embed["tok"].device

    @property
    def supports_single_step_prefill(self) -> bool:
        return all(m == "attn" for m, _ in self.branch_cfg.pattern)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> "_PagedLM":
        """Random weights with the JAX init's distributions: dense
        N(0, 1/d_in), token table N(0, 0.02^2), norm scale 1 and bias 0.
        Large leaves are drawn a slab of leading-dim rows at a time (at most
        ``INIT_CHUNK`` elements), so the f32 temporaries stay bounded."""
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if "norm" in name:
                p.fill_(1.0 if leaf == "w" else 0.0)
                continue
            rows = p.view(-1, *p.shape[-2:])
            step = max(1, INIT_CHUNK // rows[0].numel())
            for r0 in range(0, rows.shape[0], step):
                if leaf == "tok":
                    L.normal_init(rows[r0:r0 + step], generator, 0.02)
                else:
                    L.dense_init(rows[r0:r0 + step], generator)
        return self

    def grouped_views(self):
        """(embed, final_norm, per-superblock params) with a leading branch
        dim G on every leaf (G = 1 for ``Model``): views into the
        parameters, built once (weights change in place only)."""
        if self._views is None:
            g = (lambda t: t) if self._lead else (lambda t: t.unsqueeze(0))
            emb = {k: g(v) for k, v in self.embed.items()}
            fnorm = {k: g(v) for k, v in self.final_norm.items()}
            sbs: List[dict] = [
                _view_tree(self.blocks, lambda v, n=n: g(v)[:, n])
                for n in range(self.branch_cfg.n_superblocks)]
            self._views = (emb, fnorm, sbs)
        return self._views

    def param_tree(self) -> Dict:
        """The parameters as nested dicts in the JAX param-tree layout
        (the leaves are the ``nn.Parameter``s themselves)."""
        return {k: _view_tree(getattr(self, k), lambda p: p)
                for k in ("embed", "blocks", "final_norm")}

    # ------------------------------------------------------------ training
    def _grouped(self, params) -> Dict:
        """``params`` with a leading branch dim G on every leaf (G = 1 for
        ``Model``)."""
        if self._lead:
            return params
        g = lambda t: {k: g(v) for k, v in t.items()} \
            if isinstance(t, dict) else t.unsqueeze(0)
        return g(params)

    def _hidden_grouped(self, params, batch, *, remat: bool):
        """[G, B, S, d] final hidden states and the per-branch aux [G]."""
        cfg = self.branch_cfg
        p = self._grouped(params)
        tokens = batch["tokens"]
        x = L.embed_apply(p["embed"], tokens, cfg)          # [G, B, S, d]
        pos = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
        x, aux = T.stack_apply(p["blocks"], x, cfg, positions=pos,
                               remat=remat)
        return L.norm_apply(p["final_norm"], x, cfg), aux

    def forward(self, params, batch, *, remat: bool = False):
        """Full-sequence forward.  Returns (logits, aux).  Materializes the
        full [B, S, vocab] logits: small scale only; training uses
        ``loss_chunked``."""
        h, aux = self.hidden(params, batch, remat=remat)
        return self.chunk_logits(params, h), aux

    def loss(self, params, batch, *, remat: bool = False):
        logits, aux = self.forward(params, batch, remat=remat)
        mask = batch.get("loss_mask")
        return cross_entropy(logits, batch["labels"], mask) + 0.01 * aux

    def loss_chunked(self, params, batch, *, chunk: int = 512,
                     remat: bool = False):
        """Cross-entropy over sequence chunks of the unembedding; never
        materializes [B, S, vocab]."""
        h, aux = self.hidden(params, batch, remat=remat)
        return _chunked_ce(self, params, h, batch["labels"], chunk) \
            + 0.01 * aux

    def init_cache(self, num_blocks: int, block_size: int) -> Dict:
        """Paged KV pool in the reference layout: ``{"pos<i>": {"k", "v"}}``
        with leaves [(Bb,) N_sb, P, bs, K, hd] in ``cfg.dtype``."""
        c = self.branch_cfg
        shape = self._lead + (c.n_superblocks, num_blocks, block_size,
                              c.n_kv_heads, c.hd)
        kw = dict(dtype=L.torch_dtype(self.cfg), device=self.device)
        return {f"pos{i}": {"k": torch.zeros(shape, **kw),
                            "v": torch.zeros(shape, **kw)}
                for i in range(len(c.pattern))}


class Model(_PagedLM):
    """Single-branch model (n_branches == 1)."""

    def __init__(self, cfg: ArchConfig, *, device=None):
        if cfg.n_branches != 1:
            raise ValueError("Model takes a single-branch config")
        super().__init__(cfg, cfg, (), device)

    def hidden(self, params, batch, *, remat: bool = False):
        """Final hidden states (pre-unembed).  Returns (h [B, S, d], aux)."""
        h, aux = self._hidden_grouped(params, batch, remat=remat)
        return h[0], aux[0]

    def chunk_logits(self, params, h):
        """Unembed a [B, C, d] chunk of hidden states -> [B, C, vocab]."""
        return L.unembed_apply(params["embed"], h, self.cfg)


class SemanticModel(_PagedLM):
    """The paper's semantic split: Bb independent block-diagonal branches,
    each a full-depth model of width d/Bb over a vocab shard; the only
    cross-branch op is the final logit concat."""

    def __init__(self, cfg: ArchConfig, *, device=None):
        if cfg.n_branches < 2:
            raise ValueError("SemanticModel takes a multi-branch config")
        super().__init__(cfg, cfg.replace(n_branches=1), (cfg.n_branches,),
                         device)

    @staticmethod
    def _merge_logits(logits: torch.Tensor) -> torch.Tensor:
        """[Bb, batch, (seq,) vocab/Bb] -> [batch, (seq,) vocab],
        branch-major shards."""
        return logits.movedim(0, -2).flatten(-2)

    def hidden(self, params, batch, *, remat: bool = False):
        """Per-branch hidden states [Bb, B, S, d_branch] and the aux terms
        summed over branches."""
        h, aux = self._hidden_grouped(params, batch, remat=remat)
        return h, aux.sum()

    def chunk_logits(self, params, h):
        """h: [Bb, B, C, d_b] -> merged [B, C, vocab]."""
        logits = L.unembed_apply(params["embed"], h.flatten(1, 2),
                                 self.branch_cfg)       # [Bb, B*C, V/Bb]
        return self._merge_logits(logits.unflatten(1, h.shape[1:3]))


def build_model(cfg: ArchConfig, *, device=None):
    return SemanticModel(cfg, device=device) if cfg.n_branches > 1 \
        else Model(cfg, device=device)
