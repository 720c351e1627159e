"""Model facade of the serving and training paths: ``build_model(cfg)`` ->
``Model`` (one branch) or ``SemanticModel`` (the paper's semantic split),
for every config of the zoo: decoder-only stacks of global or local
attention, Mamba and xLSTM mixers with dense, MoE or no FFNs, the enc-dec
whisper (an encoder over stubbed audio frames, cross-attention in every
decoder block) and the VLM internvl (stubbed patch embeddings projected
into prefix slots).

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

``InputShape``, ``INPUT_SHAPES`` and ``input_specs`` are the reference's
production input shapes, as meta tensors (the dry run's inputs).

The dense-cache surface of the legacy gang path follows it too:
``init_cache(batch_size, cache_len, window_override=)``,
``prefill_cache(params, cache, tokens, lengths=)`` and
``decode_step(params, cache, tokens, cache_index, enc_kv=, batch=,
window_override=)``.  ``params`` may be None there (the model's own
parameters, through views built once).  A dense cache's leaves are laid out
superblock-major in memory behind the JAX layout [(Bb,) N_sb, B, ...], so
one layer's slice of every branch is one strided tensor the
``decode_attention`` kernel reads directly; steps write the cache in place
and return it.  The paged serving path's pool comes from ``init_pool``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.moe import moe_shapes
from repro_torch.models.ssm import mamba_shapes
from repro_torch.models.xlstm import mlstm_shapes, slstm_shapes

#: elements drawn per ``torch.randn`` call in ``reset_parameters``: bounds
#: the f32 temporaries of a large leaf (qwen2-moe's [24, 60, 2048, 1408]
#: expert leaf would otherwise take 2 x 16.6 GB in f32)
INIT_CHUNK = 1 << 28
#: leaves kept in f32 whatever the model's dtype (Mamba's, as in JAX)
F32_LEAVES = ("A_log", "D")


def encoder_cfg(cfg: ArchConfig) -> ArchConfig:
    """The whisper encoder's config: bidirectional attention + dense FFN
    blocks, ``n_enc_layers`` deep."""
    return cfg.replace(causal=False, n_layers=cfg.n_enc_layers,
                       pattern=(("attn", "dense"),))


def supports_single_step_prefill(cfg: ArchConfig) -> bool:
    """Whole-prompt cache prefill needs pure global-attention mixers:
    recurrent state and local-window ring buffers update at S = 1 only,
    and enc-dec / VLM inputs need their frontends."""
    return (all(m == "attn" for m, _ in cfg.pattern)
            and not cfg.is_encdec and cfg.frontend is None)


def _attn_shapes(cfg: ArchConfig) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return {"wq": (d, h * hd), "wk": (d, kv * hd), "wv": (d, kv * hd),
            "wo": (h * hd, d)}


@torch.no_grad()
def init_leaf(name: str, p: torch.Tensor, generator: torch.Generator):
    """Fill parameter ``name`` with the JAX init's distribution: dense
    N(0, 1/d_in) (the mLSTM's per-head blocks N(0, 1/hd)), token table
    N(0, 0.02^2), Mamba's conv N(0, 0.1^2), ``A_log`` log(1..d_state),
    norm and ``D`` scales 1, biases 0.  A large leaf is drawn a slab of
    leading-dim rows at a time (at most ``INIT_CHUNK`` elements), so the
    f32 temporaries stay bounded."""
    leaf = name.rsplit(".", 1)[-1]
    if "norm" in name or leaf in ("gn_w", "D"):
        p.fill_(0.0 if leaf == "b" else 1.0)
    elif leaf in ("conv_b", "dt_bias"):
        p.zero_()
    elif leaf == "A_log":
        p.copy_(torch.log(torch.arange(1, p.shape[-1] + 1,
                                       dtype=torch.float32,
                                       device=p.device)).expand_as(p))
    else:
        rows = p.view(-1, *p.shape[-2:])
        step = max(1, INIT_CHUNK // rows[0].numel())
        for r0 in range(0, rows.shape[0], step):
            if leaf in ("tok", "conv_w"):
                L.normal_init(rows[r0:r0 + step], generator,
                              0.02 if leaf == "tok" else 0.1)
            else:
                L.dense_init(rows[r0:r0 + step], generator)


_MIXER_SHAPES = {"attn": _attn_shapes, "attn_local": _attn_shapes,
                 "mamba": mamba_shapes, "mlstm": mlstm_shapes,
                 "slstm": slstm_shapes}


def _block_shapes(cfg: ArchConfig, mixer: str, ffn: str,
                  cross: bool = False) -> dict:
    if mixer not in _MIXER_SHAPES:
        raise ValueError(mixer)
    p = {"mix_norm": L.norm_shapes(cfg), "mix": _MIXER_SHAPES[mixer](cfg)}
    if cfg.post_norms:
        p["mix_post_norm"] = L.norm_shapes(cfg)
    if cross:
        p["cross_norm"] = L.norm_shapes(cfg)
        p["cross"] = _attn_shapes(cfg)
    if ffn not in ("dense", "moe", "none"):
        raise ValueError(ffn)
    if ffn != "none":
        p["ffn_norm"] = L.norm_shapes(cfg)
        p["ffn"] = L.mlp_shapes(cfg) if ffn == "dense" else moe_shapes(cfg)
        if cfg.post_norms:
            p["ffn_post_norm"] = L.norm_shapes(cfg)
    return p


def _stack_shapes(cfg: ArchConfig, cross: bool = False) -> dict:
    n = cfg.n_superblocks
    lead = lambda t: {k: lead(v) for k, v in t.items()} \
        if isinstance(t, dict) else (n,) + t
    return {f"pos{i}": lead(_block_shapes(cfg, mixer, ffn, cross))
            for i, (mixer, ffn) in enumerate(cfg.pattern)}


def param_shapes(cfg: ArchConfig) -> dict:
    """Nested dict of leaf shapes in the JAX param-tree layout (one branch;
    block leaves carry the leading ``N_sb`` dim)."""
    embed = {"tok": (cfg.vocab_size, cfg.d_model)}
    if not cfg.tie_embeddings:
        embed["head"] = (cfg.d_model, cfg.vocab_size)
    if cfg.frontend is not None:
        embed["frontend_proj"] = (cfg.frontend.d_frontend, cfg.d_model)
    tree = {"embed": embed, "blocks": _stack_shapes(cfg, cfg.is_encdec),
            "final_norm": L.norm_shapes(cfg)}
    if cfg.is_encdec:
        tree["enc_blocks"] = _stack_shapes(encoder_cfg(cfg))
        tree["enc_norm"] = L.norm_shapes(cfg)
    return tree


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
                dt = torch.float32 if k in F32_LEAVES else dtype
                self.register_parameter(k, nn.Parameter(
                    torch.empty(lead + tuple(v), dtype=dt, device=device),
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


class _LM(nn.Module):
    """Shared parameter tree, caches and forwards; ``n_branches`` leading
    dim (absent for the single-branch ``Model``)."""

    def __init__(self, cfg: ArchConfig, branch_cfg: ArchConfig,
                 branch_lead: tuple, device):
        super().__init__()
        self.cfg = cfg
        self.branch_cfg = branch_cfg
        self.enc_cfg = encoder_cfg(branch_cfg) if cfg.is_encdec else None
        self._lead = branch_lead
        dtype = L.torch_dtype(cfg)
        for k, sub in param_shapes(branch_cfg).items():
            self.add_module(k, ParamTree(sub, branch_lead, dtype, device))
        self._own: Optional[dict] = None

    @property
    def device(self) -> torch.device:
        return self.embed["tok"].device

    @property
    def supports_single_step_prefill(self) -> bool:
        return supports_single_step_prefill(self.branch_cfg)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> "_LM":
        """Random weights with the JAX init's distributions
        (:func:`init_leaf` on every parameter)."""
        for name, p in self.named_parameters():
            init_leaf(name, p, generator)
        return self

    def grouped_views(self):
        """(embed, final_norm, per-superblock params) with a leading branch
        dim G on every leaf (G = 1 for ``Model``): the pieces of
        ``_grouped(None)`` the paged path reads."""
        p = self._grouped(None)
        return p["embed"], p["final_norm"], p["blocks"]

    def param_tree(self) -> Dict:
        """The parameters as nested dicts in the JAX param-tree layout
        (the leaves are the ``nn.Parameter``s themselves)."""
        return {k: _view_tree(m, lambda p: p)
                for k, m in self.named_children()}

    # ------------------------------------------------------------ forwards
    def _grouped(self, params) -> Dict:
        """``params`` with a leading branch dim G on every leaf (G = 1 for
        ``Model``) and the stacks as lists of per-superblock views.
        ``params`` None: the model's own parameters, views built once
        (weights change in place only)."""
        if params is None:
            if self._own is None:
                self._own = self._grouped(self.param_tree())
            return self._own

        def g(t):
            if isinstance(t, dict):
                return {k: g(v) for k, v in t.items()}
            if isinstance(t, T.StackOnUse):
                return t.map(lambda x: x.unsqueeze(0))
            return t.unsqueeze(0)
        p = dict(params) if self._lead else g(params)
        for k in ("blocks", "enc_blocks"):
            if k in p:
                p[k] = T.superblocks(p[k])
        return p

    def _frontend(self, p, embeds: torch.Tensor) -> torch.Tensor:
        """Stubbed frame / patch embeddings [B, F, d_frontend] projected to
        every branch: [G, B, F, d]."""
        w = p["embed"]["frontend_proj"]
        return torch.einsum("bfe,ged->gbfd", embeds.to(w.dtype), w)

    def _encode(self, p, audio_embeds: torch.Tensor) -> torch.Tensor:
        """The whisper encoder over stubbed frame embeddings."""
        x = self._frontend(p, audio_embeds)
        pos = torch.arange(x.shape[2], device=x.device)[None, :]
        x, _, _ = T.stack_apply(p["enc_blocks"], x, self.enc_cfg,
                                positions=pos)
        return L.norm_apply(p["enc_norm"], x, self.branch_cfg)

    def _enc_kv_stack(self, sbs, enc_out: torch.Tensor) -> List[dict]:
        """The cross-attention K, V of each decoder superblock of ``sbs``
        (the whole stack's, or a stage's span)."""
        return [{f"pos{i}": L.cross_kv(sb[f"pos{i}"]["cross"], enc_out,
                                       self.branch_cfg)
                 for i in range(len(self.branch_cfg.pattern))}
                for sb in map(T.fetched, sbs)]

    def _is_vlm(self) -> bool:
        fe = self.cfg.frontend
        return fe is not None and fe.kind == "vision"

    def _hidden_grouped(self, params, batch, *, remat: bool,
                        window_override: Optional[int] = None, rows=None):
        """[G, B, S, d] final hidden states and the per-branch aux [G].
        ``rows``: the split of the batch's rows over ranks
        (``moe.RowSplit``), which sizes MoE capacity by the whole batch."""
        cfg = self.branch_cfg
        p = self._grouped(params)
        tokens = batch["tokens"]
        x = L.embed_apply(p["embed"], tokens, cfg)          # [G, B, S, d]
        enc_kv = None
        if cfg.is_encdec:
            enc_kv = self._enc_kv_stack(
                p["blocks"], self._encode(p, batch["audio_embeds"]))
        if self._is_vlm():
            prefix = self._frontend(p, batch["image_embeds"])
            x = torch.cat([prefix.to(x.dtype), x], dim=2)
        pos = torch.arange(x.shape[2], device=x.device)[None, :]
        x, _, aux = T.stack_apply(p["blocks"], x, cfg, positions=pos,
                                  enc_kv_stack=enc_kv, remat=remat,
                                  window_override=window_override, rows=rows)
        x = L.norm_apply(p["final_norm"], x, cfg)
        if self._is_vlm():
            x = x[:, :, -tokens.shape[1]:]
        return x, aux

    def _unembed(self, p, x: torch.Tensor, gather=None) -> torch.Tensor:
        """[G, B, S, d] -> logits [B, S, vocab] (branch shards merged).
        ``gather`` joins the per-branch logits [G, B*S, vocab/Bb] of ranks
        that hold the other branches (a semantic runner on a mesh) before
        they merge."""
        b = x.shape[1]
        x = L.norm_apply(p["final_norm"], x, self.branch_cfg).flatten(1, 2)
        logits = L.unembed_apply(p["embed"], x, self.branch_cfg)
        if gather is not None:
            logits = gather(logits)
        return self._merge(logits.unflatten(1, (b, -1)))

    def forward(self, params, batch, *, remat: bool = False,
                window_override: Optional[int] = None, rows=None):
        """Full-sequence forward.  Returns (logits, aux).  Materializes the
        full [B, S, vocab] logits: small scale only; training uses
        ``loss_chunked``.  ``rows`` as in ``_hidden_grouped``."""
        h, aux = self.hidden(params, batch, remat=remat,
                             window_override=window_override, rows=rows)
        return self.chunk_logits(params, h), aux

    def loss(self, params, batch, *, remat: bool = False):
        logits, aux = self.forward(params, batch, remat=remat)
        mask = batch.get("loss_mask")
        return cross_entropy(logits, batch["labels"], mask) + 0.01 * aux

    def loss_chunked(self, params, batch, *, chunk: int = 512,
                     remat: bool = False, rows=None):
        """Cross-entropy over sequence chunks of the unembedding; never
        materializes [B, S, vocab].  ``rows`` as in ``_hidden_grouped``."""
        h, aux = self.hidden(params, batch, remat=remat, rows=rows)
        return _chunked_ce(self, params, h, batch["labels"], chunk) \
            + 0.01 * aux

    # -------------------------------------------------------------- caches
    def init_pool(self, num_blocks: int, block_size: int) -> Dict:
        """Paged KV pool in the reference layout: ``{"pos<i>": {"k", "v"}}``
        with leaves [(Bb,) N_sb, P, bs, K, hd] in ``cfg.dtype``, dense."""
        c = self.branch_cfg
        shape = self._lead + (c.n_superblocks, num_blocks, block_size,
                              c.n_kv_heads, c.hd)
        kw = dict(dtype=L.torch_dtype(self.cfg), device=self.device)
        return {f"pos{i}": {"k": torch.zeros(shape, **kw),
                            "v": torch.zeros(shape, **kw)}
                for i in range(len(c.pattern))}

    def init_cache(self, batch_size: int, cache_len: int,
                   window_override: Optional[int] = None, *,
                   device=None) -> Dict:
        """Dense decode caches of the gang path, per block as
        ``transformer.block_cache`` lays them out, leaves [(Bb,) N_sb,
        batch_size, ...] (superblock-major in memory), on ``device`` (the
        model's by default).  ``window_override`` turns every
        global-attention cache into a ring buffer of that window."""
        cfg = self.branch_cfg
        if window_override is not None:
            cfg = cfg.replace(sliding_window=window_override, pattern=tuple(
                ("attn_local" if m == "attn" else m, f)
                for m, f in cfg.pattern))
            cache_len = min(cache_len, window_override)
        lead = (cfg.n_superblocks,) + self._lead
        dtype = L.torch_dtype(self.cfg)
        device = self.device if device is None else device
        caches = {f"pos{i}": T.block_cache(cfg, mixer, batch_size, cache_len,
                                           dtype, lead, device)
                  for i, (mixer, _) in enumerate(cfg.pattern)}
        if not self._lead:
            return caches
        return T.tree_map(lambda t: t.movedim(0, 1), caches)

    def _cache_grouped(self, cache):
        return cache if self._lead else \
            T.tree_map(lambda t: t.unsqueeze(0), cache)

    @torch.no_grad()
    def prefill_cache(self, params, cache, tokens: torch.Tensor, *,
                      cache_index: int = 0, lengths=None,
                      cache_axis: Optional[L.CacheAxis] = None, gather=None,
                      rows=None):
        """One forward over the whole prompt writes K/V at positions
        [cache_index, cache_index + S).  tokens: [B, S].  Returns ([B,
        vocab] logits, cache).  ``lengths`` ([B]) takes each sequence's
        logits at its true last prompt position instead of the shared
        padded last column.  ``cache_axis`` and ``gather`` serve a runner
        on a mesh: this rank's slab of caches whose length is split over a
        mesh axis with the merge over it (flash-decoding,
        ``layers.CacheAxis``), the join of other ranks' branch logits (see
        ``_unembed``), and ``rows`` the split of the rows over ranks (see
        ``_hidden_grouped``)."""
        cfg = self.branch_cfg
        p = self._grouped(params)
        x = L.embed_apply(p["embed"], tokens, cfg)
        pos = cache_index + torch.arange(tokens.shape[1],
                                         device=x.device)[None, :]
        x, _, _ = T.stack_apply(p["blocks"], x, cfg, positions=pos,
                                caches=self._cache_grouped(cache),
                                cache_index=cache_index,
                                cache_axis=cache_axis, rows=rows)
        return self._unembed(p, last_positions(x, lengths),
                             gather)[:, -1], cache

    @torch.no_grad()
    def decode_step(self, params, cache, tokens: torch.Tensor,
                    cache_index: int, *, enc_kv=None, batch=None,
                    window_override: Optional[int] = None,
                    cache_axis: Optional[L.CacheAxis] = None, gather=None,
                    rows=None):
        """One-token decode at the Python int ``cache_index``.  tokens:
        [B, 1].  Returns (logits [B, 1, vocab], cache).  An enc-dec model
        encodes ``batch["audio_embeds"]`` when ``enc_kv`` (what
        ``_enc_kv_stack`` returns) is not given.  ``cache_axis``,
        ``gather`` and ``rows`` as in :meth:`prefill_cache`."""
        cfg = self.branch_cfg
        p = self._grouped(params)
        x = L.embed_apply(p["embed"], tokens, cfg)
        if cfg.is_encdec and enc_kv is None:
            enc_kv = self._enc_kv_stack(
                p["blocks"], self._encode(p, batch["audio_embeds"]))
        pos = torch.full((1, 1), cache_index, dtype=torch.long,
                         device=x.device)
        x, _, _ = T.stack_apply(p["blocks"], x, cfg, positions=pos,
                                caches=self._cache_grouped(cache),
                                cache_index=cache_index, enc_kv_stack=enc_kv,
                                window_override=window_override,
                                cache_axis=cache_axis, rows=rows)
        return self._unembed(p, x, gather), cache


class Model(_LM):
    """Single-branch model (n_branches == 1)."""

    def __init__(self, cfg: ArchConfig, *, device=None):
        if cfg.n_branches != 1:
            raise ValueError("Model takes a single-branch config")
        super().__init__(cfg, cfg, (), device)

    @staticmethod
    def _merge(logits: torch.Tensor) -> torch.Tensor:
        return logits[0]

    def hidden(self, params, batch, *, remat: bool = False,
               window_override: Optional[int] = None, rows=None):
        """Final hidden states (pre-unembed).  Returns (h [B, S, d], aux)."""
        h, aux = self._hidden_grouped(params, batch, remat=remat,
                                      window_override=window_override,
                                      rows=rows)
        return h[0], aux[0]

    def chunk_logits(self, params, h):
        """Unembed a [B, C, d] chunk of hidden states -> [B, C, vocab]."""
        return L.unembed_apply(params["embed"], h, self.cfg)

    # ----------------------------------------------------- per-stage surface
    # The explicit stage-graph pipeline (repro_torch.dist.pipeline) calls the
    # model in three pieces: stage 0 embeds, every stage applies its span of
    # the superblock stack, the last stage runs the head.  Serving on the
    # stages (dist.api.PipelineRunner) also takes a VLM's patch prefix and
    # whisper's encoder, run as its own chain of stages before the decoder's
    # (stage_encode), each stage making its span's cross K/V (stage_enc_kv).
    @property
    def supports_stage_split(self) -> bool:
        """Training's test: plain decoder-only stacks only (enc-dec cross
        inputs and modality frontends are stage-0 side inputs the stage
        graph's schedules do not route; serving takes both)."""
        return not self.cfg.is_encdec and self.cfg.frontend is None

    def stage_embed(self, params, tokens, image_embeds=None):
        """[B, S] tokens -> [B, S, d] stage-0 input activations; a VLM's
        stubbed patch embeddings [B, P, d_frontend], when given, projected
        into P prefix slots ahead of them ([B, P + S, d])."""
        x = L.embed_apply(params["embed"], tokens, self.cfg)
        if image_embeds is None:
            return x
        w = params["embed"]["frontend_proj"]
        prefix = torch.einsum("bfe,ed->bfd", image_embeds.to(w.dtype), w)
        return torch.cat([prefix.to(x.dtype), x], dim=1)

    @staticmethod
    def _span(blocks_span) -> List:
        """A span's superblocks (leaves [n_local, ...], or a
        :class:`~repro_torch.models.transformer.StackOnUse` of the span),
        each leaf with a leading group dim of 1."""
        lead = lambda t: t.unsqueeze(0)
        return T.superblocks(
            blocks_span.map(lead) if isinstance(blocks_span, T.StackOnUse)
            else T.tree_map(lead, blocks_span))

    def stage_apply(self, blocks_span, x, *, positions, remat: bool = False,
                    caches=None, cache_index: Optional[int] = None,
                    cache_axis: Optional[L.CacheAxis] = None,
                    window_override: Optional[int] = None, rows=None,
                    enc_kv_stack: Optional[List[dict]] = None):
        """Apply a contiguous span of the superblock stack (leaves carry a
        leading [n_local] dim, or a :class:`~repro_torch.models.transformer.
        StackOnUse` of the span) to x [B, S, d]; ``remat`` checkpoints each
        superblock.  ``caches`` (leaves [n_local, B, ...], the span's decode
        caches) are written in place at ``cache_index``; ``rows`` as in
        ``_hidden_grouped``; ``enc_kv_stack`` the span's cross K/V
        (:meth:`stage_enc_kv`).  Returns (x, aux)."""
        lead = lambda t: t.unsqueeze(0)
        x, _, aux = T.stack_apply(
            self._span(blocks_span), x[None], self.cfg, positions=positions,
            remat=remat, caches=None if caches is None
            else T.tree_map(lead, caches), cache_index=cache_index,
            cache_axis=cache_axis, window_override=window_override,
            rows=rows, enc_kv_stack=enc_kv_stack)
        return x[0], aux[0]

    def stage_encode(self, params, enc_span, x, *, first: bool, last: bool):
        """One stage's piece of the whisper encoder (``_encode`` cut at the
        stage boundaries): the first stage projects the stubbed frame
        embeddings x [B, F, d_frontend] with ``frontend_proj``; every stage
        applies its span of ``enc_blocks`` (as :meth:`stage_apply`) to [B,
        F, d]; the last applies ``enc_norm``.  Returns [B, F, d]."""
        if first:
            w = params["embed"]["frontend_proj"]
            x = torch.einsum("bfe,ed->bfd", x.to(w.dtype), w)
        pos = torch.arange(x.shape[1], device=x.device)[None, :]
        x, _, _ = T.stack_apply(self._span(enc_span), x[None], self.enc_cfg,
                                positions=pos)
        x = x[0]
        return L.norm_apply(params["enc_norm"], x, self.cfg) if last else x

    def stage_enc_kv(self, blocks_span, enc_out) -> List[dict]:
        """The cross-attention K/V of a span's decoder superblocks over the
        encoder's output [B, F, d] (each leaf [1, B, F, K, hd]), what
        :meth:`stage_apply` takes as ``enc_kv_stack``."""
        return self._enc_kv_stack(self._span(blocks_span), enc_out[None])

    def stage_head_logits(self, params, h):
        """Final norm + unembed of the last stage's hidden states [B, S, d]
        -> f32 logits [B, S, vocab]."""
        h = L.norm_apply(params["final_norm"], h, self.cfg)
        return L.unembed_apply(params["embed"], h, self.cfg)

    def stage_head_loss(self, params, h, labels):
        """Final norm + unembed + mean CE over one microbatch's hidden states
        (the last pipeline stage's op; aux is routed by the schedule).
        Materializes the microbatch's [B, S, vocab] logits."""
        h = L.norm_apply(params["final_norm"], h, self.cfg)
        return cross_entropy(L.unembed_apply(params["embed"], h, self.cfg),
                             labels)


class SemanticModel(_LM):
    """The paper's semantic split: Bb independent block-diagonal branches,
    each a full-depth model of width d/Bb over a vocab shard; the only
    cross-branch op is the final logit concat."""

    def __init__(self, cfg: ArchConfig, *, device=None):
        if cfg.n_branches < 2:
            raise ValueError("SemanticModel takes a multi-branch config")
        super().__init__(cfg, cfg.replace(n_branches=1), (cfg.n_branches,),
                         device)

    @staticmethod
    def _merge(logits: torch.Tensor) -> torch.Tensor:
        """[Bb, batch, (seq,) vocab/Bb] -> [batch, (seq,) vocab],
        branch-major shards."""
        return logits.movedim(0, -2).flatten(-2)

    def hidden(self, params, batch, *, remat: bool = False,
               window_override: Optional[int] = None, rows=None):
        """Per-branch hidden states [Bb, B, S, d_branch] and the aux terms
        summed over branches."""
        h, aux = self._hidden_grouped(params, batch, remat=remat,
                                      window_override=window_override,
                                      rows=rows)
        return h, aux.sum()

    @property
    def supports_stage_split(self) -> bool:
        return False  # branches already own the 'model' axis

    def chunk_logits(self, params, h):
        """h: [Bb, B, C, d_b] -> merged [B, C, vocab]."""
        logits = L.unembed_apply(params["embed"], h.flatten(1, 2),
                                 self.branch_cfg)       # [Bb, B*C, V/Bb]
        return self._merge(logits.unflatten(1, h.shape[1:3]))


def last_positions(x: torch.Tensor, lengths=None) -> torch.Tensor:
    """x [..., B, S, d] -> [..., B, 1, d]: each row's hidden state at its
    last prompt position ``lengths - 1`` ([B]), or the shared last
    column."""
    if lengths is None:
        return x[..., -1:, :]
    idx = torch.as_tensor(lengths, device=x.device).long() - 1
    return x[..., torch.arange(x.shape[-3], device=x.device), idx, :][
        ..., None, :]


def build_model(cfg: ArchConfig, *, device=None):
    return SemanticModel(cfg, device=device) if cfg.n_branches > 1 \
        else Model(cfg, device=device)


# ------------------------------------------------------------- input shapes
@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                  # 'train' | 'prefill' | 'decode'


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


def input_specs(cfg: ArchConfig, shape: InputShape, *,
                batch_override: Optional[int] = None) -> Dict:
    """Meta-tensor stand-ins for every model input (no allocation), the
    reference's shapes and dtypes."""
    b = batch_override or shape.global_batch
    dt = L.torch_dtype(cfg)
    meta = lambda *s, dtype=torch.int32: torch.empty(s, dtype=dtype,
                                                     device="meta")
    if shape.kind in ("train", "prefill"):
        s = shape.seq_len
        specs = {}
        if cfg.is_encdec:
            # half the budget to encoder frames, half to decoder tokens
            fe = cfg.frontend
            specs["audio_embeds"] = meta(b, min(fe.n_tokens, s // 2),
                                         fe.d_frontend, dtype=dt)
            s = s // 2
        if cfg.frontend is not None and cfg.frontend.kind == "vision":
            fe = cfg.frontend
            npatch = min(fe.n_tokens, s // 2)
            specs["image_embeds"] = meta(b, npatch, fe.d_frontend, dtype=dt)
            s = s - npatch
        specs["tokens"] = meta(b, s)
        if shape.kind == "train":
            specs["labels"] = meta(b, s)
        return specs
    # decode: one new token against a cache of seq_len
    specs = {"tokens": meta(b, 1)}
    if cfg.is_encdec:
        fe = cfg.frontend
        specs["audio_embeds"] = meta(b, fe.n_tokens, fe.d_frontend, dtype=dt)
    return specs
