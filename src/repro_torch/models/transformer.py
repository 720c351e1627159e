"""Superblock assembly of the training forward (``repro.models.transformer``
without decode caches or encoder inputs).

Every tensor carries a leading branch dim G (G = 1 for ``Model``): where the
JAX package ``jax.vmap``-ed a ``SemanticModel``'s branches, the branches run
side by side here.  Block leaves are [G, ...]; stack leaves [G, n, ...]
(branch, superblock), and the JAX ``lax.scan`` over the stacked leaves is a
loop over their ``[:, i]`` slices.  Every apply returns ``(x, aux)`` with
aux [G], the per-branch sum of the MoE load-balance terms.

``remat`` is ``torch.utils.checkpoint`` (non-reentrant) around one
superblock, the body that ``jax.checkpoint`` wraps at
``repro/models/transformer.py:155,186``: its activations are recomputed in
the backward, so the attention forward runs twice per layer and step.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models.moe import moe_apply


def block_apply(params, x, cfg: ArchConfig, mixer: str, ffn: str, *,
                positions):
    """One block on x [G, B, S, d].  Returns (x, aux [G])."""
    g, b, s, d = x.shape
    aux = x.new_zeros(g, dtype=torch.float32)
    h = L.norm_apply(params["mix_norm"], x, cfg)
    if mixer != "attn":
        raise NotImplementedError(
            f"mixer {mixer!r} is ported with the rest of the zoo")
    out, _ = L.attn_apply(params["mix"], h, cfg, positions=positions)
    if cfg.post_norms:
        out = L.norm_apply(params["mix_post_norm"], out, cfg)
    x = x + out
    if ffn != "none":
        h = L.norm_apply(params["ffn_norm"], x, cfg).reshape(g, b * s, d)
        if ffn == "dense":
            out = L.mlp_apply(params["ffn"], h, cfg)
        else:
            out, aux = moe_apply(params["ffn"], h, cfg)
        out = out.reshape(g, b, s, d)
        if cfg.post_norms:
            out = L.norm_apply(params["ffn_post_norm"], out, cfg)
        x = x + out
    return x, aux


def superblock_apply(params, x, cfg: ArchConfig, *, positions):
    """Apply one superblock (leaves [G, ...]).  Returns (x, aux [G])."""
    aux = x.new_zeros(x.shape[0], dtype=torch.float32)
    for i, (mixer, ffn) in enumerate(cfg.pattern):
        x, a = block_apply(params[f"pos{i}"], x, cfg, mixer, ffn,
                           positions=positions)
        aux = aux + a
    return x, aux


def _slice(tree, i: int):
    """Superblock ``i`` of a stack tree: leaves [G, n, ...] -> [G, ...]."""
    return {k: _slice(v, i) if isinstance(v, dict) else v[:, i]
            for k, v in tree.items()}


def stack_apply_span(params_span, x, cfg: ArchConfig, *, positions,
                     remat: bool = False):
    """Loop over a span of stacked superblocks (leaves [G, n_local, ...]),
    each wrapped in a checkpoint when ``remat``.  Returns (x, aux [G])."""
    n = params_span["pos0"]["mix_norm"]["w"].shape[1]
    aux = x.new_zeros(x.shape[0], dtype=torch.float32)
    for i in range(n):
        sb = _slice(params_span, i)

        def body(h, sb=sb):
            return superblock_apply(sb, h, cfg, positions=positions)

        x, a = checkpoint(body, x, use_reentrant=False) if remat \
            else body(x)
        aux = aux + a
    return x, aux


def stack_apply(params, x, cfg: ArchConfig, *, positions,
                remat: bool = False):
    """The whole superblock stack (leaves [G, N_sb, ...]).  Returns
    (x, aux [G])."""
    return stack_apply_span(params, x, cfg, positions=positions, remat=remat)
