"""Hand-rolled AdamW (+ global-norm gradient clipping), as
``repro.optim.adamw``: the same order of operations, so the two packages
take the same step on the same gradients.

Trees are nested dicts of tensors (``Model.param_tree()`` and the gradients
``value_and_grad`` returns).  ``adamw_update`` updates the parameters and
the moments IN PLACE (one f32 copy of a 1.6 B-parameter model is 6.6 GB,
and the JAX version's fresh trees would need three more) and returns them,
so callers can use it the functional way.  ``torch.optim.AdamW`` is not
used: its decay step (``p *= 1 - lr wd`` before the Adam step) and its
rounding differ from the reference's ``p - lr (mhat / (sqrt(vhat) + eps) +
wd p)``.
"""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple

import torch


class AdamWState(NamedTuple):
    step: int
    m: Dict
    v: Dict


def tree_leaves(tree) -> List[torch.Tensor]:
    """The leaves of a nested-dict tree, in its insertion order."""
    if isinstance(tree, dict):
        return [x for k in tree for x in tree_leaves(tree[k])]
    return [tree]


def _zeros_like(tree, dtype):
    if isinstance(tree, dict):
        return {k: _zeros_like(v, dtype) for k, v in tree.items()}
    return torch.zeros(tree.shape, dtype=dtype, device=tree.device)


def adamw_init(params, state_dtype: str = "float32") -> AdamWState:
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[state_dtype]
    return AdamWState(0, _zeros_like(params, dt), _zeros_like(params, dt))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    return torch.sqrt(sum(x.float().square().sum()
                          for x in tree_leaves(tree)))


def cosine_schedule(base_lr: float, warmup: int, total: int):
    """Linear warmup to ``base_lr`` over ``warmup`` steps, then a cosine
    decay to 0 at ``total``."""
    def lr(step):
        step = float(step)
        if step < warmup:
            return base_lr * step / max(warmup, 1)
        prog = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
        return base_lr * 0.5 * (1.0 + math.cos(math.pi * prog))
    return lr


@torch.no_grad()
def adamw_update(grads, state: AdamWState, params, *, lr, b1=0.9, b2=0.95,
                 eps=1e-8, weight_decay=0.1, clip_norm=1.0):
    """One AdamW step over trees of the same paths; ``params`` and the
    state's moments are updated in place and returned as
    ``(params, AdamWState)``."""
    step = state.step + 1
    g_leaves = tree_leaves(grads)
    scale = None
    if clip_norm:
        g_norm = global_norm(grads)
        scale = torch.clamp(clip_norm / torch.clamp(g_norm, min=1e-9),
                            max=1.0)
    bc1 = 1 - b1 ** step
    bc2 = 1 - b2 ** step
    for g, m, v, p in zip(g_leaves, tree_leaves(state.m),
                          tree_leaves(state.v), tree_leaves(params)):
        gf = g.float()
        if scale is not None:
            gf = (g * scale.to(g.dtype)).float()
        m_new = b1 * m.float() + (1 - b1) * gf
        v_new = b2 * v.float() + (1 - b2) * gf.square()
        mhat = m_new / bc1
        vhat = v_new / bc2
        delta = mhat / (vhat.sqrt() + eps) + weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        m.copy_(m_new)
        v.copy_(v_new)
    return params, AdamWState(step, state.m, state.v)
