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


def global_norm(tree, *, specs=None, mesh=None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32.

    Over a sharded tree (``specs`` on a distributed ``mesh``) each rank
    sums the squares of the slices it owns, counting a slice replicated
    over an axis on that axis's rank 0 only, and the sums are all-reduced
    over the world: every rank gets the norm of the whole tree."""
    if mesh is None or not mesh.distributed:
        return torch.sqrt(sum(x.float().square().sum()
                              for x in tree_leaves(tree)))
    from repro_torch.dist import comm
    from repro_torch.dist.sharding import owns_replica, spec_leaves
    sizes = dict(mesh.shape)
    leaves = tree_leaves(tree)
    total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for x, spec in zip(leaves, spec_leaves(specs)):
        if owns_replica(spec, sizes, mesh.coords):
            total = total + x.float().square().sum()
    return torch.sqrt(comm.all_reduce_sum(total, None))


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
                 eps=1e-8, weight_decay=0.1, clip_norm=1.0, specs=None,
                 mesh=None):
    """One AdamW step over trees of the same paths; ``params`` and the
    state's moments are updated in place and returned as
    ``(params, AdamWState)``.  On a sharded tree (``specs``, ``mesh``) the
    clip reads the norm of the whole gradient (:func:`global_norm`)."""
    step = state.step + 1
    g_leaves = tree_leaves(grads)
    scale = None
    if clip_norm:
        g_norm = global_norm(grads, specs=specs, mesh=mesh)
        scale = torch.clamp(clip_norm / torch.clamp(g_norm, min=1e-9),
                            max=1.0)
    bc1 = 1 - b1 ** step
    bc2 = 1 - b2 ** step
    for g, m, v, p in zip(g_leaves, tree_leaves(state.m),
                          tree_leaves(state.v), tree_leaves(params)):
        gf = g.float()
        if scale is not None:
            gf = (g * scale.to(g.dtype)).float()
        # in place: an f32 leaf is its own f32 view (``t.float()`` is
        # ``t``); another dtype's f32 copy is written back.  Two leaf-sized
        # temporaries.
        mf, vf, pf = m.float(), v.float(), p.float()
        mf.mul_(b1).add_(gf * (1 - b1))
        vf.mul_(b2).add_(gf.square().mul_(1 - b2))
        del gf
        delta = (mf / bc1).div_((vf / bc2).sqrt_().add_(eps))
        delta.add_(pf * weight_decay)
        pf.sub_(delta.mul_(lr))
        for t, tf in ((m, mf), (v, vf), (p, pf)):
            if tf is not t:
                t.copy_(tf)
    return params, AdamWState(step, state.m, state.v)
