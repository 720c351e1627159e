"""Bridge between JAX pytrees, already converted to numpy arrays by the
caller, and the port's modules, pools, parameter trees and optimizer
state, in both directions.  Only tests use it: it lets both packages run
on the same weights and carry training state across.

A JAX param tree is a nested dict whose paths are the port's parameter
names (``embed.tok``, ``blocks.pos0.mix.wq`` ...); a ``SemanticModel``'s
tree carries the leading branch dim on every leaf in both packages.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.dist import sharding as SH
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import AdamWState
from repro_torch.sched.a3c import A3CParams


def _tensor(a, dtype=None, device="cpu") -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":        # ml_dtypes: no torch.from_numpy
        a = a.astype(np.float32)
    t = torch.from_numpy(np.array(a))      # a writable copy
    return t.to(device=device, dtype=dtype or t.dtype)


@torch.no_grad()
def load_params(model, tree: Dict) -> None:
    """Copy a numpy param tree into ``model``'s parameters in place; every
    parameter must be present with its exact shape."""
    for name, p in model.named_parameters():
        node = tree
        for part in name.split("."):
            node = node[part]
        if tuple(np.shape(node)) != tuple(p.shape):
            raise ValueError(f"{name}: tree shape {np.shape(node)} vs "
                             f"parameter {tuple(p.shape)}")
        p.copy_(_tensor(node, p.dtype, p.device))


def model_from_params(cfg, tree: Dict, *, device="cpu"):
    """``build_model(cfg)`` with the weights of a JAX param tree."""
    model = build_model(cfg, device=device)
    load_params(model, tree)
    return model


def pool_from_numpy(tree: Dict, *, device="cpu") -> Dict:
    """A numpy pool pytree ({"pos<i>": {"k", "v"[, scales]}}) as tensors."""
    return {k: pool_from_numpy(v, device=device) if isinstance(v, dict)
            else _tensor(v, device=device) for k, v in tree.items()}


def tree_to_numpy(tree) -> Dict:
    """A tree of tensors (``param_tree()``, gradients, AdamW moments) as a
    numpy tree of the same paths."""
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    t = tree.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()


def tree_from_numpy(tree, *, dtype=None, device="cpu") -> Dict:
    """A numpy tree as tensors (``dtype``: keep each leaf's by default)."""
    if isinstance(tree, dict):
        return {k: tree_from_numpy(v, dtype=dtype, device=device)
                for k, v in tree.items()}
    return _tensor(tree, dtype, device)


def opt_state_from_numpy(state, *, device="cpu") -> AdamWState:
    """A JAX ``AdamWState`` whose leaves are numpy arrays (anything with
    ``step``, ``m`` and ``v``) as the port's."""
    return AdamWState(int(np.asarray(state.step)),
                      tree_from_numpy(state.m, device=device),
                      tree_from_numpy(state.v, device=device))


def opt_state_to_numpy(state: AdamWState):
    """The port's ``AdamWState`` as ``(step, m, v)`` numpy leaves, in the
    order ``repro.optim.adamw.AdamWState(*...)`` takes them."""
    return (np.asarray(state.step, np.int32), tree_to_numpy(state.m),
            tree_to_numpy(state.v))


def a3c_params_from_numpy(params, *, device="cpu"):
    """A JAX ``A3CParams`` whose leaves are numpy arrays (any sequence of
    the eight in field order) as the port's."""
    return A3CParams(*(_tensor(p, torch.float32, device) for p in params))


def a3c_params_to_numpy(params):
    """The port's ``A3CParams`` as a tuple of numpy arrays, in field
    order."""
    return tuple(p.detach().cpu().numpy() for p in params)


def _walk(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree of dicts, NamedTuples and plain tuples
    (a recurrent cell's state) (an int leaf, as ``AdamWState.step``, passes
    through)."""
    if isinstance(tree, dict):
        return {k: _walk(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_walk(fn, getattr(tree, f), getattr(specs, f))
                            for f in tree._fields))
    if isinstance(tree, tuple) and not SH.is_spec(tree):
        return tuple(_walk(fn, t, s) for t, s in zip(tree, specs))
    if isinstance(tree, int):
        return tree
    return fn(tree, specs)


def shard_tree(tree, specs, mesh, coords) -> Dict:
    """The slice of a numpy or torch tree (params, gradients, AdamW state,
    decode caches) that the rank at ``coords`` (axis -> index) holds under
    ``specs`` on ``mesh``: a copy of each leaf's slice."""
    sizes = dict(mesh.shape)

    def cut(leaf, spec):
        part = SH.shard_leaf(leaf, spec, sizes, coords)
        return part.clone() if isinstance(part, torch.Tensor) else \
            np.array(part)
    return _walk(cut, tree, specs)


def rank_coords(mesh):
    """Every rank's coordinates (axis -> index) in rank order (row-major
    over the mesh dims, as ``init_mesh`` lays ranks out)."""
    names, dims = list(mesh.shape), list(mesh.shape.values())
    out = []
    for r in range(int(np.prod(dims))):
        c, rest = {}, r
        for n, d in zip(reversed(names), reversed(dims)):
            c[n], rest = rest % d, rest // d
        out.append({n: c[n] for n in names})
    return out


def gather_tree(shards, specs, mesh) -> Dict:
    """The inverse of :func:`shard_tree`: the full numpy tree from every
    rank's slice, ``shards`` in rank order (replicas must agree; the first
    is kept)."""
    sizes = dict(mesh.shape)
    coords = rank_coords(mesh)

    def leaves(tree, specs, out):
        if isinstance(tree, dict):
            for k in tree:
                leaves(tree[k], specs[k], out)
        elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
            for f in tree._fields:
                leaves(getattr(tree, f), getattr(specs, f), out)
        elif isinstance(tree, tuple) and not SH.is_spec(tree):
            for t, s in zip(tree, specs):
                leaves(t, s, out)
        else:
            out.append(tree)
        return out

    per_rank = [leaves(s, specs, []) for s in shards]
    it = iter(range(len(per_rank[0])))

    def build(leaf, spec):
        i = next(it)
        if isinstance(leaf, int):
            return leaf
        part = np.asarray(per_rank[0][i])
        full_shape = list(part.shape)
        for d, e in enumerate(spec):
            if e is not None:
                full_shape[d] *= SH._entry_slot(e, {}, sizes)[1]
        full = np.empty(full_shape, part.dtype)
        for c, tree_leaves in zip(coords, per_rank):
            view = SH.shard_leaf(full, spec, sizes, c)
            view[...] = np.asarray(tree_leaves[i])
        return full

    return _walk(build, shards[0], specs)
