"""Sharding specs over the port's trees: ``repro.dist.sharding`` without JAX.

Everything here is layout only.  A spec (:class:`P`) says, per dim of a
leaf, which mesh axis (or tuple of axes) splits it, or ``None``: where the
runners keep each rank's slice of the parameters, the optimizer moments,
the caches and the batch (axes ``data`` x ``model``, optionally a leading
``pod``):

- ``fsdp_param_specs``      ZeRO-3 style: largest divisible dim over 'data',
                            a second dim over 'model' (tensor sharding).
- ``semantic_param_specs``  the semantic split: the leading branch dim
                            always lives on 'model', so each model-axis slice
                            owns whole branches.
- ``pipeline_param_specs``  the layer split: the stacked-superblock dim of
                            the block params lives on 'model'.
- ``stage_param_specs``     the explicit stage graph: block leaves' stack
                            dim on 'model', everything else replicated (or,
                            expert-parallel, the expert dim on 'model').

Specs only shard dims the axis size divides.  Trees are nested dicts (the
JAX param-tree layout of ``Model.param_tree()``) whose leaves have a
``shape``; every recipe returns a spec for every leaf, equal to the
reference's.  Mesh arguments need only ``shape`` (a dict of axis sizes).
"""
from __future__ import annotations

from typing import Optional

from repro_torch.optim.adamw import AdamWState


class P(tuple):
    """A partition spec: one entry per leading dim of a leaf, each an axis
    name, a tuple of axis names, or ``None`` (not split); trailing dims
    left out are not split."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def is_spec(x) -> bool:
    return isinstance(x, P)


def spec_axes(spec) -> tuple:
    """The mesh axes a spec splits over, in dim order."""
    out = []
    for e in spec:
        if e is None:
            continue
        out += list(e) if isinstance(e, tuple) else [e]
    return tuple(out)


def spec_leaves(specs) -> list:
    """The specs of a spec tree (nested dicts), in the tree's order."""
    if isinstance(specs, dict):
        return [x for k in specs for x in spec_leaves(specs[k])]
    return [specs]


def _axis_sizes(mesh) -> dict:
    return dict(mesh.shape)


def tree_map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over the leaves of nested dicts (and tuples, whose
    indices join the path as ints); ``path`` is the tuple of keys from the
    root.  Leaves are visited in sorted key order,
    as the reference's ``tree_map_with_path`` visits them (so a recipe
    raises on the same leaf); the result keeps the tree's key order."""
    if isinstance(tree, dict):
        out = {k: tree_map_with_path(fn, tree[k], path + (k,))
               for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if isinstance(tree, (tuple, list)) and not is_spec(tree):
        return type(tree)(tree_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def tree_map(fn, tree, *rest):
    """``fn(leaf, *other leaves)`` over nested dicts, a spec counting as a
    leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def _pick_dim(shape, axis_size: int, taken) -> int:
    """Largest dim divisible by axis_size and not already assigned (-1: none)."""
    best, best_size = -1, 0
    for i, s in enumerate(shape):
        if i in taken or s < axis_size or s % axis_size:
            continue
        if s > best_size:
            best, best_size = i, s
    return best


def _greedy_spec(shape, sizes: dict, axes, fixed: Optional[dict] = None) -> P:
    """Assign each mesh axis in ``axes`` (in order) to a distinct divisible
    dim of ``shape``; ``fixed`` pins dims to axes up front."""
    entries = [None] * len(shape)
    taken = set()
    if fixed:
        for d, ax in fixed.items():
            if d < len(shape):
                entries[d] = ax
                taken.add(d)
    for ax in axes:
        if sizes.get(ax, 1) <= 1 or ax in entries:
            continue
        d = _pick_dim(shape, sizes[ax], taken)
        if d >= 0:
            entries[d] = ax
            taken.add(d)
    return P(*entries)


def _path_has(path, *names) -> bool:
    return any(k in names for k in path)


def _leaf_key(path) -> str:
    """The last dict key on the path (tuple indices skipped)."""
    for k in reversed(path):
        if isinstance(k, str):
            return k
    return ""


# ------------------------------------------------------------- param specs
def fsdp_param_specs(params, mesh, *, zero_data: bool = True):
    """ZeRO-3 layout: per leaf, largest divisible dim sharded over 'data',
    second dim over 'model'."""
    sizes = _axis_sizes(mesh)
    axes = (["data"] if zero_data else []) + ["model"]
    return tree_map(lambda leaf: _greedy_spec(tuple(leaf.shape), sizes, axes),
                    params)


def semantic_param_specs(params, mesh, *, zero_data: bool = True):
    """Semantic-split layout: the leading branch dim of every leaf on
    'model'; the remaining dims get ZeRO-style 'data' sharding."""
    sizes = _axis_sizes(mesh)
    axes = ["data"] if zero_data else []
    return tree_map(lambda leaf: _greedy_spec(tuple(leaf.shape), sizes, axes,
                                              fixed={0: "model"}), params)


def pipeline_param_specs(params, mesh, *, zero_data: bool = True,
                         expert_parallel: bool = False):
    """Layer-split layout: the stacked-superblock dim of block leaves on
    'model'; embed and norms fall back to the fsdp recipe.  With
    ``expert_parallel`` the expert dim of MoE expert leaves takes 'model'
    instead."""
    sizes = _axis_sizes(mesh)
    axes = ["data"] if zero_data else []
    n_model = sizes.get("model", 1)

    def spec(path, leaf):
        shape = tuple(leaf.shape)
        if not _path_has(path, "blocks", "enc_blocks"):
            return _greedy_spec(shape, sizes, axes + ["model"])
        fixed = {}
        if expert_parallel and _path_has(path, "experts") and len(shape) >= 3 \
                and n_model > 1 and shape[1] % n_model == 0:
            fixed[1] = "model"           # [n_sb, n_experts, ...]
        elif n_model > 1 and shape and shape[0] % n_model == 0:
            fixed[0] = "model"           # stage (stacked superblock) dim
        return _greedy_spec(shape, sizes, axes, fixed=fixed)

    return tree_map_with_path(spec, params)


def stage_param_specs(params, mesh, *, expert_parallel: bool = False):
    """Stage-local layout of the explicit stage graph: block leaves put the
    stack dim on 'model' (each stage owns its contiguous span), everything
    else is replicated and nothing is split over 'data'.  With
    ``expert_parallel`` MoE expert leaves [n_sb, E, ...] split dim 1 over
    'model' and every other leaf is replicated."""
    sizes = _axis_sizes(mesh)
    n_model = sizes.get("model", 1)

    def spec(path, leaf):
        shape = tuple(leaf.shape)
        if not _path_has(path, "blocks", "enc_blocks") or n_model <= 1:
            return P(*([None] * len(shape)))
        if expert_parallel:
            if _path_has(path, "experts") and len(shape) >= 3 \
                    and shape[1] % n_model == 0:
                return P(*([None, "model"] + [None] * (len(shape) - 2)))
            return P(*([None] * len(shape)))
        if shape and shape[0] % n_model == 0:
            return P(*(["model"] + [None] * (len(shape) - 1)))
        raise ValueError(
            f"stage split needs n_superblocks divisible by the mesh 'model' "
            f"size {n_model}; got block leaf shape {shape}")

    return tree_map_with_path(spec, params)


# ------------------------------------------------------------- cache specs
def cache_specs(cache, mesh, *, shard_cache_len: bool = False,
                model_leading: bool = False):
    """Decode-cache layout.  Attention k/v leaves are [..., B, L, K, hd]:
    the batch dim splits over 'data' when it divides, or with
    ``shard_cache_len`` the cache length dim does.  ``model_leading``
    places the leading stack / branch dim on 'model'.  Recurrent state
    stays replicated."""
    sizes = _axis_sizes(mesh)
    n_data, n_model = sizes.get("data", 1), sizes.get("model", 1)

    def spec(path, leaf):
        shape = tuple(leaf.shape)
        entries = [None] * len(shape)
        if model_leading and shape and n_model > 1 and shape[0] % n_model == 0:
            entries[0] = "model"
        if _leaf_key(path) in ("k", "v") and len(shape) >= 4 and n_data > 1:
            b_dim, l_dim = len(shape) - 4, len(shape) - 3
            if shard_cache_len:
                if shape[l_dim] % n_data == 0 and entries[l_dim] is None:
                    entries[l_dim] = "data"
            elif shape[b_dim] % n_data == 0 and entries[b_dim] is None:
                entries[b_dim] = "data"
        return P(*entries)

    return tree_map_with_path(spec, cache)


def pool_specs(pool, mesh, *, model_leading: bool = False):
    """Paged-pool layout: :func:`cache_specs`'s with the physical-block dim
    in place of the batch dim, which no axis splits.  A lane's table may
    point at any block and prefix sharing aliases blocks across lanes, so
    each 'data' rank holds its model slice's whole pool.
    ``model_leading`` places the leading stack / branch dim on 'model'."""
    n_model = _axis_sizes(mesh).get("model", 1)

    def spec(path, leaf):
        shape = tuple(leaf.shape)
        entries = [None] * len(shape)
        if model_leading and shape and n_model > 1 and shape[0] % n_model == 0:
            entries[0] = "model"
        return P(*entries)

    return tree_map_with_path(spec, pool)


# ------------------------------------------------------------- batch specs
def batch_specs(cfg, mesh, batch):
    """Data-parallel batch layout: the leading (batch) dim over 'data'
    whenever it divides; everything else (and scalars) replicated."""
    del cfg  # uniform across architectures; kept for API symmetry
    n_data = _axis_sizes(mesh).get("data", 1)

    def spec(leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        if shape and n_data > 1 and shape[0] % n_data == 0:
            return P("data")
        return P()

    return tree_map(spec, batch)


# --------------------------------------------------------- optimizer specs
def make_opt_specs(p_specs) -> AdamWState:
    """AdamW state mirrors the param layout; the step counter is replicated."""
    return AdamWState(step=P(), m=p_specs, v=p_specs)


def pod_shard_opt_specs(o_specs: AdamWState, params_shape, mesh) -> AdamWState:
    """Additionally spread the optimizer moments over the 'pod' axis: a
    data-sharded dim upgrades to ('pod', 'data') when it divides, otherwise
    the largest free dim takes 'pod'."""
    sizes = _axis_sizes(mesh)
    n_pod = sizes.get("pod", 1)
    if n_pod <= 1:
        return o_specs
    n_data = sizes.get("data", 1)

    def upgrade(spec, leaf):
        shape = tuple(leaf.shape)
        entries = list(spec) + [None] * (len(shape) - len(spec))
        for d, (e, s) in enumerate(zip(entries, shape)):
            if e == "data" and s % (n_pod * n_data) == 0:
                entries[d] = ("pod", "data")
                return P(*entries)
        d = _pick_dim(shape, n_pod,
                      {i for i, e in enumerate(entries) if e is not None})
        if d >= 0:
            entries[d] = "pod"
        return P(*entries)

    return AdamWState(step=o_specs.step,
                      m=tree_map(upgrade, o_specs.m, params_shape),
                      v=tree_map(upgrade, o_specs.v, params_shape))


# -------------------------------------------------------------- arithmetic
def shard_shape(shape, spec, sizes: dict) -> tuple:
    """A rank's slice shape of a leaf of ``shape`` under ``spec``."""
    out = list(shape)
    for d, e in enumerate(spec):
        if e is None:
            continue
        n = 1
        for ax in (e if isinstance(e, tuple) else (e,)):
            n *= sizes.get(ax, 1)
        out[d] //= n
    return tuple(out)


def bytes_per_rank(tree, specs, mesh) -> int:
    """Bytes one rank stores of ``tree`` (leaves with ``shape`` and
    ``dtype``/``element_size``) under ``specs``: each leaf's bytes over its
    shard factor."""
    sizes = _axis_sizes(mesh)
    total = 0

    def add(leaf, spec):
        nonlocal total
        n = 1
        for s in shard_shape(tuple(leaf.shape), spec, sizes):
            n *= s
        total += n * leaf.element_size()

    tree_map(add, tree, specs)
    return total


def _entry_slot(entry, coords: dict, sizes: dict):
    """(index, count) of a rank's slice along a dim split by ``entry``
    (one axis or a tuple of axes, major first)."""
    idx, n = 0, 1
    for ax in (entry if isinstance(entry, tuple) else (entry,)):
        idx = idx * sizes.get(ax, 1) + coords.get(ax, 0)
        n *= sizes.get(ax, 1)
    return idx, n


def shard_leaf(leaf, spec, sizes: dict, coords: dict):
    """The slice of ``leaf`` (a tensor or a numpy array) that the rank at
    ``coords`` holds under ``spec`` (a view where the type allows)."""
    index = []
    for d, e in enumerate(spec):
        if e is None:
            index.append(slice(None))
            continue
        i, n = _entry_slot(e, coords, sizes)
        step = leaf.shape[d] // n
        index.append(slice(i * step, (i + 1) * step))
    return leaf[tuple(index)]


def owns_replica(spec, sizes: dict, coords: dict) -> bool:
    """True on the one rank of each slice's replicas that counts it: index
    0 on every axis the spec does not split."""
    used = set(spec_axes(spec))
    return all(coords.get(ax, 0) == 0 for ax in sizes if ax not in used)
