"""npz checkpointing in the format of ``repro.checkpoint.checkpoint``.

A tree (nested dicts, lists, tuples and NamedTuples of tensors, arrays or
ints) is saved as flat npz entries keyed by its ``/``-joined paths: dict keys
and sequence indices as they are, NamedTuple fields as ``.name`` (the JAX
package's ``str`` of a ``GetAttrKey``).  Floats that numpy cannot hold
(bf16) are stored widened to f32; an int leaf (``AdamWState.step``) as
int32, as the JAX package stores its step array.  So a checkpoint written by
either package loads in the other.  Atomic via a temporary file and a
rename.

A tree sharded over a mesh (``specs``, a tree of ``dist.sharding.P`` of the
same structure, and ``mesh``) is saved whole: every rank gathers the slices
and rank 0 writes.  ``restore`` with ``specs`` and ``mesh`` gives each rank
its slice back.
"""
from __future__ import annotations

import json
import os
import pathlib
from typing import Any, Dict, Optional

import numpy as np
import torch

_NPZ_DTYPES = (np.float32, np.float64, np.int32, np.int64, np.int8,
               np.uint8, np.bool_, np.int16, np.uint32)


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree):
    """(path element, child) pairs of an inner node, or None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), v) for k, v in tree.items()]
    if _is_namedtuple(tree):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def _flatten(tree, prefix: str = "") -> Dict[str, Any]:
    kids = _children(tree)
    if kids is None:
        return {prefix: tree}
    flat = {}
    for k, v in kids:
        flat.update(_flatten(v, f"{prefix}/{k}" if prefix else k))
    return flat


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach()
        if v.dtype == torch.bfloat16:
            v = v.float()
        v = v.cpu().numpy()
    elif isinstance(v, int):
        v = np.asarray(v, np.int32)
    v = np.asarray(v)
    if v.dtype not in _NPZ_DTYPES:
        v = v.astype(np.float32)      # bf16 etc: store widened (npz-safe)
    return v


def _spec_flat(specs, prefix: str = "") -> Dict[str, Any]:
    from repro_torch.dist.sharding import is_spec
    if is_spec(specs):
        return {prefix: specs}
    kids = _children(specs)
    flat = {}
    for k, v in kids:
        flat.update(_spec_flat(v, f"{prefix}/{k}" if prefix else k))
    return flat


def _gathered(flat, specs, mesh) -> Dict[str, Any]:
    """Whole leaves from this rank's slices (every rank gets them)."""
    from repro_torch.dist import comm
    flat_specs = _spec_flat(specs)
    out = {}
    for k, v in flat.items():
        spec = flat_specs[k]
        if isinstance(v, torch.Tensor):
            for d, e in enumerate(spec):
                if e is None:
                    continue
                for ax in reversed(e if isinstance(e, tuple) else (e,)):
                    v = comm.all_gather_dim(v.detach(), d, mesh.group(ax))
        out[k] = v
    return out


def _write(path: str, flat, step: Optional[int]) -> None:
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    flat = {k: _host(v) for k, v in flat.items()}
    tmp = path.with_suffix(".tmp.npz")
    np.savez(tmp, **flat)
    os.replace(tmp, path)
    meta = {"step": step, "n_leaves": len(flat)}
    path.with_suffix(".meta.json").write_text(json.dumps(meta))


def save(path: str, tree, *, step: Optional[int] = None, specs=None,
         mesh=None) -> None:
    """Write ``tree``; a tree of slices (``specs`` on a distributed
    ``mesh``) is gathered first and written by rank 0 alone, and every
    rank returns once the file is in place."""
    flat = _flatten(tree)
    if mesh is None or not mesh.distributed:
        _write(path, flat, step)
        return
    from repro_torch.dist import comm
    flat = _gathered(flat, specs, mesh)
    try:
        if mesh.rank == 0:
            _write(path, flat, step)
    finally:
        comm.barrier()


def restore(path: str, target, *, specs=None, mesh=None):
    """A tree shaped like ``target`` (tensors, or ints for int leaves) with
    the checkpoint's values, each tensor in its target leaf's dtype and on
    its device.  With ``specs`` on a distributed ``mesh`` ``target`` holds
    this rank's slices, and each leaf is cut to the slice."""
    data = np.load(path)
    sliced = mesh is not None and mesh.distributed
    if sliced:
        from repro_torch.dist.sharding import shard_leaf
        flat_specs = _spec_flat(specs)
        sizes = dict(mesh.shape)

    def rebuild(tree, prefix):
        kids = _children(tree)
        if kids is None:
            arr = data[prefix]
            if isinstance(tree, int):
                return int(arr)
            if sliced:
                arr = shard_leaf(arr, flat_specs[prefix], sizes, mesh.coords)
            assert arr.shape == tuple(tree.shape), (prefix, arr.shape,
                                                    tuple(tree.shape))
            return torch.from_numpy(np.array(arr)).to(dtype=tree.dtype,
                                                      device=tree.device)
        out = [rebuild(v, f"{prefix}/{k}" if prefix else k) for k, v in kids]
        if isinstance(tree, dict):
            return dict(zip(tree.keys(), out))
        if _is_namedtuple(tree):
            return type(tree)(*out)
        return type(tree)(out)

    return rebuild(target, "")


def latest_step(ckpt_dir: str) -> Optional[int]:
    d = pathlib.Path(ckpt_dir)
    if not d.exists():
        return None
    steps = []
    for f in d.glob("step_*.npz"):
        try:
            steps.append(int(f.stem.split("_")[1]))
        except (IndexError, ValueError):
            continue
    return max(steps) if steps else None
