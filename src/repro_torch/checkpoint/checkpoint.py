"""npz checkpointing in the format of ``repro.checkpoint.checkpoint``.

A tree (nested dicts, lists, tuples and NamedTuples of tensors, arrays or
ints) is saved as flat npz entries keyed by its ``/``-joined paths: dict keys
and sequence indices as they are, NamedTuple fields as ``.name`` (the JAX
package's ``str`` of a ``GetAttrKey``).  Floats that numpy cannot hold
(bf16) are stored widened to f32; an int leaf (``AdamWState.step``) as
int32, as the JAX package stores its step array.  So a checkpoint written by
either package loads in the other.  Atomic via a temporary file and a
rename.
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


def save(path: str, tree, *, step: Optional[int] = None) -> None:
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    flat = {k: _host(v) for k, v in _flatten(tree).items()}
    tmp = path.with_suffix(".tmp.npz")
    np.savez(tmp, **flat)
    os.replace(tmp, path)
    meta = {"step": step, "n_leaves": len(flat)}
    path.with_suffix(".meta.json").write_text(json.dumps(meta))


def restore(path: str, target):
    """A tree shaped like ``target`` (tensors, or ints for int leaves) with
    the checkpoint's values, each tensor in its target leaf's dtype and on
    its device."""
    data = np.load(path)

    def rebuild(tree, prefix):
        kids = _children(tree)
        if kids is None:
            arr = data[prefix]
            if isinstance(tree, int):
                return int(arr)
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
