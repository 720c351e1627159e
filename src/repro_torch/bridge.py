"""Bridge from JAX param and pool pytrees, already converted to numpy
arrays by the caller, to the port's modules and pools.  Only tests use it:
it lets both packages run on the same weights.

A JAX param tree is a nested dict whose paths are the port's parameter
names (``embed.tok``, ``blocks.pos0.mix.wq`` ...); a ``SemanticModel``'s
tree carries the leading branch dim on every leaf in both packages.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.models.model import build_model


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
