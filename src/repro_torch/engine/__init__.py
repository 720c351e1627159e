"""repro_torch.engine — the placement engine over the PyTorch backend.

One request lifecycle (``Request -> admit -> decide -> place -> execute ->
observe -> EngineStats``) as ``repro.engine`` defines it, executed by
``TorchBackend``.
"""
from repro_torch.engine.core import ExecutionBackend, PlacementEngine
from repro_torch.engine.policy import (CompressionPolicy, FixedPolicy,
                                       MABPolicy, Policy)
from repro_torch.engine.types import (APPS, COMPRESSED, LAYER, MODE_NAMES,
                                      SEMANTIC, EngineStats, Outcome, Request,
                                      accuracy_for, reward_for)

__all__ = [
    "APPS", "COMPRESSED", "LAYER", "MODE_NAMES", "SEMANTIC",
    "CompressionPolicy", "EngineStats", "ExecutionBackend", "FixedPolicy",
    "MABPolicy", "Outcome", "PlacementEngine", "Policy", "Request",
    "TorchBackend", "accuracy_for", "reward_for",
]


def __getattr__(name):
    # the backend imports the decode stack, which imports engine.types:
    # load it lazily, as repro.engine does its backends
    if name == "TorchBackend":
        from repro_torch.engine.torch_backend import TorchBackend
        return TorchBackend
    raise AttributeError(name)
