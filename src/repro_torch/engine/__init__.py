"""repro_torch.engine — the placement engine over the port's backends.

One request lifecycle (``Request -> admit -> decide -> place -> execute ->
observe -> EngineStats``) as ``repro.engine`` defines it, executed by
``TorchBackend``, by a ``FleetBackend`` of ``TorchBackend`` replicas behind
cache-aware routing, or by the vectorized edge simulator ``SimBackend``.
"""
from repro_torch.engine.arrivals import PoissonSource, TraceSource
from repro_torch.engine.core import ExecutionBackend, PlacementEngine
from repro_torch.engine.policy import (CompressionPolicy, FixedPolicy,
                                       MABPolicy, Policy)
from repro_torch.engine.routing import (CacheStatusBoard, PrefixAwareRouter,
                                        RequestFragment)
from repro_torch.engine.types import (APPS, COMPRESSED, LAYER, MODE_NAMES,
                                      SEMANTIC, EngineStats, Outcome, Request,
                                      accuracy_for, reward_for)

__all__ = [
    "APPS", "COMPRESSED", "LAYER", "MODE_NAMES", "SEMANTIC",
    "CacheStatusBoard", "CompressionPolicy", "EngineStats",
    "ExecutionBackend", "FixedPolicy", "FleetBackend", "MABPolicy",
    "Outcome", "PlacementEngine", "PoissonSource", "Policy",
    "PrefixAwareRouter", "ReplicaView", "Request", "RequestFragment",
    "SimBackend", "TorchBackend", "TraceSource", "accuracy_for",
    "reward_for",
]


def __getattr__(name):
    # the backends import the decode stack (which imports engine.types) or
    # the simulator: load them lazily, as repro.engine does
    if name == "TorchBackend":
        from repro_torch.engine.torch_backend import TorchBackend
        return TorchBackend
    if name == "SimBackend":
        from repro_torch.engine.sim_backend import SimBackend
        return SimBackend
    if name == "FleetBackend":
        from repro_torch.engine.fleet import FleetBackend
        return FleetBackend
    if name == "ReplicaView":
        from repro_torch.engine.fleet import ReplicaView
        return ReplicaView
    raise AttributeError(name)
