"""repro_torch.faults — deterministic, seeded fault injection for the
serving fleet: the port's own copy of ``repro.faults`` (numpy only).

  * :class:`FaultPlan`   — an immutable, seeded schedule of typed
    :class:`Fault` events.  ``FaultPlan.generate(seed, ...)`` draws a
    Poisson schedule deterministically; the same plan replays identically.
  * :class:`FaultInjector` — consumes a plan against the owner's clock.
    ``advance(now)`` fires due faults; charge-style faults (ship-wave
    loss/dup/delay, transient dispatch errors) become pools the serving
    hot paths drain via ``take_ship_fault`` / ``take_dispatch_error``.

``TorchBackend`` advances the injector on its *scheduler step counter*, so
fault firing is reproducible regardless of the host's wall clock — the
property the chaos-parity tests key on.  Consumers stamp
``Request.fault_t`` when a fault disrupts a request, and the next
(re)admission observes ``now - fault_t`` into a recovery-latency histogram,
emitting ``fault_injected`` / ``recovery`` instants through
``repro_torch.obs``.
"""
from repro_torch.faults.plan import (ARM_BLACKOUT, DISPATCH_ERROR,
                                     FAULT_KINDS, HOST_CRASH, HOST_STALL,
                                     SHIP_DELAY, SHIP_DROP, SHIP_DUP, Fault,
                                     FaultInjector, FaultPlan,
                                     TransientDispatchError)

__all__ = [
    "ARM_BLACKOUT", "DISPATCH_ERROR", "FAULT_KINDS", "HOST_CRASH",
    "HOST_STALL", "SHIP_DELAY", "SHIP_DROP", "SHIP_DUP", "Fault",
    "FaultInjector", "FaultPlan", "TransientDispatchError",
]
