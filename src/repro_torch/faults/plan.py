"""Typed faults, the seeded schedule, and the injector the backends drain.

The fault taxonomy (one kind per distinct failure mode of the fleet):

  ==================  =====================================================
  kind                what it models
  ==================  =====================================================
  ``host_crash``      a sim host churns out: in-flight fragments lose their
                      progress and must re-place on surviving hosts; the
                      host is unplaceable for ``duration`` sim-seconds.
  ``host_stall``      a straggler: the host's effective speed is multiplied
                      by ``magnitude`` (< 1) for ``duration`` sim-seconds.
  ``arm_blackout``    a split arm's device pool vanishes for ``duration``
                      scheduler steps: seated lanes spill host-side,
                      in-flight shipments fail immediately, and everything
                      re-admits through the preempt/resume + requeue paths
                      once the window closes.
  ``ship_drop``       one ship wave's arrival marks are lost: the ledger
                      entry expires and the request requeues with backoff.
  ``ship_dup``        one ship wave's arrival marks are duplicated (and
                      replayed late): the attempt-stamped ledger must stay
                      idempotent and ignore stale replays.
  ``ship_delay``      one ship wave's arrival marks are delayed by
                      ``magnitude`` seconds — racing the ledger deadline.
  ``dispatch_error``  ``count`` transient prefill/decode dispatch failures
                      (device hiccup): retried with exponential backoff
                      under a retry budget and a per-arm circuit breaker.
  ==================  =====================================================

A :class:`FaultPlan` is immutable and seed-deterministic: iterating it (or
feeding it to a fresh :class:`FaultInjector`) always yields the same
schedule, which is what makes a faulted run replayable bit-for-bit.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

HOST_CRASH = "host_crash"
HOST_STALL = "host_stall"
ARM_BLACKOUT = "arm_blackout"
SHIP_DROP = "ship_drop"
SHIP_DUP = "ship_dup"
SHIP_DELAY = "ship_delay"
DISPATCH_ERROR = "dispatch_error"

FAULT_KINDS = (HOST_CRASH, HOST_STALL, ARM_BLACKOUT, SHIP_DROP, SHIP_DUP,
               SHIP_DELAY, DISPATCH_ERROR)

#: ship-wave fault kinds — fired into the injector's wave-charge pool
SHIP_KINDS = (SHIP_DROP, SHIP_DUP, SHIP_DELAY)


class TransientDispatchError(RuntimeError):
    """A prefill/decode dispatch failed transiently (injected device
    hiccup).  Raised *before* the dispatch mutates any pool state, so a
    retry of the same call is always safe."""


@dataclass(frozen=True, order=True)
class Fault:
    """One scheduled fault.  ``at``/``duration`` are in the owning
    backend's clock units (sim seconds for ``SimBackend``, scheduler steps
    for ``TorchBackend``)."""
    at: float
    kind: str = field(compare=False)
    target: int = field(default=-1, compare=False)   # host/arm id, -1 = all
    duration: float = field(default=0.0, compare=False)
    count: int = field(default=1, compare=False)     # charges (ship/dispatch)
    magnitude: float = field(default=1.0, compare=False)  # stall x / delay s
    site: str = field(default="*", compare=False)    # prefill | decode | *

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; expected "
                             f"one of {FAULT_KINDS}")
        if self.at < 0 or self.duration < 0 or self.count < 1:
            raise ValueError(f"malformed fault {self!r}")
        if self.site not in ("*", "prefill", "decode"):
            raise ValueError(f"site must be '*', 'prefill' or 'decode', "
                             f"got {self.site!r}")


class FaultPlan:
    """An immutable, seeded, time-sorted schedule of faults."""

    def __init__(self, faults: Sequence[Fault] = (), *, seed: int = 0):
        self.faults: Tuple[Fault, ...] = tuple(sorted(faults))
        self.seed = seed

    def __iter__(self) -> Iterator[Fault]:
        return iter(self.faults)

    def __len__(self) -> int:
        return len(self.faults)

    def __repr__(self) -> str:
        return f"FaultPlan(n={len(self.faults)}, seed={self.seed})"

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for f in self.faults:
            out[f.kind] = out.get(f.kind, 0) + 1
        return out

    @classmethod
    def generate(cls, seed: int, *, horizon: float, n_hosts: int = 0,
                 arms: Sequence[int] = (),
                 rates: Optional[Dict[str, float]] = None,
                 crash_duration: float = 2.0, stall_factor: float = 0.25,
                 blackout_steps: float = 4.0,
                 ship_delay_s: float = 0.05) -> "FaultPlan":
        """Draw a Poisson schedule over ``[0, horizon)`` — deterministic in
        ``seed``.  ``rates`` maps fault kind -> expected events over the
        horizon (kinds absent from the map draw zero events); host faults
        need ``n_hosts``, arm/dispatch faults need ``arms``."""
        rng = np.random.default_rng(seed)
        rates = dict(rates or {})
        faults: List[Fault] = []
        for kind in FAULT_KINDS:                 # fixed draw order: replayable
            lam = rates.get(kind, 0.0)
            if lam <= 0:
                continue
            n = int(rng.poisson(lam))
            for _ in range(n):
                at = float(rng.uniform(0.0, horizon))
                if kind in (HOST_CRASH, HOST_STALL):
                    if n_hosts <= 0:
                        continue
                    faults.append(Fault(
                        at=at, kind=kind,
                        target=int(rng.integers(n_hosts)),
                        duration=crash_duration,
                        magnitude=stall_factor if kind == HOST_STALL
                        else 1.0))
                elif kind == ARM_BLACKOUT:
                    if not arms:
                        continue
                    faults.append(Fault(
                        at=at, kind=kind,
                        target=int(rng.choice(np.asarray(arms))),
                        duration=blackout_steps))
                elif kind == DISPATCH_ERROR:
                    faults.append(Fault(
                        at=at, kind=kind, target=-1,
                        count=int(rng.integers(1, 3))))
                else:                            # ship-wave faults
                    faults.append(Fault(
                        at=at, kind=kind, count=1,
                        magnitude=ship_delay_s))
        return cls(faults, seed=seed)


class FaultInjector:
    """Consumes one :class:`FaultPlan` against the owner's clock.

    ``advance(now)`` fires every fault whose ``at`` has passed: ship-wave
    and dispatch-error faults become *charge pools* the hot paths drain
    (``take_ship_fault`` once per ship wave, ``take_dispatch_error`` once
    per guarded dispatch); all other kinds return to the caller, which
    applies the kind-specific disruption (host churn, arm blackout).

    The injector is single-owner state: all consumption is FIFO and
    clock-ordered, so a given plan against a given request stream injects
    at identical points on every run.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._pending = deque(plan.faults)       # sorted by `at`
        self._ship: deque = deque()              # (kind, magnitude) charges
        self._dispatch: List[List] = []          # [target, site, left]
        self.injected: Dict[str, int] = {}       # fired faults per kind
        self.consumed: Dict[str, int] = {}       # charges actually applied

    # ------------------------------------------------------------- firing
    def advance(self, now: float) -> List[Fault]:
        """Fire all faults due at ``now``.  Returns the fired faults the
        *owner* must apply (host churn, blackouts); charge-style faults are
        absorbed into the injector's pools."""
        fired: List[Fault] = []
        while self._pending and self._pending[0].at <= now:
            f = self._pending.popleft()
            self.injected[f.kind] = self.injected.get(f.kind, 0) + 1
            if f.kind in SHIP_KINDS:
                for _ in range(f.count):
                    self._ship.append((f.kind, f.magnitude))
            elif f.kind == DISPATCH_ERROR:
                self._dispatch.append([f.target, f.site, f.count])
            else:
                fired.append(f)
        return fired

    # ------------------------------------------------------------ charges
    def take_ship_fault(self) -> Optional[Tuple[str, float]]:
        """One ship wave consults once: pops the oldest pending wave fault
        (``(kind, magnitude)``) or None."""
        if not self._ship:
            return None
        kind, mag = self._ship.popleft()
        self.consumed[kind] = self.consumed.get(kind, 0) + 1
        return kind, mag

    def take_dispatch_error(self, arm: int, site: str) -> bool:
        """One guarded dispatch consults once: consumes a matching error
        charge (target -1 matches any arm, site ``*`` matches any site)."""
        for ch in self._dispatch:
            if ch[0] in (-1, arm) and ch[1] in ("*", site):
                ch[2] -= 1
                if ch[2] == 0:
                    self._dispatch.remove(ch)
                self.consumed[DISPATCH_ERROR] = \
                    self.consumed.get(DISPATCH_ERROR, 0) + 1
                return True
        return False

    # ------------------------------------------------------------ metrics
    @property
    def total_injected(self) -> int:
        return sum(self.injected.values())

    def pending(self) -> int:
        return len(self._pending)

    def stats(self) -> dict:
        out = {"faults_injected": self.total_injected}
        out.update({f"fault_{k}": v for k, v in sorted(self.injected.items())})
        return out
