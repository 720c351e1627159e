"""Placement policies (host selection) — the default placement of the
engine's policies, copied from ``repro.sched.baselines``."""
from __future__ import annotations


class LeastLoadedPlacement:
    """First-fit-decreasing on CPU load, RAM-feasible."""

    def place(self, container, hosts):
        fitting = [h for h in hosts if h.fits(container.ram_mb)]
        if not fitting:
            return None
        return min(fitting, key=lambda h: (h.n_active, -h.ram_mb
                                           + h.ram_used_mb)).hid
