"""Placement policies (host selection), copied from
``repro.sched.baselines``: random, round-robin and least-loaded, with the
least-loaded policy's vectorized ``place_arrays`` fast path."""
from __future__ import annotations

import numpy as np


class RandomPlacement:
    def __init__(self, seed: int = 0):
        self.rng = np.random.default_rng(seed)

    def place(self, container, hosts):
        fitting = [h.hid for h in hosts if h.fits(container.ram_mb)]
        if not fitting:
            return None
        return int(self.rng.choice(fitting))


class RoundRobinPlacement:
    def __init__(self):
        self._i = 0

    def place(self, container, hosts):
        n = len(hosts)
        for k in range(n):
            h = hosts[(self._i + k) % n]
            if h.fits(container.ram_mb):
                self._i = (self._i + k + 1) % n
                return h.hid
        return None


class LeastLoadedPlacement:
    """First-fit-decreasing on CPU load, RAM-feasible."""

    def place(self, container, hosts):
        fitting = [h for h in hosts if h.fits(container.ram_mb)]
        if not fitting:
            return None
        return min(fitting, key=lambda h: (h.n_active, -h.ram_mb
                                           + h.ram_used_mb)).hid

    def place_arrays(self, ram_mb, ram_free, n_active, speed):
        """Vectorized fast path over host state arrays (same ordering as
        ``place``); used by scaled backends with thousands of hosts."""
        feasible = np.nonzero(ram_free >= ram_mb)[0]
        if feasible.size == 0:
            return None
        order = np.lexsort((-ram_free[feasible], n_active[feasible]))
        return int(feasible[order[0]])
