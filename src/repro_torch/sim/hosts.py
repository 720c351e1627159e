"""Edge host models — the paper's testbed: 10 Raspberry-Pi-class devices with
4-8 GB RAM (§IV), linear power models, and shared-CPU container execution.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List


@dataclass
class Host:
    hid: int
    ram_mb: float
    speed: float              # relative compute speed (1.0 = reference RPi)
    power_idle_w: float
    power_peak_w: float
    ram_used_mb: float = 0.0
    containers: list = field(default_factory=list)

    @property
    def n_active(self) -> int:
        return len(self.containers)

    @property
    def utilization(self) -> float:
        return min(1.0, self.n_active / 4.0)  # 4 cores

    def power_w(self) -> float:
        return self.power_idle_w + (self.power_peak_w - self.power_idle_w) \
            * self.utilization

    def fits(self, ram_mb: float) -> bool:
        return self.ram_used_mb + ram_mb <= self.ram_mb


def make_testbed(n: int = 10, seed: int = 0) -> List[Host]:
    """10 RPi-like hosts: half 4 GB, half 8 GB (paper §IV).  Speeds vary
    ±20% to emulate heterogeneity; power 2.7-8.0 W (RPi4 class)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    hosts = []
    for i in range(n):
        ram = 4096.0 if i % 2 == 0 else 8192.0
        speed = float(rng.uniform(0.8, 1.2))
        hosts.append(Host(i, ram, speed, 2.7, 8.0))
    return hosts
