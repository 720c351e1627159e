"""Network model with Gaussian latency noise — emulates the paper's
*netlimiter* mobility emulation (§IV): inter-host latency jitters every
interval; bandwidth is LAN-class with noise.
"""
from __future__ import annotations

import numpy as np


class Network:
    def __init__(self, n_hosts: int, *, base_latency_s: float = 0.010,
                 latency_sigma: float = 0.5, bandwidth_mbps: float = 100.0,
                 bandwidth_sigma: float = 0.2, seed: int = 0):
        self.n = n_hosts
        self.base_latency = base_latency_s
        self.latency_sigma = latency_sigma
        self.bandwidth_mbps = bandwidth_mbps
        self.bandwidth_sigma = bandwidth_sigma
        self.rng = np.random.default_rng(seed)
        self.resample()

    def resample(self):
        """Called every simulator interval — the Gaussian mobility noise."""
        n = self.n
        lat = self.base_latency * np.abs(
            1.0 + self.latency_sigma * self.rng.standard_normal((n, n)))
        self.latency = (lat + lat.T) / 2
        np.fill_diagonal(self.latency, 0.0)
        bw = self.bandwidth_mbps * np.clip(
            1.0 + self.bandwidth_sigma * self.rng.standard_normal((n, n)),
            0.3, 2.0)
        self.bandwidth = (bw + bw.T) / 2
        np.fill_diagonal(self.bandwidth, np.inf)

    def transfer_time(self, src: int, dst: int, mb: float) -> float:
        if src == dst:
            return 0.0
        return self.latency[src, dst] + mb * 8.0 / self.bandwidth[src, dst]
