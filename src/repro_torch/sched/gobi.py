"""GOBI-style gradient-based placement (``repro.sched.gobi``; Tuli et al.,
COSCO TPDS'21, the paper's reference [9]).

A differentiable surrogate scores a soft placement: estimated response time
(queue depth / speed) + energy + RAM-pressure penalty; a few gradient steps
on the host logits, their gradients from torch autograd, pick the
placement.  The steps run on ``device``, the card unless the caller passes
``"cpu"``; the pick is made on a numpy copy of the logits.
"""
from __future__ import annotations

import numpy as np
import torch


def _surrogate(logits, feats, work, ram_frac):
    """Soft placement score (lower = better).

    feats columns: [load (n_active/4), 1/speed, ram_free_frac, fits].
    """
    p = torch.softmax(logits, dim=-1)
    load, inv_speed, ram_free, fits = feats.unbind(-1)
    # expected response: work x (1 + load) / speed on the chosen host
    resp = (p * work * (1.0 + load) * inv_speed).sum()
    energy = (p * (1.0 + load)).sum()          # utilization proxy
    ram_pen = (p * (ram_frac - ram_free).clamp_min(0.0)).sum() * 10.0
    infeasible = (p * (1.0 - fits)).sum() * 100.0
    return resp + 0.1 * energy + ram_pen + infeasible


def _grad(logits, feats, work, ram_frac):
    """d _surrogate / d logits."""
    x = logits.detach().requires_grad_()
    with torch.enable_grad():
        return torch.autograd.grad(_surrogate(x, feats, work, ram_frac),
                                   x)[0]


class GOBIPlacement:
    def __init__(self, n_steps: int = 10, lr: float = 1.0, seed: int = 0,
                 device="cuda"):
        self.n_steps = n_steps
        self.lr = lr
        self.rng = np.random.default_rng(seed)
        self.device = torch.device(device)

    def place(self, container, hosts):
        fits = np.array([h.fits(container.ram_mb) for h in hosts])
        if not fits.any():
            return None
        feats = np.zeros((len(hosts), 4), np.float32)
        for i, h in enumerate(hosts):
            feats[i] = [h.n_active / 4.0, 1.0 / h.speed,
                        (h.ram_mb - h.ram_used_mb) / h.ram_mb, float(fits[i])]
        dev = self.device
        logits = torch.zeros(len(hosts), device=dev)
        feats_t = torch.from_numpy(feats).to(dev)
        work = torch.tensor(container.work, dtype=torch.float32, device=dev)
        ram_frac = torch.tensor(container.ram_mb / 8192.0,
                                dtype=torch.float32, device=dev)
        for _ in range(self.n_steps):
            logits = logits - self.lr * _grad(logits, feats_t, work, ram_frac)
        order = np.argsort(-logits.cpu().numpy())
        for h in order:
            if fits[h]:
                return int(h)
        return None
