"""Asynchronous-Advantage-Actor-Critic placement scheduler
(``repro.sched.a3c``).

The paper combines its MAB decision layer with the A3C scheduler of
[Tuli et al., TMC'20].  A compact actor-critic: a shared MLP scores each
host from (host state, fragment demands) features; the critic predicts the
expected workload reward.  Updates wait for the workload's completion (the
reward is the paper's per-workload reward): an on-policy advantage update
over the episode's placements, its gradients from torch autograd.

The networks (6 x 32 x 1) live on ``device``, the card unless the caller
passes ``"cpu"``.  ``place`` reads the logits back and masks, softmaxes
and draws on the host, from ``np.random.default_rng(seed)``, as the
reference does.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.reward import workload_reward

N_FEATURES = 6
HIDDEN = 32


class A3CParams(NamedTuple):
    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor
    v1: torch.Tensor
    vb1: torch.Tensor
    v2: torch.Tensor
    vb2: torch.Tensor


def a3c_init(generator: torch.Generator, device="cuda") -> A3CParams:
    """N(0, 0.3^2) weights and zero biases, drawn from ``generator`` on its
    own device and moved to ``device``."""
    def normal(*shape):
        return (torch.randn(shape, generator=generator,
                            device=generator.device) * 0.3).to(device)

    def zeros(n):
        return torch.zeros(n, device=device)
    return A3CParams(normal(N_FEATURES, HIDDEN), zeros(HIDDEN),
                     normal(HIDDEN, 1), zeros(1),
                     normal(N_FEATURES, HIDDEN), zeros(HIDDEN),
                     normal(HIDDEN, 1), zeros(1))


def policy_logits(params: A3CParams, feats: torch.Tensor) -> torch.Tensor:
    """feats: [..., n_hosts, F] -> logits [..., n_hosts]."""
    h = torch.tanh(feats @ params.w1 + params.b1)
    return (h @ params.w2 + params.b2)[..., 0]


def value(params: A3CParams, feats: torch.Tensor) -> torch.Tensor:
    """feats: [..., n_hosts, F] -> the critic's value [...]."""
    h = torch.tanh(feats.mean(-2) @ params.v1 + params.vb1)
    return (h @ params.v2 + params.vb2)[..., 0]


def a3c_update(params: A3CParams, feats, actions, masks, reward: float,
               lr: float = 1e-3, entropy_coef: float = 1e-2) -> A3CParams:
    """One SGD step on the episode's actor-critic loss.  feats: [T, n_hosts,
    F]; actions: [T] int; masks: [T, n_hosts] bool, feasible hosts."""
    leaves = [p.detach().requires_grad_() for p in params]
    with torch.enable_grad():
        p = A3CParams(*leaves)
        logits = policy_logits(p, feats)
        logits = torch.where(masks, logits, torch.full_like(logits, -1e9))
        logp = torch.log_softmax(logits, dim=-1)
        ent = -(logp.exp() * logp).sum(-1)
        v = value(p, feats)
        adv = (reward - v).detach()
        logp_a = logp.gather(-1, actions.long()[:, None])[:, 0]
        loss = (-(logp_a * adv) - entropy_coef * ent
                + (reward - v) ** 2).mean()
        grads = torch.autograd.grad(loss, leaves)
    return A3CParams(*(x.detach() - lr * g for x, g in zip(leaves, grads)))


class A3CPlacement:
    """Stateful wrapper the simulator and the engine's policies call."""

    def __init__(self, n_hosts: int = 10, seed: int = 0, device="cuda"):
        self.device = torch.device(device)
        self.params = a3c_init(torch.Generator().manual_seed(seed),
                               self.device)
        self.rng = np.random.default_rng(seed)
        self.n_hosts = n_hosts
        self._episodes = {}        # wid -> list of (feats, action, mask)

    def _features(self, container, hosts):
        f = np.zeros((len(hosts), N_FEATURES), np.float32)
        for i, h in enumerate(hosts):
            f[i] = [
                (h.ram_mb - h.ram_used_mb) / 8192.0,
                h.n_active / 4.0,
                h.speed,
                container.ram_mb / h.ram_mb,
                container.work,
                float(h.fits(container.ram_mb)),
            ]
        return f

    def place(self, container, hosts):
        feats = self._features(container, hosts)
        mask = np.array([h.fits(container.ram_mb) for h in hosts])
        if not mask.any():
            return None
        with torch.no_grad():
            logits = policy_logits(self.params, torch.from_numpy(feats).to(
                self.device)).cpu().numpy()
        logits[~mask] = -1e9
        p = np.exp(logits - logits.max())
        p /= p.sum()
        a = int(self.rng.choice(len(hosts), p=p))
        self._episodes.setdefault(container.workload.wid, []).append(
            (feats, a, mask))
        return a

    def on_complete(self, w):
        ep = self._episodes.pop(w.wid, None)
        if not ep:
            return
        dev = self.device
        feats = torch.from_numpy(np.stack([e[0] for e in ep])).to(dev)
        actions = torch.tensor([e[1] for e in ep], device=dev)
        masks = torch.from_numpy(np.stack([e[2] for e in ep])).to(dev)
        r = float(workload_reward(w.response_time, w.sla, w.accuracy))
        self.params = a3c_update(self.params, feats, actions, masks, r)
