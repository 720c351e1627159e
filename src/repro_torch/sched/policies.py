"""Full schedulers = split-decision policy + placement policy, the port's
copy of ``repro.sched.policies`` for the in-process ``Simulator``.

``SplitPlaceScheduler``     — the paper: MAB decision engine + any placement.
``CompressionScheduler``    — the paper's baseline: model compression
                              (no split) + the same placement policy.
``FixedDecisionScheduler``  — ablation: always layer / always semantic.

The engine is the port's numpy ``SplitDecisionEngine`` with any of its
bandits (``ucb``, ``thompson``, ``egreedy``).  New code should use the backend-agnostic ``repro_torch.engine``
policies.
"""
from __future__ import annotations

from repro_torch.configs.paper_workloads import WORKLOADS
from repro_torch.core.decision import SplitDecisionEngine
from repro_torch.sim.simulator import COMPRESSED
from repro_torch.sim.workloads import APPS


class _PlacementMixin:
    def place(self, container, hosts):
        return self.placement.place(container, hosts)

    def _notify_placement(self, w):
        if hasattr(self.placement, "on_complete"):
            self.placement.on_complete(w)


class SplitPlaceScheduler(_PlacementMixin):
    def __init__(self, placement, *, bandit: str = "ucb", seed: int = 0,
                 n_ctx: int = 6, **bandit_kw):
        self.placement = placement
        if bandit == "ucb":
            bandit_kw.setdefault("c", 0.3)
        # E_a warm start from the published per-app latency profiles
        ema0 = [WORKLOADS[a].base_latency_s * 1.2 for a in APPS]
        self.engine = SplitDecisionEngine(len(APPS), bandit=bandit,
                                          n_ctx=n_ctx, ema_init_values=ema0,
                                          **bandit_kw)
        # ``seed`` seeds the sampling bandits' draws; UCB draws nothing
        self.state = self.engine.init(seed)

    def decide(self, w):
        arm, ctx, self.state = self.engine.decide(self.state, w.app_id,
                                                  w.sla)
        w.ctx = ctx
        return int(arm)

    def observe(self, w):
        self.state = self.engine.observe(
            self.state, w.app_id, w.ctx, w.decision, w.response_time, w.sla,
            w.accuracy)
        self._notify_placement(w)


class CompressionScheduler(_PlacementMixin):
    """Paper baseline: low-memory compressed models, no splitting."""

    def __init__(self, placement):
        self.placement = placement

    def decide(self, w):
        return COMPRESSED

    def observe(self, w):
        self._notify_placement(w)


class FixedDecisionScheduler(_PlacementMixin):
    def __init__(self, placement, decision: int):
        self.placement = placement
        self.decision = decision

    def decide(self, w):
        return self.decision

    def observe(self, w):
        self._notify_placement(w)
