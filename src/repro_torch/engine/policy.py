"""Policy protocol + adapters — one decision surface over the backends, as
``repro.engine.policy`` defines it:

  decide(request)            -> split mode (LAYER / SEMANTIC / COMPRESSED)
  place(fragment, hosts)     -> host index for one fragment (backends
                                without explicit hosts never call it)
  observe(outcome)           -> feedback after completion

  ``MABPolicy``          — the paper: contextual-MAB ``SplitDecisionEngine``
                           plus a placement policy.
  ``FixedPolicy``        — ablations: always layer / always semantic.
  ``CompressionPolicy``  — the paper's compression baseline.
"""
from __future__ import annotations

from typing import Optional, Protocol, runtime_checkable

import numpy as np

from repro_torch.configs.paper_workloads import WORKLOADS
from repro_torch.core.decision import SplitDecisionEngine
from repro_torch.engine.types import APPS, COMPRESSED, Outcome, Request
from repro_torch.sched.baselines import LeastLoadedPlacement


@runtime_checkable
class Policy(Protocol):
    def decide(self, request: Request) -> int: ...

    def place(self, fragment, hosts) -> Optional[int]: ...

    def observe(self, outcome: Outcome) -> None: ...


class _PlacementMixin:
    """Delegates host selection to a wrapped placement policy."""

    placement = None

    def place(self, fragment, hosts) -> Optional[int]:
        if self.placement is None:
            return None
        return self.placement.place(fragment, hosts)

    def _feedback_placement(self, outcome: Outcome) -> None:
        if self.placement is not None and hasattr(self.placement,
                                                  "on_complete"):
            self.placement.on_complete(outcome)


class MABPolicy(_PlacementMixin):
    """The paper's decision layer as an engine ``Policy``: a per-app
    contextual MAB picks the split arm; completions update it.

    ``ema_init_values="profile"`` warm-starts E_a from the published per-app
    latency profiles; ``None`` uses the engine's default init; a list passes
    through verbatim.  ``seed`` seeds the generator the sampling bandits
    (``thompson``, ``egreedy``) draw from; UCB draws nothing.
    """

    def __init__(self, n_apps: Optional[int] = None, *, bandit: str = "ucb",
                 placement=None, seed: int = 0, n_ctx: int = 6,
                 ema_init_values="profile", **bandit_kw):
        self.n_apps = n_apps or len(APPS)
        if bandit == "ucb":
            bandit_kw.setdefault("c", 0.3)
        if isinstance(ema_init_values, str) and ema_init_values == "profile":
            ema_init_values = ([WORKLOADS[a].base_latency_s * 1.2
                                for a in APPS]
                               if self.n_apps == len(APPS) else None)
        self.engine = SplitDecisionEngine(self.n_apps, bandit=bandit,
                                          n_ctx=n_ctx,
                                          ema_init_values=ema_init_values,
                                          **bandit_kw)
        self.state = self.engine.init(seed)
        self.placement = placement if placement is not None \
            else LeastLoadedPlacement()

    def decide(self, request: Request) -> int:
        arm, ctx, self.state = self.engine.decide(
            self.state, request.app_id, request.sla_s)
        request.ctx = ctx
        return int(arm)

    def decide_batch(self, requests) -> list:
        """Decide a same-tick arrival wave; equal to sequential ``decide``
        calls."""
        apps = np.asarray([r.app_id for r in requests], np.int32)
        slas = np.asarray([r.sla_s for r in requests], np.float32)
        arms, ctxs, self.state = self.engine.decide_many(
            self.state, apps, slas, np.ones(len(requests), bool))
        for r, ctx in zip(requests, ctxs):
            r.ctx = int(ctx)
        return [int(a) for a in arms]

    def observe(self, outcome: Outcome) -> None:
        self.state = self.engine.observe(
            self.state, outcome.request.app_id, outcome.request.ctx,
            outcome.decision, outcome.latency_s, outcome.request.sla_s,
            outcome.accuracy)
        self._feedback_placement(outcome)


class FixedPolicy(_PlacementMixin):
    """Ablation: a constant split decision + any placement policy."""

    def __init__(self, decision: int, placement=None):
        self.decision = decision
        self.placement = placement if placement is not None \
            else LeastLoadedPlacement()

    def decide(self, request: Request) -> int:
        return self.decision

    def observe(self, outcome: Outcome) -> None:
        self._feedback_placement(outcome)


class CompressionPolicy(FixedPolicy):
    """The paper's baseline: low-memory compressed models, no splitting."""

    def __init__(self, placement=None):
        super().__init__(COMPRESSED, placement)
