"""SplitDecisionEngine — Figure 2 of the paper.

For workload ``w_t`` of application class ``a`` with deadline ``SLA_w``:
  1. context = bucket(SLA_w / E_a) where E_a is the EMA of layer-split
     execution times for class a,
  2. a per-class contextual MAB picks the arm {layer, semantic},
  3. after the workload completes, the engine observes
     (response_time, sla, accuracy), computes the paper reward, updates the
     MAB, and (for layer-split runs) updates E_a.

Functional over an ``EngineState`` as ``repro.core.decision`` is, in numpy
float32.  Where the reference carries a JAX key and splits it once per
decision, the state carries a ``numpy.random.Generator`` seeded from the
engine's seed, which the sampling bandits draw from (in place) once per
decision; UCB draws nothing.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from repro_torch.core import mab
from repro_torch.core.estimator import EMAState, ema_get, ema_init, ema_update
from repro_torch.core.reward import workload_reward

F32 = np.float32


class EngineState(NamedTuple):
    bandit: tuple             # per-app stacked bandit state ([n_apps, ...])
    ema: EMAState
    rng: np.random.Generator  # the sampling bandits' draws


class SplitDecisionEngine:
    def __init__(self, n_apps: int, bandit: str = "ucb", n_ctx: int = 8,
                 ema_decay: float = 0.2, ema_init_values=None, **bandit_kw):
        self.n_apps = n_apps
        self.n_ctx = n_ctx
        self.ema_decay = ema_decay
        self.ema_init_values = ema_init_values  # profiled E_a warm start
        self._init, self._select, self._update = mab.bandit_fns(bandit)
        self._bandit_kw = bandit_kw

    def init(self, seed: int = 0) -> EngineState:
        one = self._init(self.n_ctx, **self._bandit_kw)
        stacked = type(one)(*(np.broadcast_to(
            x, (self.n_apps,) + np.shape(x)).astype(F32) for x in one))
        ema = ema_init(self.n_apps, decay=self.ema_decay)
        if self.ema_init_values is not None:
            ema = ema._replace(value=np.asarray(self.ema_init_values, F32))
        return EngineState(stacked, ema, np.random.default_rng(seed))

    def _app_bandit(self, state: EngineState, app: int):
        return type(state.bandit)(*(x[app] for x in state.bandit))

    def _context(self, state: EngineState, app: int, sla) -> int:
        ea = ema_get(state.ema, app)
        return mab.context_bucket(F32(sla) / np.maximum(ea, F32(1e-6)),
                                  self.n_ctx)

    # ------------------------------------------------------------- decide
    def decide(self, state: EngineState, app: int, sla):
        """Returns (decision, context, state).  decision: 0=layer,
        1=semantic."""
        ctx = self._context(state, app, sla)
        arm = self._select(self._app_bandit(state, app), ctx, state.rng)
        return arm, ctx, state

    def decide_many(self, state: EngineState, apps, slas, valid):
        """A wave of decisions, equal to successive ``decide`` calls: one
        select (and so one draw) per real row, in order.  Rows with
        ``valid`` False draw nothing, as the reference's padded steps leave
        its key untouched, and carry arm 0, which the caller drops.
        Returns (arms [N], ctxs [N], state)."""
        arms, ctxs = [], []
        for app, sla, ok in zip(apps, slas, valid):
            ctx = self._context(state, int(app), sla)
            arms.append(self._select(self._app_bandit(state, int(app)), ctx,
                                     state.rng) if ok else 0)
            ctxs.append(ctx)
        return np.asarray(arms), np.asarray(ctxs), state

    # ------------------------------------------------------------- observe
    def observe(self, state: EngineState, app: int, ctx: int, arm: int,
                response_time, sla, accuracy) -> EngineState:
        r = workload_reward(response_time, sla, accuracy)
        new = self._update(self._app_bandit(state, app), ctx, arm, r)
        bandit = []
        for full, leaf in zip(state.bandit, new):
            full = full.copy()
            full[app] = leaf
            bandit.append(full)
        # E_a tracks LAYER-split execution times only (paper §III-B)
        ema = ema_update(state.ema, app, response_time) \
            if arm == mab.LAYER else state.ema
        return EngineState(type(state.bandit)(*bandit), ema, state.rng)
