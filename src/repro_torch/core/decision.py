"""SplitDecisionEngine — Figure 2 of the paper.

For workload ``w_t`` of application class ``a`` with deadline ``SLA_w``:
  1. context = bucket(SLA_w / E_a) where E_a is the EMA of layer-split
     execution times for class a,
  2. a per-class contextual MAB picks the arm {layer, semantic},
  3. after the workload completes, the engine observes
     (response_time, sla, accuracy), computes the paper reward, updates the
     MAB, and (for layer-split runs) updates E_a.

Functional over an ``EngineState`` as ``repro.core.decision`` is, in numpy
float32.  UCB needs no random key, so the state carries none.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from repro_torch.core import mab
from repro_torch.core.estimator import EMAState, ema_get, ema_init, ema_update
from repro_torch.core.reward import workload_reward

F32 = np.float32


class EngineState(NamedTuple):
    bandit: mab.UCBState      # per-app stacked state ([n_apps, ...])
    ema: EMAState


class SplitDecisionEngine:
    def __init__(self, n_apps: int, bandit: str = "ucb", n_ctx: int = 8,
                 ema_decay: float = 0.2, ema_init_values=None, **bandit_kw):
        self.n_apps = n_apps
        self.n_ctx = n_ctx
        self.ema_decay = ema_decay
        self.ema_init_values = ema_init_values  # profiled E_a warm start
        self._init, self._select, self._update = mab.bandit_fns(bandit)
        self._bandit_kw = bandit_kw

    def init(self) -> EngineState:
        one = self._init(self.n_ctx, **self._bandit_kw)
        stacked = mab.UCBState(*(np.broadcast_to(
            x, (self.n_apps,) + np.shape(x)).astype(F32) for x in one))
        ema = ema_init(self.n_apps, decay=self.ema_decay)
        if self.ema_init_values is not None:
            ema = ema._replace(value=np.asarray(self.ema_init_values, F32))
        return EngineState(stacked, ema)

    def _app_bandit(self, state: EngineState, app: int) -> mab.UCBState:
        return mab.UCBState(*(x[app] for x in state.bandit))

    def _context(self, state: EngineState, app: int, sla) -> int:
        ea = ema_get(state.ema, app)
        return mab.context_bucket(F32(sla) / np.maximum(ea, F32(1e-6)),
                                  self.n_ctx)

    # ------------------------------------------------------------- decide
    def decide(self, state: EngineState, app: int, sla):
        """Returns (decision, context, state).  decision: 0=layer,
        1=semantic."""
        ctx = self._context(state, app, sla)
        return self._select(self._app_bandit(state, app), ctx), ctx, state

    def decide_many(self, state: EngineState, apps, slas, valid):
        """A wave of decisions, equal to successive ``decide`` calls (UCB
        reads are pure).  Rows with ``valid`` False carry garbage arms the
        caller drops.  Returns (arms [N], ctxs [N], state)."""
        arms, ctxs = [], []
        for app, sla, ok in zip(apps, slas, valid):
            ctx = self._context(state, int(app), sla)
            arms.append(self._select(self._app_bandit(state, int(app)), ctx))
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
        return EngineState(mab.UCBState(*bandit), ema)
