"""Moving-average execution-time estimators (paper §III-B: ``E_a``), in
numpy float32 as ``repro.core.estimator`` computes them.

Per application class ``a`` an exponential moving average tracks the
observed execution time of layer-split deployments; the decision context is
``SLA_w / E_a``.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

F32 = np.float32


class EMAState(NamedTuple):
    value: np.ndarray    # [n_apps] current estimate
    count: np.ndarray    # [n_apps] observation counts
    decay: np.ndarray    # scalar


def ema_init(n_apps: int, init_value: float = 1.0,
             decay: float = 0.2) -> EMAState:
    return EMAState(np.full((n_apps,), init_value, F32),
                    np.zeros((n_apps,), F32), F32(decay))


def ema_update(state: EMAState, app: int, obs) -> EMAState:
    """First observation snaps to obs; later ones blend with decay."""
    obs = F32(obs)
    cur = state.value[app]
    new = obs if state.count[app] == 0 \
        else (F32(1) - state.decay) * cur + state.decay * obs
    value, count = state.value.copy(), state.count.copy()
    value[app] = new
    count[app] += F32(1)
    return EMAState(value, count, state.decay)


def ema_get(state: EMAState, app: int):
    return state.value[app]
