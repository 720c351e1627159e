"""Contextual multi-armed bandits — the paper's decision layer (§III-B).

Per application class a MAB estimates the expected reward of each split
decision {layer, semantic} given the context bucket of ``SLA / E_a``.  This
is ``repro.core.mab`` in numpy float32, with the same arithmetic order.

UCB1 is deterministic, so its decisions and contexts equal the JAX
package's (XLA may fuse a multiply-add where numpy rounds twice: float
state can differ in the last ulp, which moves a decision only for a ratio
within an ulp of an edge).  Thompson sampling and epsilon-greedy draw from
an explicit ``numpy.random.Generator`` where the reference splits a JAX
key: their draws follow the reference's distributions, not its bits, and
their updates are exact.  Every ``select`` takes the generator; UCB draws
nothing from it.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

N_ARMS = 2          # 0 = layer split, 1 = semantic split
LAYER, SEMANTIC = 0, 1
F32 = np.float32


def _geomspace_f32(start: float, stop: float, num: int) -> np.ndarray:
    """``jnp.geomspace`` in float32: ``10 ** linspace`` of the log10 ends,
    where linspace is ``start*(1-s) + stop*s`` with ``s = iota/div`` and
    the end point appended (equal to jnp's to the last ulp)."""
    lo, hi = np.log10(F32(start)), np.log10(F32(stop))
    div = num - 1
    s = (np.arange(div, dtype=F32) / F32(div)).astype(F32)
    lin = np.concatenate([lo * (F32(1) - s) + hi * s, [hi]]).astype(F32)
    return np.power(F32(10), lin).astype(F32)


def context_edges(n_ctx: int) -> np.ndarray:
    return np.concatenate([np.zeros(1, F32),
                           _geomspace_f32(0.25, 4.0, n_ctx - 1)])


def context_bucket(sla_ratio, n_ctx: int) -> int:
    """Bucket SLA/E_a into n_ctx bins on a log-ish scale around 1.0."""
    i = int(np.searchsorted(context_edges(n_ctx), F32(sla_ratio))) - 1
    return min(max(i, 0), n_ctx - 1)


class UCBState(NamedTuple):
    counts: np.ndarray   # [..., n_ctx, N_ARMS] f32
    means: np.ndarray    # [..., n_ctx, N_ARMS] f32
    t: np.ndarray        # [...] step counter
    c: np.ndarray        # [...] exploration coefficient


def ucb_init(n_ctx: int = 8, c: float = 1.0) -> UCBState:
    return UCBState(np.zeros((n_ctx, N_ARMS), F32),
                    np.zeros((n_ctx, N_ARMS), F32), F32(0), F32(c))


def ucb_select(state: UCBState, ctx: int, rng=None) -> int:
    n = state.counts[ctx]
    with np.errstate(divide="ignore"):
        bonus = state.c * np.sqrt(np.log(state.t + F32(1))
                                  / np.maximum(n, F32(1e-9)))
    score = np.where(n == 0, F32(np.inf), state.means[ctx] + bonus)
    return int(np.argmax(score))


def ucb_update(state: UCBState, ctx: int, arm: int, reward) -> UCBState:
    counts, means = state.counts.copy(), state.means.copy()
    n = counts[ctx, arm] + F32(1)
    means[ctx, arm] = means[ctx, arm] + (F32(reward) - means[ctx, arm]) / n
    counts[ctx, arm] = n
    return UCBState(counts, means, F32(state.t + F32(1)), state.c)


# ----------------------------------------------------------------- Thompson
class TSState(NamedTuple):
    alpha: np.ndarray    # [..., n_ctx, N_ARMS] f32
    beta: np.ndarray     # [..., n_ctx, N_ARMS] f32


def ts_init(n_ctx: int = 8, prior: float = 1.0) -> TSState:
    return TSState(np.full((n_ctx, N_ARMS), prior, F32),
                   np.full((n_ctx, N_ARMS), prior, F32))


def ts_select(state: TSState, ctx: int, rng: np.random.Generator) -> int:
    """One Beta(alpha, beta) draw per arm; the arm with the largest."""
    samples = rng.beta(state.alpha[ctx], state.beta[ctx])
    return int(np.argmax(samples))


def ts_update(state: TSState, ctx: int, arm: int, reward) -> TSState:
    """Fractional Beta update: reward in [0, 1] counted as success mass."""
    r = np.clip(F32(reward), F32(0), F32(1))
    alpha, beta = state.alpha.copy(), state.beta.copy()
    alpha[ctx, arm] += r
    beta[ctx, arm] += F32(1) - r
    return TSState(alpha, beta)


# ----------------------------------------------------------------- e-greedy
class EGState(NamedTuple):
    counts: np.ndarray   # [..., n_ctx, N_ARMS] f32
    means: np.ndarray    # [..., n_ctx, N_ARMS] f32
    eps: np.ndarray      # [...] exploration probability


def eg_init(n_ctx: int = 8, eps: float = 0.1) -> EGState:
    return EGState(np.zeros((n_ctx, N_ARMS), F32),
                   np.zeros((n_ctx, N_ARMS), F32), F32(eps))


def eg_select(state: EGState, ctx: int, rng: np.random.Generator) -> int:
    """With probability eps a uniform arm, else the greedy one (an unseen
    arm first).  Both draws are taken every call, as the reference splits
    its key into both every call."""
    greedy = int(np.argmax(np.where(state.counts[ctx] == 0, F32(np.inf),
                                    state.means[ctx])))
    explore = rng.random() < state.eps
    rand = int(rng.integers(0, N_ARMS))
    return rand if explore else greedy


def eg_update(state: EGState, ctx: int, arm: int, reward) -> EGState:
    counts, means = state.counts.copy(), state.means.copy()
    n = counts[ctx, arm] + F32(1)
    means[ctx, arm] = means[ctx, arm] + (F32(reward) - means[ctx, arm]) / n
    counts[ctx, arm] = n
    return EGState(counts, means, state.eps)


BANDITS = {
    "ucb": (ucb_init, ucb_select, ucb_update),
    "thompson": (ts_init, ts_select, ts_update),
    "egreedy": (eg_init, eg_select, eg_update),
}


def bandit_fns(name: str):
    """(init, select, update) of a bandit by name."""
    if name not in BANDITS:
        raise ValueError(f"unknown bandit {name!r}; expected one of "
                         f"{sorted(BANDITS)}")
    return BANDITS[name]
