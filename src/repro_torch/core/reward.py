"""The paper's reward (§III-B):

    R(W) = sum_w [ 1(ResponseTime_w <= SLA_w) + Accuracy_w ] / (2 |W|)

Per-workload reward is the same expression without the |W| normalization —
it is what the MAB models learn from.  Computed in float32 (the comparison
too), as ``repro.core.reward`` does on the decision engine's path.
"""
from __future__ import annotations

import numpy as np

F32 = np.float32


def met_reward(met, accuracy):
    """The reward of workloads whose SLA test ``met`` was already made:
    ``(met + accuracy) / 2`` in float32, elementwise over arrays."""
    return (F32(met) + F32(accuracy)) / F32(2)


def workload_reward(response_time, sla, accuracy):
    return met_reward(F32(response_time) <= F32(sla), accuracy)


def batch_reward(response_times, slas, accuracies):
    return F32(np.mean(workload_reward(np.asarray(response_times),
                                       np.asarray(slas),
                                       np.asarray(accuracies))))
