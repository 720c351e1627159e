"""The paper's reward (§III-B):

    R(W) = sum_w [ 1(ResponseTime_w <= SLA_w) + Accuracy_w ] / (2 |W|)

Per-workload reward is the same expression without the |W| normalization —
it is what the MAB models learn from.  Computed in float32 (the comparison
too), as ``repro.core.reward`` does.
"""
from __future__ import annotations

import numpy as np

F32 = np.float32


def workload_reward(response_time, sla, accuracy):
    met = F32(F32(response_time) <= F32(sla))
    return (met + F32(accuracy)) / F32(2)
