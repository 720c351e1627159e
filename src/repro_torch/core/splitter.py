"""Split construction — maps a decision onto an executable plan, as
``repro.core.splitter`` does.

Two consumers:
  * the edge simulator: fragments with memory/compute demands that the
    placement scheduler bin-packs onto hosts;
  * the runtime: an execution mode string (layer -> ``pipeline``, semantic
    -> ``semantic``, none -> ``fsdp``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

from repro_torch.configs.base import ArchConfig
from repro_torch.core.mab import LAYER

MODES = ("fsdp", "pipeline", "semantic")


@dataclass(frozen=True)
class Fragment:
    index: int
    kind: str              # 'layer' | 'semantic'
    param_bytes: int
    compute_share: float   # fraction of full-model FLOPs
    predecessors: tuple    # fragment indices that must finish first (layer DAG)


def layer_fragments(cfg: ArchConfig, n_fragments: int,
                    bytes_per_param: int = 2) -> List[Fragment]:
    """Contiguous layer groups; sequential chain."""
    total = cfg.param_count() * bytes_per_param
    per = total // n_fragments
    return [Fragment(i, "layer", per, 1.0 / n_fragments,
                     (i - 1,) if i else ())
            for i in range(n_fragments)]


def semantic_fragments(cfg: ArchConfig, n_branches: int,
                       bytes_per_param: int = 2) -> List[Fragment]:
    """Independent branches; parallel (no predecessors).  Block-diagonal
    weights mean total params shrink by ~1/B (SplitNet parameter reduction)."""
    sem = cfg.semantic(n_branches)
    total = sem.param_count() * bytes_per_param
    per = total // n_branches
    return [Fragment(i, "semantic", per, 1.0 / n_branches, ())
            for i in range(n_branches)]


def fragments_for(cfg: ArchConfig, decision: int, n: int) -> List[Fragment]:
    return layer_fragments(cfg, n) if decision == LAYER else \
        semantic_fragments(cfg, n)


def mode_for_decision(decision: int) -> str:
    return "pipeline" if decision == LAYER else "semantic"
