"""Runner API of the training path on one device: one runner per split
mode, as ``repro.dist.api``.

``build_runner(cfg, mode, mesh)`` returns a runner for one of

- ``"fsdp"``      unsplit baseline: the full model.
- ``"semantic"``  the paper's SEMANTIC split: B independent block-diagonal
                  branches (``cfg.semantic(B)``, B = 2 on one device, as
                  ``max(2, model)`` gives on a 1 x 1 mesh), run side by side
                  along a leading branch dim.
- ``"pipeline"``  the paper's LAYER split (``repro_torch.dist.pipeline``):
                  under ``schedule="gspmd"`` the microbatched loss with
                  gradient accumulation; under ``"gpipe"`` / ``"1f1b"`` the
                  explicit stage graph, its tick table walked by one stage.

On one device the three modes are the JAX package's math without its
sharding specs.  Every runner exposes ``init``, ``loss`` and
``value_and_grad``, and the serving surface of the gang path:
``prefill_step``, ``init_cache``, ``supports_batched_prefill``,
``prefill_into_cache`` and ``serve_step`` (``params`` None there: the
runner's own weights).  ``make_train_step`` and ``make_serve_step`` close
over a runner.  Parameter
and gradient trees are nested dicts in the JAX param-tree layout
(``Model.param_tree()``).  A mesh other than 1 x 1 and expert parallelism
raise ``NotImplementedError``: they come with the multi-device training
slice (FSDP over ``torch.distributed``, the stage graph across devices,
all-to-all MoE).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.dist import pipeline as PL
from repro_torch.models.model import build_model
from repro_torch.optim.adamw import adamw_update, tree_leaves

MODES = ("fsdp", "semantic", "pipeline")
_LATER = "is ported with the multi-device training slice"


def parse_mesh(mesh) -> tuple:
    """A (data, model) mesh shape from ``"1,1"`` or a tuple; only 1 x 1
    runs here."""
    dims = tuple(int(x) for x in mesh.split(",")) if isinstance(mesh, str) \
        else tuple(mesh)
    if any(d != 1 for d in dims):
        raise NotImplementedError(f"mesh {dims}: training on several "
                                  f"devices {_LATER}")
    return dims


def tree_unflatten(tree, leaves):
    """A tree shaped like ``tree`` whose leaves, in order, are ``leaves``."""
    it = iter(leaves)

    def rebuild(t):
        if isinstance(t, dict):
            return {k: rebuild(v) for k, v in t.items()}
        return next(it)
    return rebuild(tree)


class BaseRunner:
    """Shared runner plumbing; subclasses fix the loss schedule.  The
    model is built on the meta device (its methods need only its config);
    ``init`` builds the parameters on ``device``."""

    mode: str = ""

    def __init__(self, cfg: ArchConfig, mesh=(1, 1), *, device="cuda"):
        self.mesh = parse_mesh(mesh)
        self.cfg = cfg
        self.device = torch.device(device)
        self.model = build_model(cfg, device="meta")

    # ------------------------------------------------------------ lifecycle
    def init(self, seed: int = 0):
        """Random parameters (the JAX init's distributions, drawn from a
        ``torch.Generator`` seeded with ``seed``) on the runner's device,
        with grad enabled; returns their tree."""
        self.model = build_model(self.cfg, device=self.device)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.model.reset_parameters(gen).requires_grad_(True)
        return self.model.param_tree()

    def loss(self, params, batch, *, remat: bool = False):
        return self.model.loss_chunked(params, batch, remat=remat)

    def value_and_grad(self, params, batch, *, remat: bool = False):
        """(loss, grads): grads is a tree of the params' paths."""
        leaves = tree_leaves(params)
        loss = self.loss(params, batch, remat=remat)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, leaves)]
        return loss.detach(), tree_unflatten(params, grads)

    # -------------------------------------------------------------- serving
    def prefill_step(self, params, batch):
        """Full-prompt forward; returns [B, S, vocab] logits."""
        with torch.no_grad():
            logits, _ = self.model.forward(params, batch)
        return logits

    def init_cache(self, batch_size: int, cache_len: int,
                   window_override: Optional[int] = None):
        """Dense decode caches on the runner's device (after ``init``)."""
        return self.model.init_cache(batch_size, cache_len, window_override)

    @property
    def supports_batched_prefill(self) -> bool:
        """True when the model can prefill its KV cache in one step."""
        return self.model.supports_single_step_prefill

    def prefill_into_cache(self, params, cache, tokens, *,
                           cache_index: int = 0, lengths=None):
        """Whole-prompt prefill into the decode cache.  tokens: [B, S].
        Returns ([B, vocab] last-token logits, cache)."""
        return self.model.prefill_cache(params, cache, tokens,
                                        cache_index=cache_index,
                                        lengths=lengths)

    def serve_step(self, params, cache, batch, cache_index: int, *,
                   window_override: Optional[int] = None):
        """One-token decode; returns ([B, vocab] logits, cache)."""
        logits, cache = self.model.decode_step(
            params, cache, batch["tokens"], cache_index, batch=batch,
            window_override=window_override)
        return logits[:, -1], cache


class FSDPRunner(BaseRunner):
    mode = "fsdp"


class SemanticRunner(BaseRunner):
    """SEMANTIC split: B branches of width d/B run independently; the only
    cross-branch op is the final vocab-shard concat."""

    mode = "semantic"

    def __init__(self, cfg: ArchConfig, mesh=(1, 1), *,
                 n_branches: Optional[int] = None, device="cuda"):
        n_b = n_branches or max(2, parse_mesh(mesh)[-1])
        super().__init__(cfg.semantic(n_b), mesh, device=device)


class PipelineRunner(BaseRunner):
    """LAYER split under one of three schedules:

    - ``"gspmd"``: the microbatched loss, its gradients accumulated a
      microbatch at a time.
    - ``"gpipe"`` / ``"1f1b"``: the explicit stage graph
      (``repro_torch.dist.pipeline``) with its manual remat-style backward;
      ``memory_budget`` caps gpipe's saved microbatches.
    """

    mode = "pipeline"

    def __init__(self, cfg: ArchConfig, mesh=(1, 1), *,
                 n_microbatches: Optional[int] = None,
                 expert_parallel: bool = False, schedule: str = "gspmd",
                 memory_budget: Optional[int] = None, device="cuda"):
        if schedule not in PL.SCHEDULES:
            raise ValueError(
                f"unknown schedule {schedule!r}; expected one of "
                f"{PL.SCHEDULES}")
        if expert_parallel:
            raise NotImplementedError(f"expert parallelism {_LATER}")
        super().__init__(cfg, mesh, device=device)
        self.n_microbatches = n_microbatches
        self.schedule = schedule
        self.memory_budget = memory_budget
        self.n_stages = self.mesh[-1]

    def _resolve(self, batch) -> int:
        return PL.resolve_microbatches(batch["tokens"].shape[0],
                                       self.n_microbatches, self.n_stages)

    def loss(self, params, batch, *, remat: bool = False):
        m = self._resolve(batch)
        if self.schedule != "gspmd":
            return PL.stage_graph_loss(self.model, params, batch, self.mesh,
                                       schedule=self.schedule, n_micro=m)
        return PL.microbatch_loss(self.model, params, batch, m, remat=remat)

    def value_and_grad(self, params, batch, *, remat: bool = False):
        m = self._resolve(batch)
        if self.schedule != "gspmd":
            loss, grads = PL.stage_graph_value_and_grad(
                self.model, params, batch, self.mesh, schedule=self.schedule,
                n_micro=m, remat=remat, memory_budget=self.memory_budget)
            return loss, tree_unflatten(params, grads)
        if m <= 1:
            return super().value_and_grad(params, batch, remat=remat)
        loss, grads = PL.microbatch_value_and_grad(
            self.model, params, tree_leaves(params), batch, m, remat=remat)
        return loss, tree_unflatten(params, grads)

    def schedule_stats(self, batch_size: int, seq_len: int) -> dict:
        """Bubble-fraction / transfer-bytes accounting for one train step of
        the configured schedule (analytic, from the static tick table);
        under ``gspmd`` there is no tick table to report."""
        m = PL.resolve_microbatches(batch_size, self.n_microbatches,
                                    self.n_stages)
        stats = {"mode": self.mode, "schedule": self.schedule,
                 "n_stages": self.n_stages, "n_microbatches": m,
                 "memory_budget": self.memory_budget,
                 "expert_parallel": False}
        if self.schedule == "gspmd":
            return stats
        sched = PL.build_schedule(self.schedule, self.n_stages, m,
                                  memory_budget=self.memory_budget)
        pb = PL.payload_bytes(self.cfg, batch_size // m // self.mesh[0],
                              seq_len)
        stats.update({
            "ticks": sched.ticks,
            "bubble_fraction": round(sched.bubble_fraction, 4),
            "peak_saved_microbatches": sched.peak_saved_microbatches,
            "n_transfers": sched.n_transfers,
            "payload_bytes": pb,
            "transfer_bytes_per_step": sched.n_transfers * pb,
            # the reference's SPMD wire traffic: 2 sends a tick a stage,
            # masked ones included
            "wire_bytes_per_step": 2 * sched.ticks * self.n_stages * pb,
        })
        return stats


def build_runner(cfg: ArchConfig, mode: str, mesh=(1, 1), *,
                 n_microbatches: Optional[int] = None,
                 expert_parallel: bool = False,
                 n_branches: Optional[int] = None,
                 schedule: str = "gspmd",
                 memory_budget: Optional[int] = None, device="cuda"):
    """Construct the runner for one split mode (see the module docstring);
    the arguments are the JAX ``build_runner``'s that apply on one
    device, plus ``device``."""
    if mode == "fsdp":
        return FSDPRunner(cfg, mesh, device=device)
    if mode == "semantic":
        return SemanticRunner(cfg, mesh, n_branches=n_branches, device=device)
    if mode == "pipeline":
        return PipelineRunner(cfg, mesh, n_microbatches=n_microbatches,
                              expert_parallel=expert_parallel,
                              schedule=schedule, memory_budget=memory_budget,
                              device=device)
    raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")


def make_train_step(runner, *, lr: float = 3e-4, remat: bool = False,
                    weight_decay: float = 0.1, clip_norm: float = 1.0):
    """(params, opt, batch) -> (params, opt, loss): grads from
    ``runner.value_and_grad``, then an AdamW step (in place)."""

    def step(params, opt, batch):
        loss, grads = runner.value_and_grad(params, batch, remat=remat)
        params, opt = adamw_update(grads, opt, params, lr=lr,
                                   weight_decay=weight_decay,
                                   clip_norm=clip_norm)
        return params, opt, loss

    return step


def make_serve_step(runner, *, window_override: Optional[int] = None):
    """(params, cache, batch, cache_index) -> (logits, cache)."""

    def step(params, cache, batch, cache_index):
        return runner.serve_step(params, cache, batch, cache_index,
                                 window_override=window_override)

    return step
