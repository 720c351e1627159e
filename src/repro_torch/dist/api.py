"""Runner API of the training path: one runner per split mode, as
``repro.dist.api``, on one device or on a mesh of ranks.

``build_runner(cfg, mode, mesh)`` returns a runner for one of

- ``"fsdp"``      unsplit baseline: the full model, ZeRO-3 param layout.
- ``"semantic"``  the paper's SEMANTIC split: B independent block-diagonal
                  branches (``cfg.semantic(B)``, B = ``max(2, model)`` by
                  default), branch dim on 'model'.
- ``"pipeline"``  the paper's LAYER split (``repro_torch.dist.pipeline``):
                  under ``schedule="gspmd"`` the microbatched loss; under
                  ``"gpipe"`` / ``"1f1b"`` the explicit stage graph, with
                  ``expert_parallel`` the expert-parallel substrate.

``mesh`` is a ``repro_torch.launch.mesh`` mesh (or a ``"D,M"`` string or
tuple naming one).  On a 1 x 1 mesh a runner holds whole leaves and runs
no collective.  On a :class:`~repro_torch.launch.mesh.Mesh` of several
ranks each rank stores only its slice of every leaf, as ``param_specs``
(the reference's specs) assign it, and AdamW moments to match:

- fsdp and gspmd gather each leaf's slices on use: a superblock's leaves
  inside its body (so remat's recompute gathers them again), embed and
  norms when the loss starts, by ``dist.comm``'s differentiable all-gather
  (a broadcast where an axis splits the superblock stack), so autograd
  reduce-scatters each gradient back to its slice; they split the batch
  over 'data';
- semantic ranks hold and run their own branches, gathering only the
  'data' slices; the branches' logit shards meet in one all-gather;
- the explicit schedules run one stage a rank, sending activations and
  cotangents point to point; the expert-parallel substrate exchanges tokens
  with all-to-alls.

Gradients are those of the mean loss over 'data'.  Ranks on one 'model'
slice compute the same loss (fsdp, gspmd, semantic, expert parallel), so a
gradient that collectives summed over 'model' is divided by its size, and
one of a leaf 'data' does not split is averaged over 'data'.

Every runner exposes ``init``, ``loss``, ``value_and_grad``,
``param_specs``, ``cache_specs`` and the serving surface (``prefill_step``,
``init_cache``, ``supports_batched_prefill``, ``prefill_into_cache``,
``serve_step``).  On one device it is the gang path's (``params`` None
there: the runner's own weights).  On a mesh every rank passes the whole
batch and its own cache slices (what ``init_cache`` returns, under
``cache_specs``) and gets the reference's global logits:

- fsdp gathers weights on use, splits the rows over 'data' where they
  divide and all-gathers the logits;
- semantic ranks run their own branches over their cache slices, the
  branches' logit shards meeting in one all-gather;
- the pipeline runner, where 'model' splits the superblock stack, runs a
  stage a rank over its cache slice, sends the activation on with
  ``comm.exchange`` and broadcasts the last stage's logits; an enc-dec
  model's encoder runs first as a chain of stages of its own, its output
  broadcast to every stage for its decoder superblocks' cross-attention;
- under ``shard_cache_len`` the cache length splits over 'data' and every
  attention layer runs flash-decoding (``models.layers``), each rank over
  its slab of every row.

The paged surface (``paged_model``, ``init_pool``) serves
``decode.scheduler.PagedArmScheduler`` on a mesh: a model-like view
(:class:`PagedView`) whose params are this rank's slices of the arm's
current params and whose pool is this rank's slice of the paged pool,
laid out as ``cache_specs`` lays out the dense cache with the
physical-block dim in place of the batch dim (``sharding.pool_specs``):

- a LAYER stage holds its superblocks' pool; stage 0 embeds, each stage
  runs its superblocks and sends the activation on with
  ``comm.exchange``, and the last stage broadcasts the greedy tokens [B]
  int32;
- a SEMANTIC rank holds its branches' pool and runs them end to end;
  each rank offers its branches' (largest logit, its first index) per
  lane and one all-gather picks the token of the merged vocab;
- 'data' splits neither the pool nor the lanes: the physical-block dim
  is not split (a lane's table may point at any block, and prefix sharing
  aliases blocks across lanes), so each 'data' rank holds the whole pool
  of its model slice and runs the whole wave, which is exact, needs no
  collective and gains nothing from 'data' (splitting lanes over replicas
  is a fleet's job); fsdp (COMPRESSED) gathers its weights on use, as its
  gang path does.

Only tokens cross ranks in the paged decode loop (and, between stages,
the activation).

A disaggregated worker may instead be pinned whole to one rank (the
reference's ``fleet_devices``, each entry a rank's device): that rank
holds the arm's whole model and whole pool (its join a
:class:`PinnedJoin`), and every other rank holds a :class:`RemoteView`
of it, shapes on the meta device and no weights.  Rank 0's remote view
relays each call and receives the outputs it reads point to point.

Parameter and gradient trees are nested dicts in the JAX param-tree
layout.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.decode import paged_model as PM
from repro_torch.dist import comm
from repro_torch.dist.comm import reduce_grads, replicated_mean
from repro_torch.dist import pipeline as PL
from repro_torch.dist import sharding as SH
from repro_torch.dist.sharding import (  # noqa: F401  (public API re-exports)
    batch_specs,
    make_opt_specs,
    pod_shard_opt_specs,
)
from repro_torch.launch import mesh as M
from repro_torch.models import layers as L
from repro_torch.models import model as MM
from repro_torch.models import transformer as T
from repro_torch.models.model import build_model
from repro_torch.models.moe import RowSplit
from repro_torch.optim.adamw import adamw_update, tree_leaves

MODES = ("fsdp", "semantic", "pipeline")


def tree_unflatten(tree, leaves):
    """A tree shaped like ``tree`` whose leaves, in order, are ``leaves``."""
    it = iter(leaves)

    def rebuild(t):
        if isinstance(t, dict):
            return {k: rebuild(v) for k, v in t.items()}
        return next(it)
    return rebuild(tree)


class BaseRunner:
    """Shared runner plumbing; subclasses fix the layout and the loss
    schedule.  The model is built on the meta device (its methods need only
    its config); ``init`` builds the parameters on ``device``."""

    mode: str = ""
    #: leading cache dim (superblock stack / branch) placed on 'model'
    _cache_model_leading = False
    #: mesh axes whose slices a rank runs as they are (not gathered)
    _owned_axes: tuple = ()

    def __init__(self, cfg: ArchConfig, mesh=(1, 1), *, device="cuda",
                 shard_cache_len: bool = False, zero_data: bool = True):
        self.mesh = M.resolve(mesh)
        self.cfg = cfg
        self.device = torch.device(device)
        self.model = build_model(cfg, device="meta")
        self.shard_cache_len = shard_cache_len
        self.zero_data = zero_data
        self.specs = None

    @property
    def distributed(self) -> bool:
        return self.mesh.distributed

    def _check_world(self) -> None:
        if self.mesh.size > 1 and not self.mesh.distributed:
            raise ValueError(
                f"mesh {self.mesh.dims} is larger than the world (1 rank): "
                "build it with launch.mesh.init_mesh")

    # ------------------------------------------------------------ lifecycle
    def init(self, seed: int = 0):
        """Random parameters (the JAX init's distributions, drawn from a
        ``torch.Generator`` seeded with ``seed``) on the runner's device,
        with grad enabled; returns their tree.  On a mesh every rank draws
        the same weights and keeps its slice of each leaf.  On the meta
        device (the dry run) nothing is drawn: the leaves are shapes, and a
        rank's slices and specs come as they do from a draw."""
        self._check_world()
        self.model = build_model(self.cfg, device=self.device)
        if self.device.type != "meta":
            gen = torch.Generator(device=self.device).manual_seed(seed)
            self.model.reset_parameters(gen)
        if not self.distributed:
            self.model.requires_grad_(True)
            return self.model.param_tree()
        local = self.shard(self.model.param_tree())
        self.model = build_model(self.cfg, device="meta")
        return local

    def shard(self, tree):
        """This rank's slice of a whole tree under ``param_specs`` (copies,
        with grad enabled); records the specs."""
        self._check_world()
        self.specs = self.param_specs(tree)
        sizes = dict(self.mesh.shape)
        return SH.tree_map(lambda t, s: SH.shard_leaf(
            t.detach(), s, sizes, self.mesh.coords).clone()
            .requires_grad_(True), tree, self.specs)

    def local_batch(self, batch):
        """This rank's rows of a global batch: the leading dim split over
        'data' where ``batch_specs`` splits it."""
        if not self.distributed:
            return batch
        specs = batch_specs(self.cfg, self.mesh, batch)
        sizes = dict(self.mesh.shape)
        return {k: SH.shard_leaf(v, specs[k], sizes, self.mesh.coords)
                for k, v in batch.items()}

    def _on_use(self, params):
        """The model's view of this rank's slices, each leaf gathered
        (apart from the owned axes' slices) by differentiable collectives,
        so that autograd reduce-scatters its gradient back to the slice:
        the superblock stacks a superblock at a time, inside its body (so
        inside remat's checkpoint, whose recompute gathers it again), the
        other leaves when the loss starts."""
        if not self.distributed:
            return params
        whole = self.model.param_tree()     # on the meta device
        sd = len(self.model._lead)          # a stack leaf's superblock dim
        out = {}
        for k, sub in params.items():
            if k not in ("blocks", "enc_blocks"):
                out[k] = SH.tree_map(self._gather_leaf, sub, self.specs[k])
                continue
            n = tree_leaves(whole[k])[0].shape[sd]
            out[k] = T.StackOnUse(n, lambda i, sub=sub, specs=self.specs[k]:
                                  SH.tree_map(lambda t, s: self._fetch(
                                      t, s, sd, i), sub, specs))
        return out

    def _gather_leaf(self, t, spec):
        for d, e in enumerate(spec):
            if e is not None and e not in self._owned_axes:
                t = comm.all_gather(t, d, self.mesh.group(e))
        return t

    def _fetch(self, t, spec, sd: int, i: int):
        """Superblock ``i`` of a stack leaf's slices (dim ``sd``), whole
        apart from the owned axes.  Where an axis splits the stack,
        superblock ``i`` lies on one of its ranks, which broadcasts it."""
        spec = tuple(spec) + (None,) * (t.dim() - len(spec))
        e, n_local = spec[sd], t.shape[sd]
        if e is None:
            x = t.select(sd, i)
        else:
            x = comm.broadcast(t.select(sd, i % n_local), i // n_local,
                               self.mesh.group(e))
        return self._gather_leaf(x, spec[:sd] + spec[sd + 1:])

    def _n_micro(self, batch) -> int:
        return 1

    def _row_split(self, aux: bool = False) -> RowSplit:
        """The MoE's handle on the 'data' axis that splits the rows of a
        call (:class:`~repro_torch.models.moe.RowSplit`), so that capacity
        and drops are the whole batch's, as the reference's GSPMD sizes
        them; with ``aux`` (a loss) it also sums the load-balance term's
        means over the axis, which the serving calls drop."""
        group = self.mesh.group("data")
        return RowSplit(self.mesh.coords["data"], self.mesh.axis_size("data"),
                        lambda t: comm.all_gather_dim(t, 0, group),
                        (lambda t: comm.all_reduce(t, group)) if aux
                        else None)

    def _batch_rows(self, batch) -> Optional[RowSplit]:
        """The row split of a training batch whose rows ``local_batch``
        splits over 'data' (``batch_specs``: where they divide), or
        None."""
        n = self.mesh.axis_size("data")
        if not self.distributed or n == 1 or batch["tokens"].shape[0] % n:
            return None
        return self._row_split(aux=True)

    def _local_loss(self, params, batch, *, remat: bool, n_micro: int = 1,
                    rows: Optional[RowSplit] = None):
        return self.model.loss_chunked(params, batch, remat=remat, rows=rows)

    def loss(self, params, batch, *, remat: bool = False):
        m = self._n_micro(batch)
        if not self.distributed:
            return self._local_loss(params, batch, remat=remat, n_micro=m)
        with torch.no_grad():
            loss = self._local_loss(self._on_use(params),
                                    self.local_batch(batch), remat=False,
                                    n_micro=m, rows=self._batch_rows(batch))
        return replicated_mean(loss, self.mesh)

    def value_and_grad(self, params, batch, *, remat: bool = False):
        """(loss, grads): grads is a tree of the params' paths (on a mesh,
        of this rank's slices), accumulated a microbatch at a time."""
        rows = self._batch_rows(batch)
        loss, grads = PL.microbatch_value_and_grad(
            self.model, params, tree_leaves(params), self.local_batch(batch),
            self._n_micro(batch), remat=remat,
            loss_fn=lambda p, b: self._local_loss(self._on_use(p), b,
                                                  remat=remat, rows=rows))
        if self.distributed:
            grads = reduce_grads(grads, self.specs, self.mesh)
            loss = replicated_mean(loss, self.mesh)
        return loss, tree_unflatten(params, grads)

    # -------------------------------------------------------------- serving
    # On one device these are the gang path's dense-cache surface (params
    # None: the runner's own weights).  On a mesh of ranks every rank calls
    # each of them with the whole batch and its own cache slices (what
    # ``init_cache`` returns), and every rank gets the global logits.
    @property
    def _cache_axis(self) -> Optional[L.CacheAxis]:
        """This rank's slab of a cache whose length is split over 'data'
        (flash-decoding under ``shard_cache_len``) and the merge of the
        slabs' partials over that axis, or None."""
        if self.shard_cache_len and self.distributed \
                and self.mesh.axis_size("data") > 1:
            return L.CacheAxis(
                self.mesh.coords["data"], self.mesh.axis_size("data"),
                functools.partial(comm.merge_lse,
                                  group=self.mesh.group("data")))
        return None

    def _split_rows(self, b: int) -> bool:
        """True when a serving batch of ``b`` rows splits over 'data' (as
        ``batch_specs`` and ``cache_specs`` split it; never under
        ``shard_cache_len``, whose 'data' ranks hold slabs of the same
        rows)."""
        n = self.mesh.axis_size("data")
        return self.distributed and not self.shard_cache_len and n > 1 \
            and b % n == 0

    def _rows(self, t):
        """This rank's rows of ``t`` (a tensor, or a batch dict) when the
        batch splits over 'data'."""
        if isinstance(t, dict):
            return BaseRunner.local_batch(self, t)
        n, i = self.mesh.axis_size("data"), self.mesh.coords["data"]
        return t.chunk(n, 0)[i]

    def _join_rows(self, logits, b: int):
        if self._split_rows(b):
            return comm.all_gather_dim(logits, 0, self.mesh.group("data"))
        return logits

    def _branch_gather(self):
        """The join of other ranks' branch logits (semantic), or None."""
        return None

    def _audio(self, batch):
        """An enc-dec batch's frame embeddings, read before any collective
        of a call on a mesh, so that a batch without them raises
        ``KeyError`` on every rank alike (as the reference's model does);
        None for other configs."""
        return batch["audio_embeds"] if self.cfg.is_encdec else None

    def prefill_step(self, params, batch):
        """Full-prompt forward; returns [B, S, vocab] logits."""
        with torch.no_grad():
            if not self.distributed:
                return self.model.forward(params, batch)[0]
            self._audio(batch)
            b = batch["tokens"].shape[0]
            if not self._split_rows(b):
                return self._forward_logits(params, batch)
            return self._join_rows(self._forward_logits(
                params, self._rows(batch), rows=self._row_split()), b)

    def _forward_logits(self, params, batch, rows: Optional[RowSplit] = None):
        return self.model.forward(self._on_use(params), batch, rows=rows)[0]

    def init_cache(self, batch_size: int, cache_len: int,
                   window_override: Optional[int] = None):
        """Dense decode caches on the runner's device (after ``init``); on
        a mesh, this rank's slices of them under ``cache_specs``, laid out
        in memory as the whole caches are (superblock-major), each filled
        as the model's own cache starts.  Where the rows split over 'data',
        recurrent state stays whole on every rank, as ``cache_specs``
        replicates it (see :meth:`_row_state`)."""
        if not self.distributed:
            return self.model.init_cache(batch_size, cache_len,
                                         window_override)
        meta = build_model(self.cfg, device="meta")
        whole = meta.init_cache(batch_size, cache_len, window_override)
        # every leaf starts constant (zeros; the mLSTM's stabiliser at its
        # floor): read each one's value off a one-row, one-slot cache
        start = meta.init_cache(1, 1, window_override, device="cpu")
        specs = self.cache_specs(whole)
        sizes = dict(self.mesh.shape)

        def local(path, leaf):
            spec, fill = specs, start
            for k in path:
                spec, fill = spec[k], fill[k]
            attn = SH._leaf_key(path) in ("k", "v")
            if self._cache_axis and attn and spec[leaf.dim() - 3] != "data":
                raise ValueError(
                    f"cache leaf {path} of length {leaf.shape[-3]} does not "
                    f"split over 'data' ({sizes['data']} ranks)")
            shape = SH.shard_shape(tuple(leaf.shape), spec, sizes)
            order = sorted(range(leaf.dim()), key=lambda d: -leaf.stride(d))
            t = torch.full([shape[d] for d in order],
                           float(fill.reshape(-1)[0]), dtype=leaf.dtype,
                           device=self.device)
            return t.permute([order.index(d) for d in range(leaf.dim())])
        return SH.tree_map_with_path(local, whole)

    def _row_state(self, cache):
        """(the cache a pass over this rank's rows writes, the recurrent
        leaves to join after it).  Where the rows split over 'data',
        attention leaves already hold this rank's rows; recurrent state is
        whole on every rank (``cache_specs`` replicates it over 'data'), so
        the pass runs, and writes in place, a view of its own rows, and
        :meth:`_join_state` gathers the other ranks' rows back into it, as
        GSPMD's resharding of the reference's state does."""
        bdim = 1 + len(self.model._lead)        # [(Bb,) n_sb, B, ...]
        n, i = self.mesh.axis_size("data"), self.mesh.coords["data"]
        joins = []

        def view(path, leaf):
            if SH._leaf_key(path) in ("k", "v"):
                return leaf
            rows = leaf.shape[bdim] // n
            part = leaf.narrow(bdim, i * rows, rows)
            joins.append((leaf, part))
            return part
        return SH.tree_map_with_path(view, cache), joins

    def _join_state(self, joins) -> None:
        """Each recurrent leaf's rows from every 'data' rank, written back
        into the whole state: one all-gather a leaf."""
        bdim = 1 + len(self.model._lead)
        group = self.mesh.group("data")
        for whole, part in joins:
            whole.copy_(comm.all_gather_dim(part, bdim, group))

    @property
    def supports_batched_prefill(self) -> bool:
        """True when the model can prefill its KV cache in one step."""
        return self.model.supports_single_step_prefill

    def prefill_into_cache(self, params, cache, tokens, *,
                           cache_index: int = 0, lengths=None):
        """Whole-prompt prefill into the decode cache.  tokens: [B, S].
        Returns ([B, vocab] last-token logits, cache)."""
        with torch.no_grad():
            if not self.distributed:
                return self.model.prefill_cache(params, cache, tokens,
                                                cache_index=cache_index,
                                                lengths=lengths)
            b = tokens.shape[0]
            if not self._split_rows(b):
                return self._cached_pass(params, cache, tokens, cache_index,
                                         lengths=lengths)
            tokens = self._rows(tokens)
            if lengths is not None:
                lengths = self._rows(torch.as_tensor(lengths))
            local, joins = self._row_state(cache)
            logits, _ = self._cached_pass(params, local, tokens, cache_index,
                                          lengths=lengths,
                                          rows=self._row_split())
            self._join_state(joins)
            return self._join_rows(logits, b), cache

    def serve_step(self, params, cache, batch, cache_index: int, *,
                   window_override: Optional[int] = None):
        """One-token decode; returns ([B, vocab] logits, cache)."""
        with torch.no_grad():
            if not self.distributed:
                logits, cache = self.model.decode_step(
                    params, cache, batch["tokens"], cache_index, batch=batch,
                    window_override=window_override)
                return logits[:, -1], cache
            self._audio(batch)
            b = batch["tokens"].shape[0]
            if not self._split_rows(b):
                return self._cached_pass(
                    params, cache, batch["tokens"], cache_index, batch=batch,
                    window_override=window_override)
            lb = self._rows(batch)
            local, joins = self._row_state(cache)
            logits, _ = self._cached_pass(
                params, local, lb["tokens"], cache_index, batch=lb,
                window_override=window_override, rows=self._row_split())
            self._join_state(joins)
            return self._join_rows(logits, b), cache

    def _cached_pass(self, params, cache, tokens, cache_index: int, *,
                     lengths=None, batch=None, window_override=None,
                     rows: Optional[RowSplit] = None):
        """One pass of this rank's rows through the model over its cache
        slices: a prompt (``prefill_cache``) without ``batch``, else a
        decode step; ``rows`` where the rows split over 'data'.  Returns
        ([B_local, vocab] logits, cache)."""
        kw = dict(cache_axis=self._cache_axis, gather=self._branch_gather(),
                  rows=rows)
        p = self._on_use(params)
        if batch is None:
            return self.model.prefill_cache(p, cache, tokens,
                                            cache_index=cache_index,
                                            lengths=lengths, **kw)
        logits, cache = self.model.decode_step(
            p, cache, tokens, cache_index, batch=batch,
            window_override=window_override, **kw)
        return logits[:, -1], cache

    # -------------------------------------------------------- paged surface
    def paged_model(self, params_fn) -> "PagedView":
        """The model-like view ``PagedArmScheduler`` serves on this rank:
        ``params_fn()`` returns the arm's current params (this rank's
        slices), read at every call."""
        return PagedView(self, params_fn)

    def _pool_split(self) -> bool:
        """True when this rank holds a 'model' slice of the paged pool (its
        stages' superblocks or its branches)."""
        return False

    def init_pool(self, num_blocks: int, block_size: int):
        """The paged KV pool (after ``init``); on a mesh, this rank's slice
        of it under :meth:`pool_specs`."""
        if not self.distributed:
            return self.model.init_pool(num_blocks, block_size)
        whole = self.whole_pool(num_blocks, block_size)
        sizes = dict(self.mesh.shape)
        return SH.tree_map(lambda t, s: torch.zeros(
            SH.shard_shape(tuple(t.shape), s, sizes), dtype=t.dtype,
            device=self.device), whole, self.pool_specs(whole))

    def whole_pool(self, num_blocks: int, block_size: int):
        """The whole paged pool on the meta device (no memory): the layout
        :meth:`init_pool` cuts this rank's slice from."""
        return build_model(self.cfg, device="meta").init_pool(num_blocks,
                                                              block_size)

    def pool_specs(self, pool):
        return SH.pool_specs(pool, self.mesh, model_leading=self._pool_split())

    def _paged_views(self, params):
        """(embed, final_norm, superblocks) of ``params`` as the paged
        forward reads them: leaves with a leading branch dim, the stack a
        superblock at a time (on a mesh, gathered on use)."""
        p = self.model._grouped(self._on_use(params))
        return p["embed"], p["final_norm"], p["blocks"]

    def _paged_join(self):
        return PM.LOCAL

    # -------------------------------------------------------------- layouts
    def param_specs(self, params):
        raise NotImplementedError

    def cache_specs(self, cache):
        return SH.cache_specs(cache, self.mesh,
                              shard_cache_len=self.shard_cache_len,
                              model_leading=self._cache_model_leading)


class FSDPRunner(BaseRunner):
    mode = "fsdp"

    def param_specs(self, params):
        return SH.fsdp_param_specs(params, self.mesh,
                                   zero_data=self.zero_data)


class _GatheredBranches:
    """The chunked CE's view of a semantic model whose branches are spread
    over 'model': each rank unembeds its own branches and one all-gather
    joins the vocab shards in branch order."""

    def __init__(self, model, group):
        self.model, self.group = model, group

    def chunk_logits(self, params, h):
        logits = L.unembed_apply(params["embed"], h.flatten(1, 2),
                                 self.model.branch_cfg)
        logits = comm.all_gather(logits, 0, self.group)
        return self.model._merge(logits.unflatten(1, h.shape[1:3]))


class SemanticRunner(BaseRunner):
    """SEMANTIC split: B branches of width d/B run independently (the only
    cross-branch op is the final vocab-shard concat), so 'model' ranks
    host whole branches."""

    mode = "semantic"
    _cache_model_leading = True
    _owned_axes = ("model",)

    def __init__(self, cfg: ArchConfig, mesh=(1, 1), *,
                 n_branches: Optional[int] = None, **kw):
        shape = M.resolve(mesh)
        n_b = n_branches or max(2, shape.axis_size("model"))
        if n_b % shape.axis_size("model"):
            raise ValueError(f"{n_b} branches do not divide over mesh "
                             f"'model' size {shape.axis_size('model')}")
        super().__init__(cfg.semantic(n_b), shape, **kw)
        self.base_cfg = cfg

    def param_specs(self, params):
        return SH.semantic_param_specs(params, self.mesh,
                                       zero_data=self.zero_data)

    def _pool_split(self) -> bool:
        return self.distributed and self.mesh.axis_size("model") > 1

    def _paged_join(self):
        return _BranchJoin(self.mesh) if self._pool_split() else PM.LOCAL

    def _branch_gather(self):
        if self.mesh.axis_size("model") == 1:
            return None
        group = self.mesh.group("model")
        return lambda logits: comm.all_gather_dim(logits, 0, group)

    def _forward_logits(self, params, batch, rows: Optional[RowSplit] = None):
        if self.mesh.axis_size("model") == 1:
            return super()._forward_logits(params, batch, rows)
        p = self._on_use(params)
        h, _ = self.model.hidden(p, batch, rows=rows)
        return _GatheredBranches(self.model, self.mesh.group(
            "model")).chunk_logits(p, h)

    def _local_loss(self, params, batch, *, remat: bool, n_micro: int = 1,
                    rows: Optional[RowSplit] = None):
        if not self.distributed or self.mesh.axis_size("model") == 1:
            return self.model.loss_chunked(params, batch, remat=remat,
                                           rows=rows)
        group = self.mesh.group("model")
        h, aux = self.model.hidden(params, batch, remat=remat, rows=rows)
        aux = comm.all_reduce(aux, group)
        return MM._chunked_ce(_GatheredBranches(self.model, group), params, h,
                              batch["labels"], 512) + 0.01 * aux


class PipelineRunner(BaseRunner):
    """LAYER split under one of three schedules:

    - ``"gspmd"``: the microbatched loss (the stack dim on 'model' as a
      layout; every rank gathers the leaves and runs every layer), its
      gradients accumulated a microbatch at a time.
    - ``"gpipe"`` / ``"1f1b"``: the explicit stage graph
      (``repro_torch.dist.pipeline``), one stage per 'model' rank, with
      its manual remat-style backward; ``memory_budget`` caps gpipe's saved
      microbatches.

    With ``expert_parallel`` on an explicit schedule, 'model' carries
    experts instead of stages and the MoE all-to-all path runs end to end;
    under ``"gspmd"`` expert parallelism stays layout-level.
    """

    mode = "pipeline"
    _cache_model_leading = True

    def __init__(self, cfg: ArchConfig, mesh=(1, 1), *,
                 n_microbatches: Optional[int] = None,
                 expert_parallel: bool = False, schedule: str = "gspmd",
                 memory_budget: Optional[int] = None, **kw):
        if schedule not in PL.SCHEDULES:
            raise ValueError(
                f"unknown schedule {schedule!r}; expected one of "
                f"{PL.SCHEDULES}")
        super().__init__(cfg, mesh, **kw)
        self.n_microbatches = n_microbatches
        self.expert_parallel = expert_parallel
        self.schedule = schedule
        self.memory_budget = memory_budget
        self.n_stages = self.mesh.axis_size("model")
        self._ep_model = None
        if self._use_ep_substrate():
            if cfg.moe.n_experts % max(self.n_stages, 1):
                raise ValueError(
                    f"{cfg.name}: expert parallelism needs n_experts="
                    f"{cfg.moe.n_experts} divisible by the mesh 'model' "
                    f"size {self.n_stages}")
            self._ep_model = build_model(
                cfg.replace(expert_parallel_axis="model"), device="meta")

    def _use_ep_substrate(self) -> bool:
        return (self.expert_parallel and self.schedule != "gspmd"
                and self.cfg.moe is not None)

    def _use_stage_graph(self) -> bool:
        return self.schedule != "gspmd" and not self._use_ep_substrate()

    def _resolve(self, batch) -> int:
        return PL.resolve_microbatches(batch["tokens"].shape[0],
                                       self.n_microbatches, self.n_stages)

    def _n_micro(self, batch) -> int:
        return self._resolve(batch)

    def local_batch(self, batch):
        """Microbatch-major rows: microbatch m's rows split over 'data'."""
        if not self.distributed:
            return batch
        return PL.split_data(batch, self._resolve(batch), self.mesh)

    def _batch_rows(self, batch) -> Optional[RowSplit]:
        """``split_data`` splits each microbatch's rows over 'data'."""
        if not self.distributed or self.mesh.axis_size("data") == 1:
            return None
        return self._row_split(aux=True)

    def _local_loss(self, params, batch, *, remat: bool, n_micro: int = 1,
                    rows: Optional[RowSplit] = None):
        return PL.microbatch_loss(self.model, params, batch, n_micro,
                                  remat=remat, rows=rows)

    def loss(self, params, batch, *, remat: bool = False):
        m = self._resolve(batch)
        if self._use_ep_substrate():
            return PL.ep_loss(self._ep_model, params, batch, self.mesh,
                              n_micro=m, remat=remat)
        if self._use_stage_graph():
            return PL.stage_graph_loss(self.model, params, batch, self.mesh,
                                       schedule=self.schedule, n_micro=m)
        return super().loss(params, batch, remat=remat)

    def value_and_grad(self, params, batch, *, remat: bool = False):
        m = self._resolve(batch)
        if self._use_ep_substrate():
            loss, grads = PL.ep_value_and_grad(
                self._ep_model, params, batch, self.mesh, specs=self.specs,
                n_micro=m, remat=remat)
            return loss, tree_unflatten(params, grads)
        if self._use_stage_graph():
            loss, grads = PL.stage_graph_value_and_grad(
                self.model, params, batch, self.mesh, schedule=self.schedule,
                n_micro=m, remat=remat, memory_budget=self.memory_budget,
                specs=self.specs)
            return loss, tree_unflatten(params, grads)
        return super().value_and_grad(params, batch, remat=remat)

    # -------------------------------------------------------------- serving
    def _staged(self) -> bool:
        """True when serving runs the stages on their ranks: on a mesh whose
        'model' axis splits the block leaves' stack dim."""
        if not self.distributed or self.n_stages == 1:
            return False
        spec = SH.spec_leaves(self.specs["blocks"])[0]
        return len(spec) > 0 and spec[0] == "model"

    def _stage_view(self, params):
        """This stage's view of its slices: embed and norms gathered whole,
        its superblocks of the decoder's stack (and of whisper's encoder's)
        gathered (over the other axes) one at a time when each runs."""
        out = {}
        for k, sub in params.items():
            specs = self.specs[k]
            if k not in ("blocks", "enc_blocks"):
                out[k] = SH.tree_map(self._gather_leaf, sub, specs)
                continue
            out[k] = T.StackOnUse(
                tree_leaves(sub)[0].shape[0],
                lambda i, sub=sub, specs=specs: SH.tree_map(
                    lambda t, sp: self._gather_leaf(t.select(0, i),
                                                    tuple(sp)[1:]),
                    sub, specs))
        return out

    def _stage_encode(self, p, audio_embeds):
        """Whisper's encoder as its own chain of stages, each over its span
        of ``enc_blocks``: stage 0 projects the frames, each stage sends
        its [B, F, d] activation on with ``comm.exchange``, and the last
        applies ``enc_norm`` and broadcasts the encoder's output to every
        stage."""
        st, n = self.mesh.coords["model"], self.n_stages
        group = self.mesh.group("model")
        spec = SH.spec_leaves(self.specs["enc_blocks"])[0]
        if not (len(spec) and spec[0] == "model"):
            raise ValueError(
                f"{self.cfg.name}: the stages need the encoder's superblock "
                f"stack split over 'model' as the decoder's is (specs "
                f"{tuple(spec)})")
        b, f = audio_embeds.shape[:2]
        shape, dtype = (b, f, self.cfg.d_model), L.torch_dtype(self.cfg)
        if st == 0:
            x = audio_embeds
        else:
            x, = comm.exchange([], [(shape, dtype, st - 1)], group,
                               self.device)
        x = self.model.stage_encode(p, p["enc_blocks"], x, first=st == 0,
                                    last=st == n - 1)
        if st < n - 1:
            comm.exchange([(x, st + 1)], [], group, self.device)
            x = torch.empty(shape, dtype=dtype, device=self.device)
        return comm.broadcast_from(x, n - 1, group)

    def _stage_pass(self, params, tokens, *, positions=None, cache=None,
                    cache_index: Optional[int] = None, window_override=None,
                    select=None, image_embeds=None, audio_embeds=None,
                    rows: Optional[RowSplit] = None):
        """One forward of the LAYER split's stages: with ``audio_embeds``
        (whisper) the encoder's chain of stages first
        (:meth:`_stage_encode`), each stage then making its decoder
        superblocks' cross K/V of its output; stage 0 embeds (a VLM's patch
        embeddings ahead of the tokens, as its prefix), each stage runs its
        superblocks over its cache slice and sends the activation [B, S, d]
        on with ``comm.exchange``; the last stage runs the head on the token
        positions' ``select(x)`` (all of them without it) and broadcasts the
        f32 logits to the other stages.  ``positions`` defaults to every
        position of the activation.  Every rank posts the same collectives
        in the same order: the encoder's sends and broadcast, then the
        decoder's."""
        st, n = self.mesh.coords["model"], self.n_stages
        group = self.mesh.group("model")
        p = self._stage_view(params)
        b, s = tokens.shape
        enc_kv = None
        if audio_embeds is not None:
            enc_kv = self.model.stage_enc_kv(
                p["blocks"], self._stage_encode(p, audio_embeds))
        width = s if image_embeds is None else s + image_embeds.shape[1]
        if positions is None:
            positions = torch.arange(width, device=self.device)[None]
        if st == 0:
            x = self.model.stage_embed(p, tokens, image_embeds)
        else:
            x, = comm.exchange([], [((b, width, self.cfg.d_model),
                                     L.torch_dtype(self.cfg), st - 1)],
                               group, self.device)
        x, _ = self.model.stage_apply(
            p["blocks"], x, positions=positions, caches=cache,
            cache_index=cache_index, cache_axis=self._cache_axis,
            window_override=window_override, rows=rows, enc_kv_stack=enc_kv)
        if st < n - 1:
            comm.exchange([(x, st + 1)], [], group, self.device)
            logits = torch.empty((b, s if select is None else 1,
                                  self.cfg.vocab_size), dtype=torch.float32,
                                 device=self.device)
        else:
            x = x[:, width - s:]
            logits = self.model.stage_head_logits(
                p, x if select is None else select(x))
        return comm.broadcast_from(logits, n - 1, group)

    def _forward_logits(self, params, batch, rows: Optional[RowSplit] = None):
        if not self._staged():
            return super()._forward_logits(params, batch, rows)
        return self._stage_pass(params, batch["tokens"],
                                image_embeds=batch.get("image_embeds"),
                                audio_embeds=self._audio(batch), rows=rows)

    def _pool_split(self) -> bool:
        return self._staged()

    def _paged_views(self, params):
        if not self._staged():
            return super()._paged_views(params)
        p = self.model._grouped(self._stage_view(params))
        return p["embed"], p["final_norm"], p["blocks"]

    def _paged_join(self):
        return _StageJoin(self) if self._staged() else PM.LOCAL

    def _cached_pass(self, params, cache, tokens, cache_index: int, *,
                     lengths=None, batch=None, window_override=None,
                     rows: Optional[RowSplit] = None):
        if not self._staged():
            return super()._cached_pass(
                params, cache, tokens, cache_index, lengths=lengths,
                batch=batch, window_override=window_override, rows=rows)
        # a decode step re-encodes the audio each call, as the reference's
        # decode_step does when it is given no enc_kv; a prompt (no batch)
        # takes none, as its prefill_cache
        audio = None if batch is None else self._audio(batch)
        pos = cache_index + torch.arange(tokens.shape[1],
                                         device=self.device)[None, :]
        logits = self._stage_pass(
            params, tokens, positions=pos, cache=cache,
            cache_index=cache_index, window_override=window_override,
            select=lambda x: MM.last_positions(x, lengths),
            audio_embeds=audio, rows=rows)
        return logits[:, -1], cache

    # -------------------------------------------------------------- layouts
    def param_specs(self, params):
        if self.schedule != "gspmd":
            return SH.stage_param_specs(
                params, self.mesh, expert_parallel=self._use_ep_substrate())
        return SH.pipeline_param_specs(params, self.mesh,
                                       zero_data=self.zero_data,
                                       expert_parallel=self.expert_parallel)

    # ----------------------------------------------------------- accounting
    def schedule_stats(self, batch_size: int, seq_len: int) -> dict:
        """Bubble-fraction / transfer-bytes accounting for one train step of
        the configured schedule (analytic, from the static tick table)."""
        m = PL.resolve_microbatches(batch_size, self.n_microbatches,
                                    self.n_stages)
        n_data = self.mesh.axis_size("data")
        stats = {"mode": self.mode, "schedule": self.schedule,
                 "n_stages": self.n_stages, "n_microbatches": m,
                 "memory_budget": self.memory_budget,
                 "expert_parallel": bool(self._use_ep_substrate())}
        if self.schedule == "gspmd" or self._use_ep_substrate():
            # gspmd: no tick table; expert parallel: all-to-alls sized by
            # the MoE dispatch
            return stats
        sched = PL.build_schedule(self.schedule, self.n_stages, m,
                                  memory_budget=self.memory_budget)
        pb = PL.payload_bytes(self.cfg, batch_size // m // n_data, seq_len)
        stats.update({
            "ticks": sched.ticks,
            "bubble_fraction": round(sched.bubble_fraction, 4),
            "peak_saved_microbatches": sched.peak_saved_microbatches,
            "n_transfers": sched.n_transfers,
            "payload_bytes": pb,
            "transfer_bytes_per_step": sched.n_transfers * pb,
            # the reference's SPMD wire traffic: 2 sends a tick a stage,
            # masked ones included (the port sends the scheduled ones only)
            "wire_bytes_per_step": 2 * sched.ticks * self.n_stages * pb,
        })
        return stats


# ------------------------------------------------------------ paged view
class PagedView:
    """What ``PagedArmScheduler`` reads of a model, over a runner: the
    device, the configs, ``supports_single_step_prefill``,
    ``grouped_views()`` (this rank's slices of the arm's params as
    ``params_fn()`` gives them at the call), ``init_pool`` (this rank's
    slice of the pool), ``whole_pool`` (the whole pool on the meta device,
    whose block the scheduler's byte gauges count) and ``join`` (how this
    rank's slice of a paged forward meets the others':
    ``decode.paged_model``)."""

    def __init__(self, runner: BaseRunner, params_fn):
        self.runner, self._params_fn = runner, params_fn
        self.cfg, self.branch_cfg = runner.model.cfg, runner.model.branch_cfg
        self._merge = runner.model._merge
        self.device = runner.device
        self.supports_single_step_prefill = runner.supports_batched_prefill
        self.join = runner._paged_join()

    def grouped_views(self):
        return self.runner._paged_views(self._params_fn())

    def init_pool(self, num_blocks: int, block_size: int):
        return self.runner.init_pool(num_blocks, block_size)

    def whole_pool(self, num_blocks: int, block_size: int):
        return self.runner.whole_pool(num_blocks, block_size)


# ------------------------------------------------------- pinned workers
class PinnedJoin(PM.LocalJoin):
    """The join of a paged worker pinned whole to ``rank`` of a
    process-group mesh, on that rank: its forwards run the whole model
    (nothing crosses ranks), and on a rank other than 0 the statistics it
    reduces (the weight-quant telemetry) go to rank 0, whose
    :class:`RemoteView` of the worker takes them."""

    def __init__(self, rank: int, mesh, group):
        self.rank, self.mesh, self.group = rank, mesh, group

    def reduce_stats(self, stats):
        if self.rank != 0:
            comm.send_to(torch.tensor(stats, dtype=torch.float64,
                                      device=M.wire_device(self.mesh)),
                         0, self.group)
        return stats


class _RemoteJoin(PM.LocalJoin):
    """A :class:`RemoteView`'s join: rank 0 receives the pinned rank's
    reduced statistics; another rank has none to add."""

    def __init__(self, rank: int, mesh, group):
        self.rank, self.mesh, self.group = rank, mesh, group

    def reduce_stats(self, stats):
        if self.mesh.rank != 0:
            return stats
        mx, tot, n = comm.post_recv((3,), torch.float64, self.rank,
                                    self.group,
                                    M.wire_device(self.mesh)).wait().tolist()
        return mx, tot, int(n)


class _Outputs:
    """The outputs of one call of a remote worker, in flight from its
    rank: ``cpu()`` waits for them (the scheduler reads a call's outputs
    so)."""

    def __init__(self, recv: comm.Receive):
        self._recv = recv

    def cpu(self) -> torch.Tensor:
        return self._recv.wait().cpu()


class RemoteView:
    """A paged worker pinned whole to another rank (``rank``) of a
    process-group mesh, as this rank's ``PagedArmScheduler`` holds it:
    the configs of ``model`` (built on the meta device: no weights here),
    ``init_pool`` and ``whole_pool`` (the whole pool on the meta device,
    shapes only), and ``remote_call``, the scheduler's device calls.  On
    rank 0 a call makes no device work: it posts the receive of the
    outputs rank 0 reads (the prefill chunk's [W] tokens, the decode
    call's packed [W, K + 3] matrix), which the pinned rank sends once it
    has replayed the call.  On another rank the scheduler drops the
    call."""

    def __init__(self, model, rank: int, mesh, group):
        self.cfg, self.branch_cfg = model.cfg, model.branch_cfg
        self.supports_single_step_prefill = model.supports_single_step_prefill
        self.device = torch.device("meta")
        self.rank, self.mesh, self.group = rank, mesh, group
        self.join = _RemoteJoin(rank, mesh, group)
        self._meta = model

    def grouped_views(self):
        """No weights here: an empty stack (its weight-quantized copy is
        empty too; the telemetry comes from the pinned rank, through the
        join)."""
        return None, None, []

    def init_pool(self, num_blocks: int, block_size: int):
        return self._meta.init_pool(num_blocks, block_size)

    whole_pool = init_pool

    def remote_call(self, kind: str, key: tuple):
        """The device call of ``kind`` at bucket ``key``, as rank 0 makes
        it for this worker: (pool, *host arrays) -> (pool, the outputs in
        flight), the COW copy (pool,)."""
        if kind == "cow":
            return lambda pool, *host: (pool,)
        shape = (key[0],) if kind == "prefill" else (key[0], key[1] + 3)
        wire = M.wire_device(self.mesh)
        return lambda pool, *host: (pool, _Outputs(comm.post_recv(
            shape, torch.int32, self.rank, self.group, wire)))


def _reduce_stats(stats, mesh):
    """(max, sum, count) over the mesh's 'model' ranks: one all-reduce
    max, one sum, on the mesh's wire device."""
    mx, tot, n = stats
    group, dev = mesh.group("model"), M.wire_device(mesh)
    mx = comm.all_reduce_max(
        torch.tensor([mx], dtype=torch.float64, device=dev), group)
    tot = comm.all_reduce_sum(
        torch.tensor([tot, n], dtype=torch.float64, device=dev), group)
    return float(mx[0]), float(tot[0]), int(tot[1])


class _StageJoin:
    """A LAYER stage's side of a paged forward: stage 0 embeds and a later
    stage receives the activation [B, S, d] from the one before; a stage
    but the last sends its output on, and the last stage takes the greedy
    tokens and broadcasts them ([B] int32)."""

    def __init__(self, runner: PipelineRunner):
        self.mesh = runner.mesh
        self.st, self.n = runner.mesh.coords["model"], runner.n_stages
        self.device, self.d = runner.device, runner.cfg.d_model
        self.dtype = L.torch_dtype(runner.cfg)

    def enter(self, embed, shape):
        if self.st == 0:
            return embed()
        x, = comm.exchange([], [((*shape, self.d), self.dtype, self.st - 1)],
                           self.mesh.group("model"), self.device)
        return x[None]

    def tokens(self, model, params, x, select):
        group = self.mesh.group("model")
        if self.st < self.n - 1:
            comm.exchange([(x[0], self.st + 1)], [], group, self.device)
            tok = torch.empty(x.shape[1], dtype=torch.int32,
                              device=self.device)
        else:
            tok = PM.LOCAL.tokens(model, params, x, select)
        return comm.broadcast_from(tok, self.n - 1, group)

    def reduce_stats(self, stats):
        return _reduce_stats(stats, self.mesh)


class _BranchJoin(PM.LocalJoin):
    """A SEMANTIC rank's side: it runs its own branches end to end.  The
    greedy token of the merged vocab (branch-major shards, a rank's
    branches contiguous in branch order) is the first index of its largest
    logit, so each rank offers, per lane, its branches' largest logit and
    that logit's first global index, one all-gather of [B, 2] f32 joins the
    pairs in rank order, and the first rank holding the largest value
    gives the token: ``torch.argmax`` over the merged vocab."""

    def __init__(self, mesh):
        self.mesh = mesh

    def tokens(self, model, params, x, select):
        logits = PM._head(model, params, select(x))      # [B, own vocab]
        idx = torch.argmax(logits, dim=-1)
        val = logits.gather(-1, idx[:, None])[:, 0].float()
        first = idx + self.mesh.coords["model"] * logits.shape[-1]
        pairs = comm.all_gather_dim(torch.stack([val, first.float()], -1)[None],
                                    0, self.mesh.group("model"))
        best = torch.argmax(pairs[..., 0], dim=0)        # first rank of max
        return pairs[..., 1].gather(0, best[None])[0].int()

    def reduce_stats(self, stats):
        return _reduce_stats(stats, self.mesh)


def build_runner(cfg: ArchConfig, mode: str, mesh=(1, 1), *,
                 n_microbatches: Optional[int] = None,
                 shard_cache_len: bool = False,
                 expert_parallel: bool = False,
                 zero_data: bool = True,
                 n_branches: Optional[int] = None,
                 schedule: str = "gspmd",
                 memory_budget: Optional[int] = None, device="cuda"):
    """Construct the runner for one split mode (see the module docstring);
    the JAX ``build_runner``'s arguments, plus ``device``.  A mesh larger
    than the world raises."""
    common = dict(shard_cache_len=shard_cache_len, zero_data=zero_data,
                  device=device)
    if mode == "fsdp":
        return FSDPRunner(cfg, mesh, **common)
    if mode == "semantic":
        return SemanticRunner(cfg, mesh, n_branches=n_branches, **common)
    if mode == "pipeline":
        return PipelineRunner(cfg, mesh, n_microbatches=n_microbatches,
                              expert_parallel=expert_parallel,
                              schedule=schedule, memory_budget=memory_budget,
                              **common)
    raise ValueError(f"unknown mode {mode!r}; expected one of {MODES}")


def make_train_step(runner, *, lr: float = 3e-4, remat: bool = False,
                    weight_decay: float = 0.1, clip_norm: float = 1.0,
                    opt_specs: Optional[SH.AdamWState] = None):
    """(params, opt, batch) -> (params, opt, loss): grads from
    ``runner.value_and_grad``, then an AdamW step (in place; on a mesh over
    each rank's slices, clipped by the whole gradient's norm).

    ``opt_specs`` (``pod_shard_opt_specs``'s: moments split further over
    'pod' than the parameters are) runs the step on the moments' slices:
    see :func:`_resharded_adamw`."""
    kw = dict(lr=lr, weight_decay=weight_decay, clip_norm=clip_norm)

    def step(params, opt, batch):
        loss, grads = runner.value_and_grad(params, batch, remat=remat)
        if opt_specs is None:
            params, opt = adamw_update(grads, opt, params, specs=runner.specs,
                                       mesh=runner.mesh, **kw)
        else:
            params, opt = _resharded_adamw(grads, opt, params, runner,
                                           opt_specs, **kw)
        return params, opt, loss

    return step


def _resharded_adamw(grads, opt, params, runner, opt_specs, *, lr,
                     weight_decay, clip_norm):
    """One AdamW step whose moments lie under ``opt_specs`` while the
    parameters and gradients lie under ``runner.specs`` (they differ on
    at most one dim of a leaf, which the moments split over 'pod' as
    well), as GSPMD reshards the reference's step: the clip reads the
    whole gradient's norm; then, a leaf at a time, the gradient and the
    parameter are all-gathered along that dim, cut to the moments' slice
    and stepped there, and the stepped slices are all-gathered back and
    cut to the parameter's slice."""
    from repro_torch.optim.adamw import AdamWState, global_norm
    mesh = runner.mesh
    sizes = dict(mesh.shape)
    scale = None
    if clip_norm:
        g_norm = global_norm(grads, specs=runner.specs, mesh=mesh)
        scale = torch.clamp(clip_norm / torch.clamp(g_norm, min=1e-9),
                            max=1.0)

    def axes(e):
        return () if e is None else (e if isinstance(e, tuple) else (e,))

    def along(t, entry, d, whole):
        """Gather ``t``'s slices along dim ``d`` over ``entry``'s axes
        (minor first) when ``whole``, else cut the slice of ``entry``."""
        if whole:
            for ax in reversed(axes(entry)):
                t = comm.all_gather_dim(t, d, mesh.group(ax))
            return t
        spec = [None] * t.dim()
        spec[d] = entry
        return SH.shard_leaf(t, spec, sizes, mesh.coords)

    def leaf_step(g, m, v, p, ps, os_):
        if scale is not None:
            g = g * scale.to(g.dtype)
        ps = tuple(ps) + (None,) * (p.dim() - len(ps))
        os_ = tuple(os_) + (None,) * (p.dim() - len(os_))
        diff = [d for d in range(p.dim()) if ps[d] != os_[d]]
        state = AdamWState(opt.step, {"x": m}, {"x": v})
        kw = dict(clip_norm=0.0, lr=lr, weight_decay=weight_decay)
        if not diff:
            _, st = adamw_update({"x": g}, state, {"x": p}, **kw)
            return st.m["x"], st.v["x"]
        d, = diff
        gs = along(along(g, ps[d], d, True), os_[d], d, False)
        pp = along(along(p.detach(), ps[d], d, True), os_[d], d,
                   False).clone()
        _, st = adamw_update({"x": gs}, state, {"x": pp}, **kw)
        with torch.no_grad():
            p.copy_(along(along(pp, os_[d], d, True), ps[d], d, False))
        return st.m["x"], st.v["x"]

    # leaves matched by path: the moments' trees need not list them in the
    # parameters' order
    mv = SH.tree_map(leaf_step, grads, opt.m, opt.v, params, runner.specs,
                     opt_specs.m)
    pick = lambda i: SH.tree_map(lambda t: t[i], mv)
    return params, AdamWState(opt.step + 1, pick(0), pick(1))


def make_serve_step(runner, *, window_override: Optional[int] = None):
    """(params, cache, batch, cache_index) -> (logits, cache)."""

    def step(params, cache, batch, cache_index):
        return runner.serve_step(params, cache, batch, cache_index,
                                 window_override=window_override)

    return step
