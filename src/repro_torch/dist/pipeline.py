"""Microbatched execution of the paper's LAYER split on one device (the
``schedule="gspmd"`` path of ``repro.dist.pipeline``): the batch is cut
into M microbatches whose mean loss is the step's loss, and whose
gradients accumulate one microbatch at a time, so only one microbatch's
activations are alive.  The explicit stage-graph schedules (gpipe, 1f1b)
are not ported yet: the reference runs them on one device too (a 1 x 1
mesh), and they wait for a slice of their own, with their tick tables and
the stage-graph executor.  Expert parallelism waits for the multi-device
training slice.

Numerics: the dense-model loss is invariant to M up to float summation
order (``tests/test_torch_train.py``).
"""
from __future__ import annotations

import math

import torch

SCHEDULES = ("gspmd", "gpipe", "1f1b")


def resolve_microbatches(batch_size: int, requested, n_stages: int) -> int:
    """Pick the microbatch count.  An explicit request must divide the batch;
    the default is the stage count clamped to a divisor of the batch."""
    if requested is not None:
        if batch_size % requested:
            raise ValueError(
                f"n_microbatches={requested} does not divide batch "
                f"size {batch_size}")
        return requested
    return math.gcd(batch_size, max(n_stages, 1)) or 1


def split_microbatches(batch, n_micro: int):
    """{name: [B, ...]} -> a list of M batches of [B/M, ...] (views)."""
    out = [dict() for _ in range(n_micro)]
    for k, x in batch.items():
        b = x.shape[0]
        parts = x.reshape((n_micro, b // n_micro) + tuple(x.shape[1:]))
        for i in range(n_micro):
            out[i][k] = parts[i]
    return out


def microbatch_loss(model, params, batch, n_micro: int, *,
                    remat: bool = False, chunk: int = 512):
    """Mean per-microbatch loss over M microbatches.  M = 1 is the plain
    full-batch loss."""
    if n_micro <= 1:
        return model.loss_chunked(params, batch, chunk=chunk, remat=remat)
    total = 0.0
    for mb in split_microbatches(batch, n_micro):
        total = total + model.loss_chunked(params, mb, chunk=chunk,
                                           remat=remat)
    return total / n_micro


def microbatch_value_and_grad(model, params, leaves, batch, n_micro: int, *,
                              remat: bool = False, chunk: int = 512):
    """(loss, [grad per leaf]) of :func:`microbatch_loss` by gradient
    accumulation: each microbatch's backward runs before the next
    microbatch's forward."""
    total, grads = None, None
    for mb in split_microbatches(batch, n_micro):
        loss = model.loss_chunked(params, mb, chunk=chunk,
                                  remat=remat) / n_micro
        g = torch.autograd.grad(loss, leaves, allow_unused=True)
        g = [torch.zeros_like(p) if x is None else x
             for x, p in zip(g, leaves)]
        loss = loss.detach()
        if grads is None:
            total, grads = loss, list(g)
        else:
            total = total + loss
            for acc, x in zip(grads, g):
                acc.add_(x)
    return total, grads
