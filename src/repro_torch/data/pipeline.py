"""Deterministic synthetic token pipeline (no external datasets offline).

A verbatim copy of ``repro.data.pipeline`` (numpy only), so the port and the
JAX package train on bit-equal batches.

Generates a reproducible "language" via a hashed n-gram chain: token t+1 is a
deterministic mix of the previous token and position noise.  This gives
non-uniform unigram statistics a model can actually learn (loss decreases),
unlike uniform random tokens.  Shardable: each (epoch, step, shard) slice is
generated independently — the pipeline is stateless and resumable.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_shards: int = 1
    shard: int = 0


class SyntheticLM:
    """x_{t+1} = (a * x_t + h(position)) % V with per-sequence keys."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        assert cfg.global_batch % cfg.n_shards == 0
        self.local_batch = cfg.global_batch // cfg.n_shards

    def batch(self, step: int):
        c = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([c.seed, step, c.shard]))
        b, s, v = self.local_batch, c.seq_len, c.vocab_size
        # markov-ish chain with a small state space for learnability
        keys = rng.integers(1, 257, size=(b, 1))
        start = rng.integers(0, v, size=(b, 1))
        pos = np.arange(s + 1)[None, :]
        toks = (start + keys * pos + (pos * pos) // 7) % max(v // 4, 2)
        noise = rng.integers(0, v, size=(b, s + 1))
        use_noise = rng.random((b, s + 1)) < 0.1
        toks = np.where(use_noise, noise, toks).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def batches_for(cfg, *, seq_len: int, global_batch: int, seed: int = 0,
                n_shards: int = 1, shard: int = 0):
    """Model-aware wrapper: adds frontend stub inputs (audio/image embeds)."""
    data = SyntheticLM(DataConfig(cfg.vocab_size, seq_len, global_batch,
                                  seed, n_shards, shard))
    fe = cfg.frontend

    def gen():
        for step, batch in enumerate(data):
            if cfg.is_encdec:
                rng = np.random.default_rng(seed + 7919 + step)
                batch["audio_embeds"] = rng.normal(
                    size=(data.local_batch, fe.n_tokens, fe.d_frontend)
                ).astype(np.float32)
            elif fe is not None and fe.kind == "vision":
                rng = np.random.default_rng(seed + 104729 + step)
                batch["image_embeds"] = rng.normal(
                    size=(data.local_batch, fe.n_tokens, fe.d_frontend)
                ).astype(np.float32)
            yield batch
    return gen()
