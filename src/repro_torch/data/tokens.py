"""Deterministic synthetic token pipeline (numpy twin of
``repro.data.tokens``; the port keeps its own copy and imports no torch
here).

Sequences are generated from a seeded per-shard Markov chain over the vocab
(structured enough that a small LM's loss visibly falls).  The stream is
indexed by (step, shard): any host can regenerate any batch shard
independently, so a checkpoint restart, or a resumed run with another host
count, replays the exact same global batch sequence.  For the same
``(seed, step, shard, n_shards)`` the batches are array-equal to the
reference's.
"""
from __future__ import annotations

from typing import Iterator, NamedTuple

import numpy as np


class TokenStreamConfig(NamedTuple):
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    order: int = 3          # Markov order of the synthetic language


def _mix(seed: int, *vals: int) -> np.random.Generator:
    h = int(seed)
    for v in vals:
        h = ((h ^ int(v)) * 0x100000001B3) % (1 << 64)
    return np.random.default_rng(h)


def batch_shard(cfg: TokenStreamConfig, step: int, shard: int,
                n_shards: int) -> np.ndarray:
    """The ``shard``-th slice of global batch ``step``: [B/n_shards, S]
    int32, a pure function of (cfg.seed, step, row index) -- identical
    global batches however many hosts split them."""
    if cfg.global_batch % n_shards != 0:
        raise ValueError(f"global batch {cfg.global_batch} does not split "
                         f"into {n_shards} shards")
    rows = cfg.global_batch // n_shards
    out = np.empty((rows, cfg.seq_len), np.int32)
    # the transition table is global to the stream (derived from the seed
    # only): next = table[prev, noise], a lookup structure a small model
    # learns quickly (entropy floor ln(branch))
    branch = 8
    table = _mix(cfg.seed, 0xC0EF).integers(
        0, cfg.vocab, (cfg.vocab, branch))
    for r in range(rows):
        grow = shard * rows + r
        rng = _mix(cfg.seed, step, grow)
        seq = np.empty(cfg.seq_len, np.int64)
        seq[0] = rng.integers(0, cfg.vocab)
        noise = rng.integers(0, branch, cfg.seq_len)
        for t in range(1, cfg.seq_len):
            seq[t] = table[seq[t - 1], noise[t]]
        out[r] = seq
    return out


def stream(cfg: TokenStreamConfig, start_step: int, shard: int,
           n_shards: int) -> Iterator[tuple[int, np.ndarray]]:
    """Resumable stream: yields (step, batch_shard) from ``start_step``."""
    step = start_step
    while True:
        yield step, batch_shard(cfg, step, shard, n_shards)
        step += 1
