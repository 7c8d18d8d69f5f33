"""Deterministic, resumable, shardable synthetic token pipeline (numpy;
copy of ``repro/training/data.py``).

Batches are a pure function of (seed, step) — a restarted or re-scaled job
asks for step k and gets byte-identical data, which is what makes the
checkpoint/restart tests exact.  Per-host sharding slices the global batch by
(host_index, host_count) the way a multi-process loader would.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int = 512
    seq_len: int = 128
    global_batch: int = 8
    seed: int = 0
    # markov-chain order-1 synthetic language (so loss can actually decrease)
    branching: int = 16


class TokenPipeline:
    def __init__(self, cfg: DataConfig, host_index: int = 0, host_count: int = 1):
        assert cfg.global_batch % host_count == 0
        self.cfg = cfg
        self.host_index = host_index
        self.host_count = host_count
        rng = np.random.default_rng(cfg.seed)
        # fixed sparse transition structure
        self._next = rng.integers(
            0, cfg.vocab_size, size=(cfg.vocab_size, cfg.branching)
        )

    def batch(self, step: int) -> Tuple[np.ndarray, np.ndarray]:
        """(tokens, labels) for this host at `step` — deterministic."""
        cfg = self.cfg
        per_host = cfg.global_batch // self.host_count
        rng = np.random.default_rng(
            (cfg.seed, step, self.host_index)
        )
        toks = np.empty((per_host, cfg.seq_len + 1), np.int32)
        toks[:, 0] = rng.integers(0, cfg.vocab_size, size=per_host)
        choices = rng.integers(0, cfg.branching, size=(per_host, cfg.seq_len))
        for t in range(cfg.seq_len):
            toks[:, t + 1] = self._next[toks[:, t], choices[:, t]]
        return toks[:, :-1], toks[:, 1:]

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
