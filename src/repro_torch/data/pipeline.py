"""Deterministic sharded data pipeline.

A copy of `repro.data.pipeline` (numpy only; the port imports nothing of
`repro`): synthetic but structured LM streams (Zipfian n-gram chains, so
the loss has signal to minimize), deterministic per (seed, step, host).
Each host materializes only its shard, and a restart replays the exact
stream from the step counter (no data-loader state in the checkpoint).
Batches are numpy arrays equal bit for bit to the reference's for any
(seed, step, host); the launcher moves them to the device.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    kind: str = "ngram"        # ngram | uniform


def _zipf_probs(vocab: int, alpha: float = 1.1) -> np.ndarray:
    r = np.arange(1, vocab + 1, dtype=np.float64)
    p = 1.0 / r ** alpha
    return p / p.sum()


class TokenStream:
    """Markov-chain token stream: the next token's distribution depends on
    the previous token's bucket, so cross-entropy is learnable (tests
    assert the loss drops below the unigram entropy)."""

    def __init__(self, cfg: DataConfig, host_id: int = 0, n_hosts: int = 1):
        if cfg.global_batch % n_hosts:
            raise ValueError(f"global batch {cfg.global_batch} does not "
                             f"split over {n_hosts} hosts")
        self.cfg = cfg
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.local_batch = cfg.global_batch // n_hosts
        base = np.random.default_rng(cfg.seed)
        self._zipf = _zipf_probs(cfg.vocab)
        # bucketized bigram structure: 16 buckets, each with its own
        # permutation of the zipf distribution
        self._n_buckets = 16
        self._perms = np.stack([base.permutation(cfg.vocab)
                                for _ in range(self._n_buckets)])

    def batch(self, step: int) -> dict:
        """Deterministic batch for a global step: {'tokens': [B_local, S+1]}
        int32."""
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 4096 + self.host_id)
        B, S = self.local_batch, cfg.seq_len
        if cfg.kind == "uniform":
            toks = rng.integers(0, cfg.vocab, size=(B, S + 1))
            return {"tokens": toks.astype(np.int32)}
        out = np.empty((B, S + 1), dtype=np.int64)
        out[:, 0] = rng.choice(cfg.vocab, size=B, p=self._zipf)
        for t in range(S):
            buckets = out[:, t] % self._n_buckets
            base_draw = rng.choice(cfg.vocab, size=B, p=self._zipf)
            out[:, t + 1] = self._perms[buckets, base_draw]
        return {"tokens": out.astype(np.int32)}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def unigram_entropy(vocab: int) -> float:
    p = _zipf_probs(vocab)
    return float(-(p * np.log(p)).sum())
