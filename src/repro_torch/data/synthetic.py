"""Synthetic token pipeline for the LM training paths (port of
``repro.data.synthetic``; numpy only, the reference's draw order).

Deterministic, seedable, shardable.  Sequences follow a Zipf-ish unigram
distribution with short-range repetition structure so that a small model's
loss actually decreases.
"""
from __future__ import annotations

import numpy as np


def _unigram_logits(vocab: int) -> np.ndarray:
    return -1.1 * np.log(np.arange(1, vocab + 1))


def token_batches(vocab: int, batch: int, seq_len: int, *, seed: int = 0):
    """Infinite generator of {"tokens", "labels"} numpy batches."""
    rng = np.random.default_rng(seed)
    p = np.exp(_unigram_logits(vocab))
    p /= p.sum()
    while True:
        toks = rng.choice(vocab, size=(batch, seq_len + 1), p=p)
        # inject copy structure: second half repeats first half with noise
        half = seq_len // 2
        toks[:, half:half * 2] = toks[:, :half]
        flips = rng.random((batch, half)) < 0.1
        toks[:, half:half * 2][flips] = rng.choice(vocab, size=int(flips.sum()), p=p)
        yield {"tokens": toks[:, :-1].astype(np.int32),
               "labels": toks[:, 1:].astype(np.int32)}


def federated_token_shards(vocab: int, n_learners: int, samples_per_learner: int,
                           seq_len: int, *, seed: int = 0, skew: float = 0.0):
    """Per-learner token corpora; ``skew`` biases each learner's unigram
    distribution (the LM analogue of label-limited mapping)."""
    rng = np.random.default_rng(seed)
    base = np.exp(_unigram_logits(vocab))
    shards = []
    for i in range(n_learners):
        p = base.copy()
        if skew > 0:
            boost = rng.choice(vocab, size=max(1, vocab // 10), replace=False)
            p[boost] *= 1 + 10 * skew
        p /= p.sum()
        toks = rng.choice(vocab, size=(samples_per_learner, seq_len + 1), p=p)
        shards.append({"tokens": toks[:, :-1].astype(np.int32),
                       "labels": toks[:, 1:].astype(np.int32)})
    return shards
