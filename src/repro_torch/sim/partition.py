"""Synthetic federated datasets + the paper's data-to-learner mappings (§5.1).

Port of ``repro.sim.partition`` (numpy, the reference's draw order).
Classifier datasets are Gaussian-cluster classification problems with the
label cardinalities of the paper's benchmarks; the token benchmarks are
per-learner corpora of ``repro_torch.data.synthetic``.  Mappings:
  D1 "uniform"     — IID uniform random split
  D2 "fedscale"    — power-law learner sizes, labels from the global marginal
  D3 "label_<L>"   — label-limited: each learner holds ~10% of labels with
                      per-label sample counts L1 balanced / L2 uniform /
                      L3 zipf(alpha=1.95)
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.data.synthetic import federated_token_shards

BENCHMARKS = {
    # name: (n_classes, feature_dim, n_train, n_test)
    "speech": (35, 64, 7000, 1400),
    "cifar10": (10, 64, 5000, 1000),
    "openimage": (60, 64, 9000, 1500),
}

TOKEN_BENCHMARKS = {
    # name: (vocab, seq_len, samples_per_learner, n_test, unigram skew)
    "tokens": (1024, 64, 48, 256, 0.0),
    "tokens_skew": (1024, 64, 48, 256, 0.5),
}


def benchmark_kind(name: str) -> str:
    """The sample layout a benchmark provides: ``"classifier"`` (x (N, dim)
    fp32 / y (N,) int labels) or ``"tokens"`` (x (N, S) int32 sequences /
    y (N, S) next-token labels)."""
    if name in TOKEN_BENCHMARKS:
        return "tokens"
    if name in BENCHMARKS:
        return "classifier"
    raise ValueError(f"unknown benchmark {name!r} (choose from "
                     f"{tuple(BENCHMARKS) + tuple(TOKEN_BENCHMARKS)})")


@dataclasses.dataclass
class FederatedDataset:
    name: str
    x_train: np.ndarray
    y_train: np.ndarray
    x_test: np.ndarray
    y_test: np.ndarray
    shards: list            # shards[i] = np.ndarray of sample indices for learner i
    kind: str = "classifier"    # sample layout (see ``benchmark_kind``)
    vocab: int = 0              # tokens: vocabulary size

    @property
    def n_classes(self):
        if self.kind == "tokens":
            return int(self.vocab)
        return int(self.y_train.max()) + 1


def make_dataset(name: str, rng: np.random.Generator, class_sep: float = 2.2):
    n_classes, dim, n_train, n_test = BENCHMARKS[name]
    # the first draw is discarded, as in the reference: it is part of the
    # generator stream every later draw depends on
    centers = rng.standard_normal((n_classes, dim)) * class_sep / np.sqrt(dim) * np.sqrt(dim)
    centers = rng.standard_normal((n_classes, dim))
    centers *= class_sep / np.linalg.norm(centers, axis=1, keepdims=True) * np.sqrt(dim) ** 0.5

    def sample(n):
        y = rng.integers(0, n_classes, size=n)
        x = centers[y] + rng.standard_normal((n, dim))
        return x.astype(np.float32), y.astype(np.int32)

    x_tr, y_tr = sample(n_train)
    x_te, y_te = sample(n_test)
    return x_tr, y_tr, x_te, y_te


def make_token_dataset(name: str, n_learners: int, seed: int) -> FederatedDataset:
    """Federated token-shard dataset for the LM benchmarks.

    Each learner owns a contiguous index block over the concatenated
    per-learner corpora of ``federated_token_shards`` (the data-to-learner
    mapping is the shard structure: token benchmarks ignore
    ``SimConfig.mapping``); the held-out split is an unskewed corpus drawn
    from an independent seed offset.  Everything derives from ``seed``
    alone, so cells sharing a seed share bit-identical data.
    """
    vocab, seq_len, spl, n_test, skew = TOKEN_BENCHMARKS[name]
    per = federated_token_shards(vocab, n_learners, spl, seq_len,
                                 seed=seed, skew=skew)
    x_tr = np.concatenate([s["tokens"] for s in per])
    y_tr = np.concatenate([s["labels"] for s in per])
    shards = [np.arange(i * spl, (i + 1) * spl) for i in range(n_learners)]
    test = federated_token_shards(vocab, 1, n_test, seq_len,
                                  seed=seed + 104729, skew=0.0)[0]
    return FederatedDataset(name, x_tr, y_tr, test["tokens"], test["labels"],
                            shards, kind="tokens", vocab=vocab)


def partition(y: np.ndarray, n_learners: int, mapping: str,
              rng: np.random.Generator, label_fraction: float = 0.10,
              zipf_alpha: float = 1.95) -> list:
    n = len(y)
    n_classes = int(y.max()) + 1
    idx_by_class = [np.flatnonzero(y == c) for c in range(n_classes)]
    for a in idx_by_class:
        rng.shuffle(a)

    if mapping == "uniform":  # D1
        perm = rng.permutation(n)
        return [perm[i::n_learners] for i in range(n_learners)]

    if mapping == "fedscale":  # D2: power-law sizes, near-IID labels
        sizes = rng.zipf(1.6, size=n_learners).astype(float)
        sizes = np.maximum(sizes / sizes.sum() * n, 2).astype(int)
        perm = rng.permutation(n)
        shards, off = [], 0
        for s in sizes:
            shards.append(perm[off:off + s] if off < n else perm[-s:])
            off += s
        return shards

    if mapping.startswith("label"):  # D3: label-limited
        style = mapping.split("_", 1)[1] if "_" in mapping else "uniform"
        k = max(1, int(round(label_fraction * n_classes)))
        per_learner = max(2, n // n_learners)
        cursors = np.zeros(n_classes, dtype=int)
        shards = []
        for i in range(n_learners):
            labels = rng.choice(n_classes, size=k, replace=False)
            if style == "balanced":      # L1
                counts = np.full(k, per_learner // k)
            elif style == "zipf":        # L3
                w = (np.arange(1, k + 1, dtype=float) ** -zipf_alpha)
                w = w[rng.permutation(k)]
                counts = np.maximum((w / w.sum() * per_learner), 1).astype(int)
            else:                        # L2 uniform
                w = rng.random(k)
                counts = np.maximum((w / w.sum() * per_learner), 1).astype(int)
            take = []
            for lab, cnt in zip(labels, counts):
                pool = idx_by_class[lab]
                start = cursors[lab] % len(pool)
                sel = np.take(pool, np.arange(start, start + cnt), mode="wrap")
                cursors[lab] += cnt
                take.append(sel)
            shards.append(np.concatenate(take))
        return shards

    raise ValueError(f"unknown mapping {mapping}")
