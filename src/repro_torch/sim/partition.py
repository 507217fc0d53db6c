"""Synthetic federated datasets + the paper's data-to-learner mappings (§5.1).

Port of the classifier half of ``repro.sim.partition`` (numpy, the
reference's draw order).  Datasets are Gaussian-cluster classification
problems with the label cardinalities of the paper's benchmarks.  Mappings:
  D1 "uniform"     — IID uniform random split
  D2 "fedscale"    — power-law learner sizes, labels from the global marginal
  D3 "label_<L>"   — label-limited: each learner holds ~10% of labels with
                      per-label sample counts L1 balanced / L2 uniform /
                      L3 zipf(alpha=1.95)
"""
from __future__ import annotations

import dataclasses

import numpy as np

BENCHMARKS = {
    # name: (n_classes, feature_dim, n_train, n_test)
    "speech": (35, 64, 7000, 1400),
    "cifar10": (10, 64, 5000, 1000),
    "openimage": (60, 64, 9000, 1500),
}

# the reference's LM benchmarks; their token data is not ported yet
TOKEN_BENCHMARKS = ("tokens", "tokens_skew")


@dataclasses.dataclass
class FederatedDataset:
    name: str
    x_train: np.ndarray
    y_train: np.ndarray
    x_test: np.ndarray
    y_test: np.ndarray
    shards: list            # shards[i] = np.ndarray of sample indices for learner i

    @property
    def n_classes(self):
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
