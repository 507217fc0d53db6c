"""FLIPS-style label-distribution clustering selection (2308.03901).

FLIPS's core intuition: under non-IID label mappings, uniform sampling
over-represents the dominant label clusters; clustering learners by their
*label distribution* and guaranteeing every cluster a share of each
round's budget keeps minority data in the aggregate.

The clustering is a build-time artifact: label histograms come from the
substrate's dataset shards (server-visible metadata, not update values)
and a small deterministic k-means — seeded from the cell's config seed,
fixed iteration count — assigns every learner a cluster once, before
round 0.  Selection is then feedback-free and view-free: each round's
budget is split across the clusters present among the checked-in
learners (equal shares, largest-cluster-first remainder, overflow
redistributed), and members are drawn uniformly within each cluster.
No per-round device feedback is consumed.

Port of ``repro.selection.flips`` for the classifier benchmarks: the label
histograms, the k-means and the quotas are the reference's numpy code.
The token adapter waits for the token datasets (ROADMAP.md queue 1 item
2) and raises.
"""
from __future__ import annotations

import numpy as np

from repro_torch.selection.base import Knob, Selector, SelectorSpec
from repro_torch.selection.registry import register_selector


def label_histograms(data) -> np.ndarray:
    """(n_learners, n_classes) row-normalized label distributions from a
    classifier ``repro_torch.sim.partition.FederatedDataset``'s shards."""
    y = np.asarray(data.y_train)
    n_classes = int(data.n_classes)
    hists = np.zeros((len(data.shards), n_classes), np.float64)
    for i, shard in enumerate(data.shards):
        h = np.bincount(y[np.asarray(shard, int)], minlength=n_classes)
        hists[i] = h / max(h.sum(), 1)
    return hists


def token_histograms(data, top_k: int = 64) -> np.ndarray:
    """The LM analogue of the label distribution (row-normalized unigram
    histograms over the ``top_k`` most frequent tokens) for a token
    ``FederatedDataset``: not ported with the token datasets."""
    raise NotImplementedError(
        "flips on a token benchmark (token_histograms) is not ported to "
        "repro_torch yet (ROADMAP.md queue 1 item 2)")


def learner_histograms(data, top_k: int = 64) -> np.ndarray:
    """Per-learner data-distribution features for clustering, dispatched on
    the dataset's sample layout (``FederatedDataset.kind``)."""
    if getattr(data, "kind", "classifier") == "tokens":
        return token_histograms(data, top_k=top_k)
    return label_histograms(data)


def kmeans_labels(hists: np.ndarray, k: int, seed: int,
                  iters: int = 8) -> np.ndarray:
    """Deterministic k-means over label distributions: seeded init, fixed
    iteration count, empty clusters re-seeded to the farthest point.
    Returns the (n_learners,) cluster assignment."""
    n = len(hists)
    k = max(1, min(k, n))
    rng = np.random.default_rng(seed)
    centers = hists[rng.choice(n, size=k, replace=False)].copy()
    assign = np.zeros(n, np.int64)
    for _ in range(iters):
        d2 = ((hists[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
        assign = d2.argmin(1)
        for c in range(k):
            m = assign == c
            if m.any():
                centers[c] = hists[m].mean(0)
            else:
                centers[c] = hists[d2.min(1).argmax()]
    return assign


class FlipsSelector(Selector):
    """Cluster-balanced uniform sampling over a fixed label clustering."""
    name = "flips"
    needs_views = False

    def __init__(self, cluster_of: np.ndarray):
        self.cluster_of = np.asarray(cluster_of, np.int64)

    def quotas(self, sizes, n_target: int) -> list:
        """Per-cluster budgets for cluster population ``sizes`` (in cluster
        order): equal split, remainder to the largest clusters first
        (cluster id breaks ties), overflow beyond a cluster's population
        redistributed to clusters with headroom.  Pure integer arithmetic —
        the closed-form oracle in tests/test_selector_zoo.py pins it."""
        sizes = [int(s) for s in sizes]
        g = len(sizes)
        q = [n_target // g] * g
        by_size = sorted(range(g), key=lambda c: (-sizes[c], c))
        for c in by_size[:n_target % g]:
            q[c] += 1
        # overflow: a cluster can't supply more than its population
        spill = 0
        for c in range(g):
            if q[c] > sizes[c]:
                spill += q[c] - sizes[c]
                q[c] = sizes[c]
        while spill > 0:
            room = [c for c in by_size if q[c] < sizes[c]]
            if not room:
                break
            for c in room:
                if spill == 0:
                    break
                q[c] += 1
                spill -= 1
        return q

    def select_ids(self, round_idx, ids, n_target, rng):
        ids = list(ids)
        if len(ids) <= n_target:
            return ids
        groups = {}
        for lid in ids:                       # ids ascending -> groups sorted
            groups.setdefault(int(self.cluster_of[lid]), []).append(lid)
        clusters = sorted(groups)
        q = self.quotas([len(groups[c]) for c in clusters], n_target)
        chosen = []
        for c, qc in zip(clusters, q):
            members = groups[c]
            if qc >= len(members):
                chosen += members
            elif qc > 0:
                chosen += list(rng.choice(members, size=qc, replace=False))
        return chosen

    def select(self, round_idx, checked_in, n_target, rng):
        return self.select_ids(round_idx, [v.learner_id for v in checked_in],
                               n_target, rng)


def _build(params, ctx):
    n_clusters = int(params.get("n_clusters", 4))
    iters = int(params.get("kmeans_iters", 8))
    top_k = int(params.get("token_top_k", 64))
    if ctx.substrate is None:
        raise ValueError("flips selector needs a substrate (label shards) "
                         "to cluster at build time")
    hists = learner_histograms(ctx.substrate.data, top_k=top_k)
    # seeded from the cell's config seed: cells sharing a seed share the
    # clustering (and the substrate build it reads), bit-identically on
    # every substrate/execution path
    assign = kmeans_labels(hists, n_clusters, seed=int(ctx.cfg.seed),
                           iters=iters)
    return FlipsSelector(assign)


register_selector(SelectorSpec(
    name="flips",
    factory=_build,
    doc="FLIPS: label-distribution k-means, per-cluster budget shares",
    knobs=(Knob("n_clusters", 4, "label-distribution clusters"),
           Knob("kmeans_iters", 8, "fixed k-means iterations"),
           Knob("token_top_k", 64,
                "token workloads: unigram histogram width")),
))
