"""UCB1 bandit selection — the survey set's (2306.04862) bandit family
beyond Oort's epsilon-greedy heuristic.

Each learner is an arm; the reward of a pull is the statistical utility
the engine reports after the round (``update_feedback(stat_util=...)``,
the same per-row device loss stats Oort consumes — so this is a
``needs_feedback`` selector and forces ``rounds_per_dispatch=1``).
Selection scores are classic UCB1 on normalized rewards:

    score(i) = mean_reward(i) / max_mean  +  c * sqrt(2 ln t / n_i)

with never-pulled arms taking strict priority (uniformly shuffled among
themselves), and a shared per-round jitter draw breaking exploitation
ties deterministically.  Unlike Oort there is no completion-time penalty
or pacer: the bandit treats utility as the only signal, which makes it
the clean ablation partner for Oort's system-utility term.

Port of ``repro.selection.ucb``; ``needs_feedback=True``.  The jitter
draw (``rng.random(len(ids))``) is part of the RNG-stream contract.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np

from repro_torch.selection.base import Knob, Selector, SelectorSpec, class_factory
from repro_torch.selection.registry import register_selector


class UcbSelector(Selector):
    name = "ucb"
    needs_views = False

    def __init__(self, c: float = 1.5):
        self.c = float(c)
        self.rounds = 0                       # t: completed selection rounds
        self._sum: Dict[int, float] = {}      # cumulative reward per arm
        self._n: Dict[int, int] = {}          # pulls per arm

    def _scores(self) -> Dict[int, float]:
        """UCB1 scores for every explored arm, computed in one pass."""
        means = {a: self._sum[a] / self._n[a] for a in self._n}
        max_mean = max(means.values(), default=0.0) or 1.0
        log_t = 2.0 * math.log(max(self.rounds, 2))
        return {a: means[a] / max_mean + self.c * math.sqrt(log_t / self._n[a])
                for a in self._n}

    def score(self, lid: int) -> float:
        """UCB1 score for an explored arm (``lid`` must have feedback)."""
        return self._scores()[lid]

    def select_ids(self, round_idx, ids, n_target, rng):
        ids = list(ids)
        self.rounds += 1
        # one jitter draw per call, shared by both branches below, so the
        # RNG stream advances identically whatever the explored split is
        jitter = rng.random(len(ids))
        if len(ids) <= n_target:
            return ids
        unexplored = [(jitter[k], lid) for k, lid in enumerate(ids)
                      if lid not in self._n]
        explored = [k for k, lid in enumerate(ids) if lid in self._n]
        unexplored.sort()
        chosen = [lid for _, lid in unexplored[:n_target]]
        want = n_target - len(chosen)
        if want > 0 and explored:
            scores = self._scores()
            order = sorted(explored,
                           key=lambda k: (-scores[ids[k]], jitter[k]))
            chosen += [ids[k] for k in order[:want]]
        return chosen

    def select(self, round_idx, checked_in, n_target, rng):
        return self.select_ids(round_idx, [v.learner_id for v in checked_in],
                               n_target, rng)

    def update_feedback(self, learner_id, *, stat_util=None, duration=None,
                        round_idx=None):
        if stat_util is not None:
            self._sum[learner_id] = self._sum.get(learner_id, 0.0) + stat_util
            self._n[learner_id] = self._n.get(learner_id, 0) + 1


register_selector(SelectorSpec(
    name="ucb",
    factory=class_factory(UcbSelector),
    needs_feedback=True,
    doc="UCB1 bandit on stat-utility rewards; unexplored arms first",
    knobs=(Knob("c", 1.5, "exploration-bonus coefficient"),),
))
