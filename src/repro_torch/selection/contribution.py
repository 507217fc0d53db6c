"""Contribution-weighted selection with a fairness floor (survey families
2207.03681 / 2311.06801: contribution/Shapley-weighted + fairness-
constrained selection, collapsed into one practical strategy).

Each learner carries an exponentially-decayed cumulative *contribution*
score fed by the post-round statistical utility (a cheap online stand-in
for Shapley value — so this is a ``needs_feedback`` selector, K=1).
Selection is greedy on contribution, but a fairness floor reserves
``ceil(fairness_frac * n_target)`` slots each round for the longest-
starved checked-in learners (never-selected first), preventing the
rich-get-richer lockout pure contribution ranking converges to.

Port of ``repro.selection.contribution``; ``needs_feedback=True``.
The jitter draw is part of the RNG-stream contract.
"""
from __future__ import annotations

import math
from typing import Dict

from repro_torch.selection.base import Knob, Selector, SelectorSpec, class_factory
from repro_torch.selection.registry import register_selector


class ContributionSelector(Selector):
    name = "contribution"
    needs_views = False

    def __init__(self, decay: float = 0.9, fairness_frac: float = 0.2):
        self.decay = float(decay)
        self.fairness_frac = float(fairness_frac)
        self._score: Dict[int, float] = {}
        self._last_sel: Dict[int, int] = {}   # round last selected

    def select_ids(self, round_idx, ids, n_target, rng):
        ids = list(ids)
        # one jitter draw per call (tie-breaks both rankings): the RNG
        # stream advances identically regardless of score state
        jitter = rng.random(len(ids))
        if len(ids) <= n_target:
            chosen = ids
        else:
            floor = min(int(math.ceil(self.fairness_frac * n_target)),
                        n_target)
            # fairness floor: longest-unselected first (never-selected at
            # the front), jitter breaks ties
            starved = sorted(range(len(ids)),
                             key=lambda k: (self._last_sel.get(ids[k], -1),
                                            jitter[k]))
            chosen = [ids[k] for k in starved[:floor]]
            taken = set(chosen)
            # remaining slots: contribution-ranked
            ranked = sorted((k for k in range(len(ids))
                             if ids[k] not in taken),
                            key=lambda k: (-self._score.get(ids[k], 0.0),
                                           jitter[k]))
            chosen += [ids[k] for k in ranked[:n_target - len(chosen)]]
        for lid in chosen:
            self._last_sel[lid] = round_idx
        return chosen

    def select(self, round_idx, checked_in, n_target, rng):
        return self.select_ids(round_idx, [v.learner_id for v in checked_in],
                               n_target, rng)

    def update_feedback(self, learner_id, *, stat_util=None, duration=None,
                        round_idx=None):
        if stat_util is not None:
            self._score[learner_id] = (self.decay
                                       * self._score.get(learner_id, 0.0)
                                       + stat_util)


register_selector(SelectorSpec(
    name="contribution",
    factory=class_factory(ContributionSelector),
    needs_feedback=True,
    doc="decayed cumulative contribution ranking + fairness floor slots",
    knobs=(Knob("decay", 0.9, "per-update score decay"),
           Knob("fairness_frac", 0.2, "slot fraction reserved for the "
                "longest-starved learners")),
))
