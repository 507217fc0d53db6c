"""Oort utility-guided selection (Lai et al., OSDI'21).

Port of ``repro.selection.oort``.  Oort is a ``needs_feedback`` selector:
its statistical utility comes from the per-row loss stats of local
training, which the fused pipeline copies to the host after each round
(see ``repro_torch.selection.base``).  It decides from floats
(``stat_util * (T_pref / t) ** alpha``), so a near tie can order apart
between two packages whose training sums in other orders.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from repro_torch.selection.base import (Knob, LearnerView, Selector, SelectorSpec,
                                  class_factory)
from repro_torch.selection.registry import register_selector


class OortSelector(Selector):
    """Oort (Lai et al., OSDI'21), faithful to its core mechanics:

    util(i) = stat_util(i) * (T_pref / t_i)^alpha  if t_i > T_pref else stat_util(i)

    with epsilon-greedy exploration of never-selected learners (epsilon decays
    0.9 -> 0.2) and a pacer that raises T_pref by ``pacer_delta`` when the
    aggregate utility of selected participants stalls.
    """
    name = "oort"

    def __init__(self, alpha: float = 2.0, pacer_delta: float = 10.0,
                 pacer_window: int = 20, eps0: float = 0.9, eps_min: float = 0.2,
                 eps_decay: float = 0.98):
        self.alpha = alpha
        self.pacer_delta = pacer_delta
        self.pacer_window = pacer_window
        self.eps = eps0
        self.eps_min = eps_min
        self.eps_decay = eps_decay
        self.t_pref = None            # preferred round duration, set lazily
        self._util_history: List[float] = []
        self._stat_util: Dict[int, float] = {}
        self._duration: Dict[int, float] = {}

    def _utility(self, v: LearnerView) -> float:
        stat = self._stat_util.get(v.learner_id, v.last_stat_util)
        dur = self._duration.get(v.learner_id, v.est_duration) or 1.0
        if self.t_pref is not None and dur > self.t_pref:
            stat *= (self.t_pref / dur) ** self.alpha
        return stat

    def select(self, round_idx, checked_in, n_target, rng):
        if self.t_pref is None:
            durs = [v.est_duration for v in checked_in if v.est_duration > 0]
            self.t_pref = float(np.percentile(durs, 50)) if durs else 100.0
        explored = [v for v in checked_in if v.learner_id in self._stat_util]
        unexplored = [v for v in checked_in if v.learner_id not in self._stat_util]
        n_explore = int(round(self.eps * n_target))
        n_exploit = n_target - n_explore

        exploit_order = sorted(explored, key=self._utility, reverse=True)
        chosen = [v.learner_id for v in exploit_order[:n_exploit]]
        # exploration favors fast unexplored learners (Oort's speed heuristic)
        unexplored.sort(key=lambda v: v.est_duration or 1e9)
        chosen += [v.learner_id for v in unexplored[:n_target - len(chosen)]]
        if len(chosen) < n_target:  # backfill from remaining explored
            rest = [v.learner_id for v in exploit_order[n_exploit:]
                    if v.learner_id not in chosen]
            chosen += rest[:n_target - len(chosen)]
        self.eps = max(self.eps_min, self.eps * self.eps_decay)

        # pacer: if utility over the last window stalls, relax T_pref
        window_util = sum(self._utility(v) for v in checked_in
                          if v.learner_id in chosen)
        self._util_history.append(window_util)
        h = self._util_history
        if len(h) >= 2 * self.pacer_window:
            recent = sum(h[-self.pacer_window:])
            prev = sum(h[-2 * self.pacer_window:-self.pacer_window])
            if recent <= prev:
                self.t_pref += self.pacer_delta
                self._util_history = h[-self.pacer_window:]
        return chosen[:n_target]

    def update_feedback(self, learner_id, *, stat_util=None, duration=None,
                        round_idx=None):
        if stat_util is not None:
            self._stat_util[learner_id] = stat_util
        if duration is not None:
            self._duration[learner_id] = duration


register_selector(SelectorSpec(
    name="oort",
    factory=class_factory(OortSelector),
    needs_feedback=True,
    doc="Oort: stat utility x completion-time penalty, eps-greedy + pacer",
    knobs=(Knob("alpha", 2.0, "completion-time penalty exponent"),
           Knob("pacer_delta", 10.0, "T_pref step when utility stalls"),
           Knob("pacer_window", 20, "pacer comparison window (rounds)"),
           Knob("eps0", 0.9, "initial exploration fraction"),
           Knob("eps_min", 0.2, "exploration floor"),
           Knob("eps_decay", 0.98, "per-round exploration decay")),
))
