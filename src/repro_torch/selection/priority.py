"""RELAY's IPS (paper Alg. 1): least-available-first priority selection.

Port of ``repro.selection.priority``.  The jitter draw
(``rng.random(len(eligible))``) is part of the RNG-stream contract.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.selection.base import Knob, Selector, SelectorSpec, class_factory
from repro_torch.selection.registry import register_selector


class PrioritySelector(Selector):
    """Sort availability probabilities ascending, shuffle ties, take the top
    n_target; participants then hold off for ``holdoff`` rounds."""
    name = "priority"

    def __init__(self, holdoff: int = 5):
        self.holdoff = holdoff
        self._held_until: Dict[int, int] = {}

    def select(self, round_idx, checked_in, n_target, rng):
        eligible = [v for v in checked_in
                    if self._held_until.get(v.learner_id, -1) < round_idx]
        if not eligible:
            eligible = list(checked_in)
        jitter = rng.random(len(eligible))
        order = sorted(range(len(eligible)),
                       key=lambda i: (eligible[i].availability_prob, jitter[i]))
        chosen = [eligible[i].learner_id for i in order[:n_target]]
        for lid in chosen:
            self._held_until[lid] = round_idx + self.holdoff
        return chosen


register_selector(SelectorSpec(
    name="priority",
    factory=class_factory(PrioritySelector),
    doc="RELAY IPS: least-available-first with tie shuffling + hold-off",
    knobs=(Knob("holdoff", 5, "rounds a participant holds off after "
                "selection"),),
))
