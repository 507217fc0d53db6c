"""Uniform random selection (FedAvg default; Bonawitz et al., 2019).

Port of ``repro.selection.uniform``; the RNG draw is the reference's.
"""
from __future__ import annotations

from repro_torch.selection.base import Selector, SelectorSpec, class_factory
from repro_torch.selection.registry import register_selector


class RandomSelector(Selector):
    name = "random"
    needs_views = False

    def select_ids(self, round_idx, ids, n_target, rng):
        if len(ids) <= n_target:
            return list(ids)
        return list(rng.choice(ids, size=n_target, replace=False))

    def select(self, round_idx, checked_in, n_target, rng):
        return self.select_ids(round_idx, [v.learner_id for v in checked_in],
                               n_target, rng)


register_selector(SelectorSpec(
    name="random",
    factory=class_factory(RandomSelector),
    doc="uniform sampling without replacement (FedAvg baseline)",
))
