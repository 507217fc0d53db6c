"""SAFA selection (Wu et al., 2021): every available learner trains.

Port of ``repro.selection.safa``, view-free.  The round-end rule (stop
when ``safa_target_ratio`` of the cohort has reported, capped by the
deadline; every arrival by then is fresh) lives in the engine's
``_schedule_round`` and is switched by this spec's ``select_all`` flag.
"""
from __future__ import annotations

from repro_torch.selection.base import Selector, SelectorSpec, class_factory
from repro_torch.selection.registry import register_selector


class SafaSelector(Selector):
    """SAFA flips selection: every available learner trains every round."""
    name = "safa"
    needs_views = False

    def select_ids(self, round_idx, ids, n_target, rng):
        return list(ids)

    def select(self, round_idx, checked_in, n_target, rng):
        return [v.learner_id for v in checked_in]


register_selector(SelectorSpec(
    name="safa",
    factory=class_factory(SafaSelector),
    select_all=True,
    doc="select all available; round ends at safa_target_ratio arrivals",
))
