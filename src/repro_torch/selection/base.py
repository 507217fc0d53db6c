"""Selector plugin base: the host-side policy interface + strategy spec
(port of ``repro.selection.base``).

A selector consumes the engine's ``np.random.Generator`` stream and mutates
its own plain-attribute state; the draw order is part of the contract that
keeps the port's host decisions equal to the reference's.  The reference's
``needs_feedback`` / ``select_all`` spec flags come with the selectors that
need them (oort, ucb, contribution, safa); neither slice selector does.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.registry import Knob  # noqa: F401  (re-export)


@dataclasses.dataclass
class LearnerView:
    """What the server may know about a checked-in learner."""
    learner_id: int
    availability_prob: float = 1.0   # learner-reported P(available in [mu, 2mu])
    last_stat_util: float = 0.0      # |B_i| * sqrt(mean loss^2) from last participation
    est_duration: float = 0.0        # estimated on-device round time (seconds)
    explored: bool = False           # has participated before


class Selector:
    name = "base"
    # view-free selectors set this False and implement ``select_ids``; the
    # engine then skips the forecaster queries (pure reads: state and RNG
    # stream are untouched either way)
    needs_views = True

    def select(self, round_idx: int, checked_in: Sequence[LearnerView],
               n_target: int, rng: np.random.Generator) -> List[int]:
        raise NotImplementedError

    def select_ids(self, round_idx: int, ids, n_target: int,
                   rng: np.random.Generator) -> List[int]:
        """View-free selection; ``ids`` are the checked-in learner ids in
        ascending order."""
        raise NotImplementedError

    def update_feedback(self, learner_id: int, *, stat_util: float = None,
                        duration: float = None, round_idx: int = None):
        """Post-round feedback hook."""


@dataclasses.dataclass(frozen=True)
class BuildContext:
    """Build-time world state a selector factory may read."""
    cfg: object
    substrate: object = None
    durations: Optional[np.ndarray] = None


@dataclasses.dataclass(frozen=True)
class SelectorSpec:
    """One registered selection strategy (a row of ``SELECTOR_TABLE``)."""
    name: str
    factory: Callable[[Dict, BuildContext], Selector]
    doc: str = ""
    knobs: tuple = ()                 # Knob(...) entries

    def build(self, cfg, substrate=None, durations=None) -> Selector:
        return self.factory(dict(cfg.selector_params or ()),
                            BuildContext(cfg, substrate, durations))


def class_factory(cls: type) -> Callable[[Dict, BuildContext], Selector]:
    """Factory for selectors that are plain ``cls(**knobs)`` constructions."""
    return lambda params, ctx: cls(**params)
