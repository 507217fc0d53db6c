"""Resource & quality accounting (port of ``repro.sim.metrics``).

- resource usage: cumulative compute+comm time spent by participants,
  including work that is never aggregated (paper footnote 3);
- resource wastage: the subset whose updates never reached the model;
- unique-participant rate; accuracy/time/round timelines.
"""
from __future__ import annotations

import dataclasses
from typing import List, TypedDict


class SimSummary(TypedDict):
    """Fixed-key summary of one simulation run (the reference's keys; the
    guard and robust counters stay 0 in this slice)."""
    rounds: int
    sim_time: float
    resource_used: float
    resource_wasted: float
    waste_fraction: float
    unique_participants: int
    final_accuracy: float
    best_accuracy: float
    stopped_early: bool
    rejected_nonfinite: int
    rejected_norm: int
    quorum_skips: int
    robust_rejected: int
    robust_trimmed: int


SUMMARY_KEYS = tuple(SimSummary.__annotations__)


@dataclasses.dataclass
class RoundRecord:
    round_idx: int
    sim_time: float
    n_selected: int
    n_fresh: int
    n_stale: int
    resource_used: float       # cumulative seconds
    resource_wasted: float     # cumulative seconds
    unique_participants: int
    accuracy: float = float("nan")
    loss: float = float("nan")


@dataclasses.dataclass
class Accounting:
    records: List[RoundRecord] = dataclasses.field(default_factory=list)
    resource_used: float = 0.0
    resource_wasted: float = 0.0
    unique: set = dataclasses.field(default_factory=set)
    stopped_early: bool = False   # accuracy-target early stop fired

    def charge(self, seconds: float, wasted: bool):
        self.resource_used += seconds
        if wasted:
            self.resource_wasted += seconds

    def mark_wasted(self, seconds: float):
        """Work already charged as used turned out never to be aggregated."""
        self.resource_wasted += seconds

    def summary(self) -> SimSummary:
        last = self.records[-1] if self.records else None
        accs = [r.accuracy for r in self.records if r.accuracy == r.accuracy]
        return SimSummary(
            rounds=len(self.records),
            sim_time=last.sim_time if last else 0.0,
            resource_used=self.resource_used,
            resource_wasted=self.resource_wasted,
            waste_fraction=(self.resource_wasted / self.resource_used
                            if self.resource_used else 0.0),
            unique_participants=len(self.unique),
            final_accuracy=accs[-1] if accs else float("nan"),
            best_accuracy=max(accs) if accs else float("nan"),
            stopped_early=self.stopped_early,
            rejected_nonfinite=0, rejected_norm=0, quorum_skips=0,
            robust_rejected=0, robust_trimmed=0,
        )
