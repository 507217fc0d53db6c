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
    """Fixed-key summary of one simulation run (the reference's keys)."""
    rounds: int
    sim_time: float
    resource_used: float
    resource_wasted: float
    waste_fraction: float
    unique_participants: int
    final_accuracy: float
    best_accuracy: float
    stopped_early: bool
    rejected_nonfinite: int      # guard: update rows rejected for NaN/Inf
    rejected_norm: int           # guard: rows rejected as norm outliers
    quorum_skips: int            # rounds whose server apply was skipped (quorum)
    robust_rejected: int         # robust aggregator: rows rejected (krum /
                                 # multi_krum losers, norm_median_clip rejects)
    robust_trimmed: int          # robust aggregator: rows trimmed per
                                 # coordinate band (2 k_eff a round) or
                                 # clipped (norm_median_clip)


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
    rejected_nonfinite: int = 0   # guard: rows rejected for NaN/Inf values
    rejected_norm: int = 0        # guard: rows rejected as norm outliers
    quorum_skips: int = 0         # rounds where the apply was quorum-skipped
    robust_rejected: int = 0      # robust aggregator: rows rejected
    robust_trimmed: int = 0       # robust aggregator: rows trimmed/clipped
    round_events: List[dict] = dataclasses.field(default_factory=list)
    # ^ the telemetry round log (SimConfig.telemetry >= 2): one event a
    #   recorded round, keys ``repro_torch.telemetry.schema
    #   .ROUND_EVENT_KEYS``.  Here, snapshots carry it, so a resumed run's
    #   in-memory log continues the crashed one's.

    def note_guard(self, nonfinite: int, norm: int, applied: bool = True,
                   skips: int = 0):
        """Record guard outcomes: one aggregation's (``applied`` False
        counts a quorum skip), or a run's device-side totals (``skips``
        quorum skips)."""
        self.rejected_nonfinite += int(nonfinite)
        self.rejected_norm += int(norm)
        self.quorum_skips += int(skips) + (not applied)

    def note_robust(self, rejected: int, trimmed: int):
        """Record robust-strategy outcomes (one aggregation's, or a run's
        device-side totals)."""
        self.robust_rejected += int(rejected)
        self.robust_trimmed += int(trimmed)

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
            rejected_nonfinite=self.rejected_nonfinite,
            rejected_norm=self.rejected_norm,
            quorum_skips=self.quorum_skips,
            robust_rejected=self.robust_rejected,
            robust_trimmed=self.robust_trimmed,
        )
