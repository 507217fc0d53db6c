"""Adaptive Participant Target (paper §4.1); port of ``repro.core.apt``.

mu_t = (1 - alpha) * D_{t-1} + alpha * mu_{t-1}          (EWMA of round duration)
B_t  = |{ s in stragglers : RT_s <= mu_t }|              (stragglers landing in-round)
N_t  = max(1, N_0 - B_t)
"""
from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass
class AdaptiveParticipantTarget:
    n0: int                    # developer-set participant target
    alpha: float = 0.25        # paper's EWMA weight
    mu: float = 0.0            # running round-duration estimate

    def update_round_duration(self, last_duration: float) -> float:
        if self.mu == 0.0:
            self.mu = last_duration
        else:
            self.mu = (1.0 - self.alpha) * last_duration + self.alpha * self.mu
        return self.mu

    def target(self, straggler_remaining_times: Sequence[float]) -> int:
        b_t = sum(1 for rt in straggler_remaining_times if rt <= self.mu)
        return max(1, self.n0 - b_t)
