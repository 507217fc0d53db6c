"""Synthetic availability traces (paper §C); port of ``repro.sim.traces``.

Diurnal cycles, long-tail session lengths (~70% of sessions under 10
minutes) and cyclic behavior: each learner gets a deterministic alternating
(gap, session) renewal process whose gap intensity follows a per-learner
diurnal phase.  ``TraceBank`` packs all learners' segment boundaries into
one sorted array so a single ``np.searchsorted`` answers a query for every
learner at once; the scalar queries of ``LearnerTrace`` (a ``bisect`` per
call) serve the legacy engine (``SimConfig(fast_path=False)``) and agree
with the bank's element for element.
"""
from __future__ import annotations

import bisect

import numpy as np

HOUR = 3600.0
DAY = 24 * HOUR


class LearnerTrace:
    def __init__(self, seed: int, phase_hours: float, night_owl: float,
                 horizon: float = 14 * DAY):
        rng = np.random.default_rng(seed)
        self.boundaries = [0.0]
        self.states = []       # states[i] applies in [boundaries[i], boundaries[i+1])
        t, avail = 0.0, False
        while t < horizon:
            hod = ((t / HOUR + phase_hours) % 24.0)
            night = 1.0 if (hod >= 22 or hod < 7) else 0.0
            if avail:
                # daytime sessions: lognormal median ~4 min; night sessions:
                # overnight charging, median ~1 h
                if night * night_owl > 0.5:
                    dur = float(np.exp(np.log(60 * 60) + 1.2 * rng.standard_normal()))
                    dur = min(max(dur, 5 * 60), 9 * HOUR)
                else:
                    dur = float(np.exp(np.log(4 * 60) + 1.0 * rng.standard_normal()))
                    dur = min(max(dur, 30.0), 2 * HOUR)
            else:
                # gap short at night (plugging back in), long by day
                mean_gap = (25 * 60) * (1 - night * night_owl) \
                    + (6 * 60) * night * night_owl
                dur = float(rng.exponential(mean_gap) + 30.0)
            self.states.append(avail)
            t += dur
            self.boundaries.append(t)
            avail = not avail
        self.states.append(avail)

    def available(self, t: float) -> bool:
        i = bisect.bisect_right(self.boundaries, t) - 1
        return self.states[min(i, len(self.states) - 1)]

    def available_through(self, t0: float, t1: float) -> bool:
        """True if available for the whole window (no dropout mid-round)."""
        i0 = bisect.bisect_right(self.boundaries, t0) - 1
        i1 = bisect.bisect_right(self.boundaries, t1) - 1
        return i0 == i1 and self.states[min(i0, len(self.states) - 1)]

    def next_unavailable_after(self, t: float) -> float:
        i = bisect.bisect_right(self.boundaries, t) - 1
        if not self.states[min(i, len(self.states) - 1)]:
            return t
        return self.boundaries[i + 1] if i + 1 < len(self.boundaries) else float("inf")


class AlwaysAvailable:
    """Trace of a learner that never goes away (static availability)."""

    def available(self, t):
        return True

    def available_through(self, t0, t1):
        return True

    def next_unavailable_after(self, t):
        return float("inf")


class TraceBank:
    """Struct-of-arrays view over n learner traces for batched queries.

    Learner ``i``'s boundaries are offset by ``i * stride`` (stride exceeds
    every boundary and every clipped query time), so one searchsorted over
    the packed array resolves the active segment of every queried learner.
    An ``AlwaysAvailable`` learner is one available segment.
    """

    def __init__(self, traces):
        self.n = len(traces)
        rows_b = [np.asarray(getattr(t, "boundaries", [0.0]), np.float64)
                  for t in traces]
        rows_s = [np.asarray(getattr(t, "states", [True]), bool)
                  for t in traces]
        self.lens = np.array([len(b) for b in rows_b], np.int64)
        self.offsets = np.concatenate([[0], np.cumsum(self.lens)[:-1]])
        self.boundaries = (np.concatenate(rows_b) if rows_b
                           else np.zeros(0))
        self.states = (np.concatenate(rows_s) if rows_s
                       else np.zeros(0, bool))
        self.stride = float(self.boundaries.max(initial=0.0)) + 2.0
        self._packed = (self.boundaries
                        + np.repeat(np.arange(self.n), self.lens) * self.stride)
        self._all = np.arange(self.n)

    def _segment(self, lids, t):
        """Active segment index per queried learner (clipped to the last)."""
        tq = np.minimum(t, self.stride - 1.0)
        q = lids * self.stride + tq
        idx = np.searchsorted(self._packed, q, side="right") - 1 - self.offsets[lids]
        return np.clip(idx, 0, self.lens[lids] - 1)

    def available_batch(self, lids, t):
        lids = np.asarray(lids)
        return self.states[self.offsets[lids] + self._segment(lids, t)]

    def available_all(self, t):
        return self.available_batch(self._all, t)

    def next_unavailable_after_batch(self, lids, t):
        """Per-learner next dropout time; ``t`` where already unavailable,
        +inf when available beyond the trace horizon."""
        lids = np.asarray(lids)
        seg = self._segment(lids, t)
        avail = self.states[self.offsets[lids] + seg]
        has_next = seg + 1 < self.lens[lids]
        nxt_idx = self.offsets[lids] + np.minimum(seg + 1, self.lens[lids] - 1)
        nxt = np.where(has_next, self.boundaries[nxt_idx], np.inf)
        return np.where(avail, nxt, t)


def make_traces(n: int, rng: np.random.Generator, dynamic: bool = True,
                horizon: float = 14 * DAY):
    if not dynamic:
        return [AlwaysAvailable() for _ in range(n)]
    seeds = rng.integers(0, 2 ** 31, size=n)
    phases = rng.uniform(0, 24, size=n)              # timezone / habit offset
    owls = np.clip(rng.beta(4, 2, size=n), 0.2, 1.0)  # strength of diurnality
    return [LearnerTrace(int(s), float(p), float(o), horizon)
            for s, p, o in zip(seeds, phases, owls)]
