"""Deterministic, seeded fault injection for the round engine (chaos harness);
copied from ``repro.faults.plan`` (numpy only).

A ``FaultPlan`` is a *program* of faults, fully materialized at construction
from ``np.random.default_rng(seed)`` — per-(round, learner) overlays, so
the same plan replays the identical faults on every substrate (legacy,
per-stage flat, fused pipeline, batched sweeps) and across checkpoint/resume.
Four fault families:

  update corruption (``nan`` / ``inf`` / ``signflip`` / ``scale``) — a
      per-row fp32 multiplier applied to the learner's flat update delta
      right after local training.  The fused pipeline folds the multiplier
      into the round program (an extra fp32 lane in the packed floats
      buffer), so the transfer-guard and one-psum-per-round invariants
      survive; the host paths apply the identical IEEE multiply, keeping
      all substrates bit-identical under faults.

  ``post_drop`` — the learner finishes training but the result is lost
      before upload: full duration charged and wasted (the paper's §3
      wasted-work currency), device busy for the whole round, no arrival,
      no selector feedback.  Decided in ``Simulator._schedule_round``
      (host), hence identical across substrates.

  ``replay`` — a landing stale update is delivered twice in the same round
      (duplicate slot gather / duplicate cached row in the aggregation
      operand), exercising the slot cache's free-dedup discipline.

  host crash (``crash_after`` / ``crash_mode``) — after round
      ``crash_after`` completes: ``"soft"`` raises ``InjectedCrash`` (the
      in-process property tests), ``"hard"`` SIGKILLs the process (the CI
      chaos leg), leaving recovery to ``--resume`` from the last
      checkpoint.

Storage is dense ``(rounds, n)`` arrays for small plans and per-round COO
overlays for large ones (``sparse=None`` auto-switches above ~4M cells —
at the ROADMAP's n=1M target a dense fp32 corruption matrix alone is
~4 GB·rounds).  Both modes consume the RNG stream identically (a
``(rounds, n)`` uniform block row-major equals ``rounds`` sequential
``n``-draws), so sparse==dense replay bit-exactly; property-tested in
``tests/test_faults_guards.py``.

A plan may also carry an ``AttackSpec`` (``repro_torch.faults.attacks``): a
seeded per-round *attacker id set* drawn from its own RNG stream (existing
fault draws untouched) that the aggregation paths use to rewrite colluding
rows jointly.  ``with_attack`` attaches one to an existing plan.

Rounds beyond the plan's horizon and learners beyond ``n_learners`` are
fault-free, so a crash-only plan may be built with ``FaultPlan(0, 0, ...)``.
"""
from __future__ import annotations

import dataclasses
import os
import signal
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.faults.attacks import AttackSpec

CORRUPTION_KINDS = ("nan", "inf", "signflip", "scale")
KINDS = CORRUPTION_KINDS + ("post_drop", "replay")

# dense storage above this many (round, learner) cells would dominate the
# host footprint; auto-switch to per-round COO overlays
_SPARSE_CELLS = 1 << 22

_ATTACK_STREAM = 0xA77AC3   # decorrelates attacker draws from fault draws


class InjectedCrash(RuntimeError):
    """A FaultPlan's scheduled soft host crash (``crash_mode="soft"``)."""

    def __init__(self, round_idx: int):
        super().__init__(f"injected host crash after round {round_idx}")
        self.round_idx = round_idx


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One fault family over a (round window x learner set) region.

    ``prob`` is the per-(round, learner) hit probability; ``rounds`` is a
    half-open ``(start, stop)`` window (None = every round); ``learners``
    restricts the affected ids (None = all).  ``scale`` is the multiplier
    for ``kind="scale"`` (byzantine scaled garbage)."""
    kind: str
    prob: float = 1.0
    rounds: Optional[Tuple[int, int]] = None
    learners: Optional[Tuple[int, ...]] = None
    scale: float = 1e3

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"one of {KINDS}")


class FaultPlan:
    """Deterministic fault program over (rounds x n_learners)."""

    def __init__(self, n_learners: int, rounds: int,
                 specs: Sequence[FaultSpec] = (), seed: int = 0,
                 crash_after: Optional[int] = None,
                 crash_mode: str = "soft",
                 sparse: Optional[bool] = None,
                 attack: Optional[AttackSpec] = None):
        if crash_mode not in ("soft", "hard"):
            raise ValueError("crash_mode must be 'soft' or 'hard'")
        self.n_learners = int(n_learners)
        self.rounds = int(rounds)
        self.specs = tuple(specs)
        self.seed = int(seed)
        self.crash_after = crash_after
        self.crash_mode = crash_mode
        r, n = self.rounds, self.n_learners
        self.sparse = (r * n > _SPARSE_CELLS) if sparse is None else \
            bool(sparse)
        # draw order is fixed: one (R, n) uniform block per spec, in spec
        # order — the whole program is a pure function of (specs, seed).
        # The sparse path consumes the identical stream one round-row at a
        # time (row-major), so both modes replay the same faults bit-exactly.
        rng = np.random.default_rng(seed)
        if not self.sparse:
            self.corrupt: Optional[np.ndarray] = np.ones((r, n), np.float32)
            self._post_drop: Optional[np.ndarray] = np.zeros((r, n), bool)
            self._replay: Optional[np.ndarray] = np.zeros((r, n), bool)
            for spec in self.specs:
                hit = rng.random((r, n)) < spec.prob
                hit = self._mask_spec(hit, spec, r, n)
                if spec.kind == "post_drop":
                    self._post_drop |= hit
                elif spec.kind == "replay":
                    self._replay |= hit
                else:
                    self.corrupt[hit] = np.float32(self._value(spec))
            # NaN != 1.0 is True, so NaN overlays register as corruption
            self.has_corruption = bool(np.any(self.corrupt != 1.0))
        else:
            self.corrupt = self._post_drop = self._replay = None
            cmaps: Dict[int, Dict[int, np.float32]] = {}
            pd_sets: Dict[int, set] = {}
            rp_sets: Dict[int, set] = {}
            for spec in self.specs:
                val = None if spec.kind in ("post_drop", "replay") \
                    else np.float32(self._value(spec))
                for rr in range(r):
                    row = rng.random(n) < spec.prob   # always drawn: the
                    # stream must match the dense block even in masked rounds
                    hit = self._mask_spec(row[None, :], spec, r, n,
                                          round_idx=rr)[0]
                    cols = np.nonzero(hit)[0]
                    if not len(cols):
                        continue
                    if spec.kind == "post_drop":
                        pd_sets.setdefault(rr, set()).update(cols.tolist())
                    elif spec.kind == "replay":
                        rp_sets.setdefault(rr, set()).update(cols.tolist())
                    else:
                        m = cmaps.setdefault(rr, {})
                        for c in cols:       # later specs overwrite, like
                            m[int(c)] = val  # the dense ``corrupt[hit] =``
            self._corrupt_coo = {
                rr: (np.array(sorted(m), np.int64),
                     np.array([m[c] for c in sorted(m)], np.float32))
                for rr, m in cmaps.items()}
            self._post_drop_sets = {rr: frozenset(s)
                                    for rr, s in pd_sets.items()}
            self._replay_sets = {rr: frozenset(s) for rr, s in rp_sets.items()}
            self.has_corruption = any(
                bool(np.any(v != 1.0))
                for _, v in self._corrupt_coo.values())
        self.attack: Optional[AttackSpec] = None
        self._attack_ids: Dict[int, np.ndarray] = {}
        if attack is not None:
            self._arm_attack(attack)

    @staticmethod
    def _value(spec: FaultSpec) -> float:
        return {"nan": np.nan, "inf": np.inf,
                "signflip": -1.0, "scale": spec.scale}[spec.kind]

    @staticmethod
    def _mask_spec(hit: np.ndarray, spec: FaultSpec, r: int, n: int,
                   round_idx: Optional[int] = None) -> np.ndarray:
        """Apply the spec's (round window x learner set) region mask."""
        if spec.rounds is not None:
            if round_idx is None:
                m = np.zeros(r, bool)
                m[spec.rounds[0]:spec.rounds[1]] = True
                hit = hit & m[:, None]
            elif not (spec.rounds[0] <= round_idx < spec.rounds[1]):
                hit = np.zeros_like(hit)
        if spec.learners is not None:
            m = np.zeros(n, bool)
            m[list(spec.learners)] = True
            hit = hit & m[None, :]
        return hit

    # -- coordinated attacks -------------------------------------------------
    def _arm_attack(self, spec: AttackSpec) -> None:
        self.attack = spec
        self._attack_ids = {}
        n, r = self.n_learners, self.rounds
        if spec.kind == "none" or spec.frac <= 0 or n <= 0:
            return
        k = min(int(np.ceil(spec.frac * n)), n)
        arng = np.random.default_rng((self.seed, _ATTACK_STREAM))
        for rr in range(r):
            self._attack_ids[rr] = np.sort(
                arng.choice(n, size=k, replace=False)).astype(np.int64)

    def with_attack(self, spec: AttackSpec) -> "FaultPlan":
        """The same fault program plus a coordinated attack: attacker id
        sets are drawn from a *separate* RNG stream keyed on
        ``(seed, attack)``, so every existing fault draw is untouched and
        two plans differing only in ``attack`` share identical faults
        (shared-seed attack×defense pairing)."""
        clone = FaultPlan.__new__(FaultPlan)
        clone.__dict__.update(self.__dict__)
        clone._arm_attack(spec)
        return clone

    def attackers(self, r: int) -> np.ndarray:
        """Sorted attacker learner ids scheduled for round ``r``."""
        return self._attack_ids.get(r, np.empty(0, np.int64))

    def attack_flags(self, r: int, lids) -> np.ndarray:
        """Bool mask over ``lids``: which operand rows belong to round
        ``r``'s attacker set (stale rows collude at *landing* time)."""
        lids = np.asarray(lids, np.int64)
        ids = self._attack_ids.get(r)
        if ids is None or not len(lids):
            return np.zeros(len(lids), bool)
        return np.isin(lids, ids)

    # ------------------------------------------------------------------
    def scale_for(self, r: int, lids) -> np.ndarray:
        """fp32 per-row delta multipliers for round ``r``'s cohort."""
        lids = np.asarray(lids, np.int64)
        if r >= self.rounds or not self.has_corruption:
            return np.ones(len(lids), np.float32)
        if not self.sparse:
            return self.corrupt[r, lids]
        out = np.ones(len(lids), np.float32)
        coo = self._corrupt_coo.get(r)
        if coo is not None:
            cols, vals = coo
            pos = np.searchsorted(cols, lids)
            pos = np.minimum(pos, len(cols) - 1)
            hit = cols[pos] == lids
            out[hit] = vals[pos[hit]]
        return out

    def post_drop(self, r: int, lid: int) -> bool:
        if r >= self.rounds:
            return False
        if not self.sparse:
            return bool(self._post_drop[r, lid])
        return lid in self._post_drop_sets.get(r, ())

    def replay(self, r: int, lid: int) -> bool:
        if r >= self.rounds:
            return False
        if not self.sparse:
            return bool(self._replay[r, lid])
        return lid in self._replay_sets.get(r, ())

    # ------------------------------------------------------------------
    def crash_due(self, r_completed: int) -> bool:
        """True when the crash fires after round ``r_completed``."""
        return self.crash_after is not None and r_completed >= self.crash_after

    def trigger_crash(self, r_completed: int):
        if self.crash_mode == "hard":
            # unhandled-by-design: the CI chaos leg asserts exit code 137
            os.kill(os.getpid(), signal.SIGKILL)
        raise InjectedCrash(r_completed)

    def without_crash(self) -> "FaultPlan":
        """The same fault program with the crash disarmed — what a resumed
        run carries, so corruption/drop/replay faults replay identically
        but the (already-fired) crash does not refire."""
        clone = FaultPlan.__new__(FaultPlan)
        clone.__dict__.update(self.__dict__)
        clone.crash_after = None
        return clone

    # ------------------------------------------------------------------
    def counts(self) -> dict:
        """Scheduled fault totals per kind (the chaos demo's table)."""
        if not self.sparse:
            c, pd, rp = self.corrupt, self._post_drop, self._replay
            finite = np.isfinite(c)
            return {
                "nan": int(np.isnan(c).sum()),
                "inf": int(np.isinf(c).sum()),
                "signflip": int((finite & (c == -1.0)).sum()),
                "scale": int((finite & (c != 1.0) & (c != -1.0)).sum()),
                "post_drop": int(pd.sum()),
                "replay": int(rp.sum()),
            }
        out = {k: 0 for k in KINDS}
        for _, vals in self._corrupt_coo.values():
            finite = np.isfinite(vals)
            out["nan"] += int(np.isnan(vals).sum())
            out["inf"] += int(np.isinf(vals).sum())
            out["signflip"] += int((finite & (vals == -1.0)).sum())
            out["scale"] += int(
                (finite & (vals != 1.0) & (vals != -1.0)).sum())
        out["post_drop"] = sum(len(s) for s in self._post_drop_sets.values())
        out["replay"] = sum(len(s) for s in self._replay_sets.values())
        return out
