"""Struct-of-arrays accumulation of per-cell sweep metrics (port of
``repro.sweeps.results``).

``SweepResults`` holds one ``CellResult`` per grid cell (its ``Cell``
coordinates plus the engine's fixed-key ``SimSummary``) and exposes the
columnar views the reporting layer consumes: ``soa()`` (one numpy array per
summary key + one object array per axis), coordinate filtering, and
seed-aggregated group statistics for paper-style resource-to-accuracy
tables.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from repro_torch.sim.metrics import SUMMARY_KEYS, Accounting, SimSummary
from repro_torch.sweeps.grid import Cell

# the summary's guard and robust counters, in the reference's order
GUARD_KEYS = ("rejected_nonfinite", "rejected_norm", "quorum_skips")
ROBUST_KEYS = ("robust_rejected", "robust_trimmed")


@dataclasses.dataclass
class CellResult:
    cell: Cell
    summary: SimSummary
    acct: Optional[Accounting] = None      # full round records when retained

    @property
    def round_log(self) -> list:
        """The cell's telemetry round events (``SimConfig.telemetry >= 2``;
        empty at a lower level or without ``acct``)."""
        return self.acct.round_events if self.acct is not None else []


class SweepResults:
    def __init__(self, results: Sequence[CellResult]):
        self.results = list(results)

    def __len__(self):
        return len(self.results)

    def __iter__(self):
        return iter(self.results)

    def __getitem__(self, i):
        return self.results[i]

    @property
    def axes(self) -> list:
        """Axis names in grid order (seed last), from the first cell."""
        return [a for a, _ in self.results[0].cell.coords] if self.results else []

    def soa(self) -> dict:
        """Columnar view: {summary key: float/int array} plus
        {axis name: object array of coordinate values}."""
        out = {k: np.array([r.summary[k] for r in self.results])
               for k in SUMMARY_KEYS}
        for axis in self.axes:
            out[axis] = np.array([r.cell.coord(axis) for r in self.results],
                                 dtype=object)
        return out

    def filter(self, **coords) -> "SweepResults":
        keep = [r for r in self.results
                if all(r.cell.coord(a) == v for a, v in coords.items())]
        return SweepResults(keep)

    def group_stats(self, by: Optional[Sequence[str]] = None) -> list[dict]:
        """Per-group mean/min/max over the remaining axes (typically seeds).

        ``by`` defaults to every axis except ``seed``.  Each row carries the
        group coordinates, ``n`` runs, and ``<key>`` (mean) plus
        ``<key>_min``/``<key>_max`` for every summary key.
        """
        by = [a for a in self.axes if a != "seed"] if by is None else list(by)
        groups: dict = {}
        for r in self.results:
            gk = tuple((a, r.cell.coord(a)) for a in by)
            groups.setdefault(gk, []).append(r)
        rows = []
        for gk, members in groups.items():
            row = dict(gk)
            row["n"] = len(members)
            for k in SUMMARY_KEYS:
                vals = np.array([m.summary[k] for m in members], float)
                row[k] = float(np.nanmean(vals)) if len(vals) else float("nan")
                row[f"{k}_min"] = float(np.nanmin(vals))
                row[f"{k}_max"] = float(np.nanmax(vals))
            rows.append(row)
        return rows

    def resource_to_target(self) -> list[dict]:
        """Per-cell resource-to-target rows for accuracy-target sweeps
        (``SimConfig.target_accuracy`` / ``SweepSpec`` base or axis).

        For cells that stopped early, ``rounds``/``resource_used``/
        ``sim_time`` are the cost of *reaching* the target (the engine
        freezes accrual at the stop round); cells that ran out of rounds
        report their full cost with ``reached = False`` — the paper-style
        "resources to a fixed quality bar" comparison, one row per cell.
        """
        rows = []
        for r in self.results:
            s = r.summary
            rows.append({
                "cell": r.cell.name,
                **{a: r.cell.coord(a) for a in self.axes},
                "reached": bool(s["stopped_early"]),
                "rounds": s["rounds"],
                "sim_time": s["sim_time"],
                "resource_used": s["resource_used"],
                "final_accuracy": s["final_accuracy"],
            })
        return rows

    def guard_totals(self) -> dict:
        """Sweep-wide guard / robust-aggregation counters (chaos harness).

        A key is present only when some cell enables its feature (the
        guard for ``rejected_nonfinite``, ``rejected_norm`` and
        ``quorum_skips``, a robust aggregator for the ``robust_*``
        counters): a sweep with the feature off reports the key absent
        rather than a silent 0, so "0 rejections" is never confused with
        "nothing was screened".
        """
        from repro_torch.robust.aggregators import robust_key
        out = {}
        for keys, on in (
                (GUARD_KEYS, lambda cfg: cfg.guard),
                (ROBUST_KEYS, lambda cfg: robust_key(cfg) is not None)):
            if any(on(r.cell.config) for r in self.results):
                for k in keys:
                    out[k] = int(sum(r.summary[k] for r in self.results))
        return out

    def round_logs(self) -> dict:
        """{cell name: round events} of the cells that logged any; kept out
        of ``to_json_dict`` (the round log belongs in the telemetry
        directory's ``rounds.jsonl``)."""
        return {r.cell.name: r.round_log for r in self.results
                if r.round_log}

    def to_json_dict(self) -> dict:
        return {"cells": [{"name": r.cell.name,
                           "coords": dict(r.cell.coords),
                           "summary": {k: r.summary[k] for k in SUMMARY_KEYS}}
                          for r in self.results]}
