"""TelemetrySession: one run's telemetry sinks, tied together (port of
``repro.telemetry.session``).

A session owns the metrics registry (single source of truth for guard
and dispatch counters), the host-side tracer, and the JSONL writers.
Every ``RoundPipeline`` has one — a directory-less default session costs
~nothing (null spans, no writers) but still backs ``PipelineStats``
with a live registry.

Exported artifacts (written under ``dir``):

  rounds.jsonl    per-round events, pinned schema, deterministic fields
                  only — joins the bitwise crash→resume contract
  events.jsonl    fault / crash / lifecycle events (wall-order, exempt
                  from the resume contract)
  trace.json      Chrome trace-event timeline (open in Perfetto)
  metrics.prom    Prometheus text-format counter snapshot

``state()`` / ``restore()`` carry the rounds.jsonl byte offset through
run snapshots: on resume into the same directory the log is truncated
back to the last checkpoint and replayed, so crash→resume produces the
byte-identical round log of an uninterrupted run.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

from .export import JsonlWriter, write_prometheus
from .registry import MetricsRegistry
from .schema import LANE_FIELDS, LANE_INT_FIELDS
from .trace import Tracer


class TelemetrySession:
    def __init__(self, dir: Optional[str] = None, *,
                 registry: Optional[MetricsRegistry] = None,
                 tracer: Optional[Tracer] = None,
                 torch_profiler: bool = False) -> None:
        self.dir = dir
        self.registry = registry if registry is not None else MetricsRegistry()
        if tracer is None:
            tracer = Tracer(enabled=dir is not None,
                            torch_profiler=torch_profiler)
        self.tracer = tracer
        self._rounds: Optional[JsonlWriter] = None
        self._events: Optional[JsonlWriter] = None
        if dir is not None:
            os.makedirs(dir, exist_ok=True)
            self._rounds = JsonlWriter(os.path.join(dir, "rounds.jsonl"))
            self._events = JsonlWriter(os.path.join(dir, "events.jsonl"))
        self._closed = False

    # -- spans ---------------------------------------------------------------
    def span(self, name: str, **args):
        if not self.tracer.enabled:     # dir-less sessions: null span, no cost
            return self.tracer.span(name, **args)
        return self._timed_span(name, args)

    @contextlib.contextmanager
    def _timed_span(self, name: str, args: dict):
        """Trace span + wall-duration sample into the registry's
        ``span_seconds_<name>`` histogram (metrics.prom only — timings are
        wall-clock and stay out of the deterministic round log)."""
        t0 = time.perf_counter()
        with self.tracer.span(name, **args):
            yield
        self.registry.histogram(f"span_seconds_{name}").observe(
            time.perf_counter() - t0)

    # -- events --------------------------------------------------------------
    def round_event(self, cell: str, lane_row, rec) -> Dict[str, object]:
        """Build (and log) one per-round event from a lane row + RoundRecord.

        ``lane_row`` is the fp32 lane vector (``schema.LANE_FIELDS`` order);
        ``rec`` is the host-side ``RoundRecord`` for the same round.  The
        dict is returned for in-memory round logs regardless of whether a
        JSONL sink exists.  Deterministic fields only — no wall clock.
        """
        ev: Dict[str, object] = {"event": "round", "cell": cell}
        for name, v in zip(LANE_FIELDS, lane_row):
            ev[name] = int(v) if name in LANE_INT_FIELDS else float(v)
        ev["resource_used"] = float(rec.resource_used)
        ev["resource_wasted"] = float(rec.resource_wasted)
        ev["unique_participants"] = int(rec.unique_participants)
        ev["accuracy"] = None if rec.accuracy != rec.accuracy \
            else float(rec.accuracy)
        ev["loss"] = None if rec.loss != rec.loss else float(rec.loss)
        if self._rounds is not None:
            self._rounds.write(ev)
        return ev

    def event(self, kind: str, **fields) -> Dict[str, object]:
        """Log a non-round event (fault injection, crash, lifecycle)."""
        ev: Dict[str, object] = {"event": kind, **fields}
        self.registry.counter(f"events_{kind}").inc()
        if self._events is not None:
            self._events.write(ev)
        self.tracer.instant(kind, **fields)
        return ev

    # -- guard accounting (single writer) ------------------------------------
    def note_guard(self, acct, nonfinite: int, norm: int,
                   applied: bool = True, skips: int = 0) -> None:
        """The one call site that counts guard outcomes: one aggregation's
        (``applied`` False counts a quorum skip), or a run's device-side
        totals (``skips`` quorum skips; the fused pipeline keeps its
        counters on the device and notes each cell's once, at the end).

        Increments the registry counters (``PipelineStats.guard`` is a view
        over them) and forwards to the per-sim ``Accounting`` so summaries
        keep their pinned guard fields.
        """
        reg = self.registry
        skips = int(skips) + (not applied)
        if nonfinite:
            reg.counter("guard_rejected_nonfinite").inc(int(nonfinite))
        if norm:
            reg.counter("guard_rejected_norm").inc(int(norm))
        if skips:
            reg.counter("guard_quorum_skips").inc(skips)
        acct.note_guard(int(nonfinite), int(norm), skips=skips)

    def note_robust(self, acct, rejected: int, trimmed: int) -> None:
        """The one call site that counts robust-aggregator outcomes
        (krum/norm-screen rejections, coordinate-band trims)."""
        reg = self.registry
        if rejected:
            reg.counter("guard_robust_rejected").inc(int(rejected))
        if trimmed:
            reg.counter("guard_robust_trimmed").inc(int(trimmed))
        acct.note_robust(int(rejected), int(trimmed))

    # -- lifecycle / resume --------------------------------------------------
    def flush(self) -> None:
        if self._rounds is not None:
            self._rounds.tell()
        if self._events is not None:
            self._events.tell()

    def state(self) -> Dict[str, int]:
        """Snapshot-carried state: the round-log byte offset."""
        return {"rounds_offset":
                self._rounds.tell() if self._rounds is not None else 0}

    def restore(self, state: Optional[Dict[str, int]]) -> None:
        """Re-enter the resume contract: truncate the round log back to the
        snapshot's offset so the resumed tail continues it exactly."""
        if state and self._rounds is not None:
            self._rounds.truncate_to(int(state.get("rounds_offset", 0)))

    def close(self) -> None:
        """Flush writers and export trace.json + metrics.prom (idempotent)."""
        if self._closed:
            return
        self._closed = True
        if self._rounds is not None:
            self._rounds.close()
        if self._events is not None:
            self._events.close()
        if self.dir is not None:
            self.tracer.export(os.path.join(self.dir, "trace.json"))
            write_prometheus(self.registry,
                             os.path.join(self.dir, "metrics.prom"))
