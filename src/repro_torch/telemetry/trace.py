"""Host-side tracer: nested spans exported as Chrome trace-event JSON
(port of ``repro.telemetry.trace``).

``Tracer.span(name, **args)`` is a context manager instrumenting the
host stages of a run (schedule / pack / dispatch / fetch / eval / repack
/ checkpoint — see ``schema.SPAN_NAMES``).  The recorded timeline
exports as Chrome trace-event JSON, loadable in Perfetto
(https://ui.perfetto.dev — drag the file in) or ``chrome://tracing``.

A disabled tracer returns a shared null context: span call sites stay
unconditional in the hot loop at ~zero cost.  ``torch_profiler=True``
additionally wraps each span in ``torch.profiler.record_function(name)``
so host spans line up with device events inside a ``torch.profiler``
trace.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Dict, List, Optional

_NULL_SPAN = contextlib.nullcontext()


class Tracer:
    """Records "X" (complete) trace events with µs timestamps."""

    def __init__(self, enabled: bool = True,
                 torch_profiler: bool = False) -> None:
        self.enabled = enabled
        self.torch_profiler = torch_profiler
        self.events: List[Dict[str, object]] = []
        self._t0 = time.perf_counter_ns()
        self._annotation = None
        if torch_profiler:
            from torch.profiler import record_function
            self._annotation = record_function

    def span(self, name: str, **args):
        if not self.enabled:
            return _NULL_SPAN
        return self._span(name, args)

    @contextlib.contextmanager
    def _span(self, name: str, args: Dict[str, object]):
        tid = threading.get_ident()
        start = time.perf_counter_ns()
        ann = self._annotation(name) if self._annotation else _NULL_SPAN
        try:
            with ann:
                yield
        finally:
            dur = time.perf_counter_ns() - start
            ev: Dict[str, object] = {
                "name": name, "ph": "X", "pid": os.getpid(),
                "tid": tid % 2**31,
                "ts": (start - self._t0) / 1e3,   # µs, run-relative
                "dur": dur / 1e3,
            }
            if args:
                ev["args"] = args
            self.events.append(ev)

    def instant(self, name: str, **args) -> None:
        """Zero-duration marker (crash/fault injections, etc.)."""
        if not self.enabled:
            return
        ev: Dict[str, object] = {
            "name": name, "ph": "i", "s": "g", "pid": os.getpid(),
            "tid": threading.get_ident() % 2**31,
            "ts": (time.perf_counter_ns() - self._t0) / 1e3,
        }
        if args:
            ev["args"] = args
        self.events.append(ev)

    def chrome_trace(self) -> Dict[str, object]:
        return {"traceEvents": list(self.events),
                "displayTimeUnit": "ms"}

    def export(self, path: str) -> Optional[str]:
        """Write Chrome trace-event JSON; returns the path (None if empty)."""
        if not self.events:
            return None
        with open(path, "w") as fh:
            json.dump(self.chrome_trace(), fh)
        return path
