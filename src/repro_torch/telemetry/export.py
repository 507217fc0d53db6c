"""Telemetry exporters: JSONL event logs and Prometheus text snapshots
(a copy of ``repro.telemetry.export``).

``JsonlWriter`` appends one JSON object per line, flushing every write so
the log survives a hard crash (SIGKILL) up to the last event — the
crash→resume contract truncates back to the snapshot's recorded offset
(`JsonlWriter.truncate_to`) and replays from there, making
uninterrupted and crash→resume round logs byte-identical.

Serialization is deterministic: keys keep insertion order (the pinned
schema order) and NaN/Inf floats are written as ``null`` — the files are
strict JSON, not the Python extension.
"""
from __future__ import annotations

import json
import math
import os
from typing import Dict, Optional

from .registry import MetricsRegistry


def _clean(v):
    """NaN/Inf → None so every line is strict JSON."""
    if isinstance(v, float) and not math.isfinite(v):
        return None
    return v


def dumps_event(event: Dict[str, object]) -> str:
    return json.dumps({k: _clean(v) for k, v in event.items()},
                      separators=(", ", ": "))


class JsonlWriter:
    """Append-only JSONL sink with crash-safe flushing."""

    def __init__(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self._fh = open(path, "a")

    def write(self, event: Dict[str, object]) -> None:
        self._fh.write(dumps_event(event) + "\n")
        self._fh.flush()

    def tell(self) -> int:
        self._fh.flush()
        return self._fh.tell()

    def truncate_to(self, offset: int) -> None:
        """Drop events written past a snapshot boundary (resume path).

        No-op if the file is shorter than ``offset`` (resuming into a
        different directory than the crashed run logged to).
        """
        self._fh.flush()
        if 0 <= offset <= os.path.getsize(self.path):
            self._fh.truncate(offset)

    def close(self) -> None:
        if not self._fh.closed:
            self._fh.flush()
            self._fh.close()


def write_prometheus(registry: MetricsRegistry, path: str) -> str:
    """Write a Prometheus text-format (0.0.4) snapshot; returns the path."""
    with open(path, "w") as fh:
        fh.write(registry.prometheus_text())
    return path
