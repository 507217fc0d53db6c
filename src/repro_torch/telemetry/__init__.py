"""Telemetry: the round-stats lane, trace spans, metrics and exporters
(port of ``repro.telemetry``).

Levels (``SimConfig.telemetry``):

  0  off: the round's device work (and its CUDA graph) is that of a
     telemetry-free build
  1  host: tracer spans + the metrics registry / Prometheus snapshot
  2  full: also the per-round stats lane, computed in the round's device
     work (inside its CUDA graph on the card), and the per-round JSONL
     event log (``schema.LANE_FIELDS``)

The level is part of ``pipeline_key`` and of the graph workspace's key;
level 0 leaves every result bit for bit as it was, and the lane at level 2
only reads the round's operand and is copied to the host once per chunk.
"""
from .registry import Counter, CounterView, Gauge, Histogram, MetricsRegistry
from .schema import (DISPATCH_KINDS, GUARD_COUNTERS, LANE_FIELDS, LANE_WIDTH,
                     N_LANE_HOST, PIPELINE_COUNTERS, ROUND_EVENT_KEYS,
                     SPAN_NAMES)
from .session import TelemetrySession
from .trace import Tracer
from .export import JsonlWriter, dumps_event, write_prometheus

__all__ = [
    "Counter", "CounterView", "Gauge", "Histogram", "MetricsRegistry",
    "DISPATCH_KINDS", "GUARD_COUNTERS", "LANE_FIELDS", "LANE_WIDTH",
    "N_LANE_HOST", "PIPELINE_COUNTERS", "ROUND_EVENT_KEYS", "SPAN_NAMES",
    "TelemetrySession", "Tracer", "JsonlWriter", "dumps_event",
    "write_prometheus",
]
