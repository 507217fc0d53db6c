"""Metrics registry: counters / gauges / histograms with a pinned schema
(a copy of ``repro.telemetry.registry``).

One ``MetricsRegistry`` is the single source of truth for a run's
counters — ``PipelineStats`` and the ``Accounting`` guard fields are thin
views over it, so the ``--profile`` JSON, the Prometheus snapshot, and
the per-sim guard accounting can never disagree.

Stdlib-only and allocation-light: metric objects are created once
(get-or-create by name) and incremented in place on the host side of the
round loop.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Sequence, Tuple, Union

Number = Union[int, float]

# default histogram buckets: powers of ten around "seconds of host work"
_DEFAULT_BUCKETS = (1e-4, 1e-3, 1e-2, 1e-1, 1.0, 10.0)


class Counter:
    """Monotonic-by-convention counter (assignable for view semantics)."""

    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = "") -> None:
        self.name = name
        self.help = help
        self.value: Number = 0

    def inc(self, n: Number = 1) -> None:
        self.value += n


class Gauge:
    """Last-write-wins scalar."""

    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = "") -> None:
        self.name = name
        self.help = help
        self.value: Number = 0

    def set(self, v: Number) -> None:
        self.value = v


class Histogram:
    """Fixed-bucket histogram (cumulative counts, Prometheus-style)."""

    __slots__ = ("name", "help", "buckets", "counts", "sum", "count")

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = _DEFAULT_BUCKETS) -> None:
        self.name = name
        self.help = help
        self.buckets: Tuple[float, ...] = tuple(buckets)
        self.counts: List[int] = [0] * (len(self.buckets) + 1)  # +inf tail
        self.sum: float = 0.0
        self.count: int = 0

    def observe(self, v: Number) -> None:
        self.sum += v
        self.count += 1
        for i, b in enumerate(self.buckets):
            if v <= b:
                self.counts[i] += 1
                return
        self.counts[-1] += 1


Metric = Union[Counter, Gauge, Histogram]


class MetricsRegistry:
    """Named metrics with get-or-create semantics and text exporters."""

    def __init__(self) -> None:
        self._metrics: Dict[str, Metric] = {}

    def _get(self, name: str, cls, **kw) -> Metric:
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name, **kw)
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(m).__name__}, not {cls.__name__}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(name, Counter, help=help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(name, Gauge, help=help)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = _DEFAULT_BUCKETS) -> Histogram:
        return self._get(name, Histogram, help=help, buckets=buckets)

    def value(self, name: str) -> Number:
        m = self._metrics[name]
        if isinstance(m, Histogram):
            raise TypeError(f"{name!r} is a histogram; read .counts/.sum")
        return m.value

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def __iter__(self) -> Iterator[Metric]:
        return iter(self._metrics.values())

    def snapshot(self) -> Dict[str, object]:
        """Plain-dict dump, stable-ordered by metric name."""
        out: Dict[str, object] = {}
        for name in sorted(self._metrics):
            m = self._metrics[name]
            if isinstance(m, Histogram):
                out[name] = {"buckets": list(m.buckets),
                             "counts": list(m.counts),
                             "sum": m.sum, "count": m.count}
            else:
                out[name] = m.value
        return out

    def prometheus_text(self) -> str:
        """Prometheus text exposition format (0.0.4) snapshot."""
        lines: List[str] = []
        for name in sorted(self._metrics):
            m = self._metrics[name]
            kind = {"Counter": "counter", "Gauge": "gauge",
                    "Histogram": "histogram"}[type(m).__name__]
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {kind}")
            if isinstance(m, Histogram):
                cum = 0
                for b, c in zip(m.buckets, m.counts):
                    cum += c
                    lines.append(f'{name}_bucket{{le="{b:g}"}} {cum}')
                lines.append(f'{name}_bucket{{le="+Inf"}} {m.count}')
                lines.append(f"{name}_sum {m.sum:g}")
                lines.append(f"{name}_count {m.count}")
            else:
                lines.append(f"{name} {m.value:g}"
                             if isinstance(m.value, float)
                             else f"{name} {m.value}")
        return "\n".join(lines) + "\n"


class CounterView:
    """dict-like view over a fixed set of registry counters.

    Preserves the old ``PipelineStats.dispatches`` / ``.guard`` plain-dict
    API (``stats.guard["rejected_norm"] += 1``, ``dict(stats.dispatches)``)
    while the registry stays the single storage.
    """

    __slots__ = ("_reg", "_prefix", "_keys")

    def __init__(self, registry: MetricsRegistry, prefix: str,
                 keys: Sequence[str]) -> None:
        self._reg = registry
        self._prefix = prefix
        self._keys = tuple(keys)
        for k in self._keys:
            registry.counter(prefix + k)

    def __getitem__(self, k: str) -> Number:
        if k not in self._keys:
            raise KeyError(k)
        return self._reg.counter(self._prefix + k).value

    def __setitem__(self, k: str, v: Number) -> None:
        if k not in self._keys:
            raise KeyError(k)
        self._reg.counter(self._prefix + k).value = v

    def __iter__(self) -> Iterator[str]:
        return iter(self._keys)

    def __len__(self) -> int:
        return len(self._keys)

    def __contains__(self, k: str) -> bool:
        return k in self._keys

    def keys(self) -> Tuple[str, ...]:
        return self._keys

    def values(self):
        return [self[k] for k in self._keys]

    def items(self):
        return [(k, self[k]) for k in self._keys]

    def as_dict(self) -> Dict[str, Number]:
        return {k: self[k] for k in self._keys}

    def __repr__(self) -> str:
        return f"CounterView({self.as_dict()!r})"

    def __eq__(self, other) -> bool:
        if isinstance(other, CounterView):
            other = other.as_dict()
        return self.as_dict() == other
