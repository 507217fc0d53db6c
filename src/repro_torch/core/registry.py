"""Shared strategy-table machinery (port of ``repro.core.registry``).

Selectors (:mod:`repro_torch.selection`) and learner models
(:mod:`repro_torch.learners`) each keep a :class:`StrategyTable` of frozen
spec dataclasses, one spec registered per file at import time;
:func:`describe_table` renders one as a listing.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class Knob:
    """One tunable parameter of a strategy: name, default, one-line doc."""

    name: str
    default: float
    doc: str = ""


class StrategyTable:
    """Ordered name -> spec registry.  Registration is idempotent for an
    identical spec and rejects a different spec under a taken name."""

    def __init__(self, kind: str):
        self.kind = kind
        self._specs: Dict[str, object] = {}

    def register(self, spec):
        existing = self._specs.get(spec.name)
        if existing is not None:
            if existing == spec:
                return spec
            raise ValueError(
                f"{self.kind} {spec.name!r} is already registered with a "
                f"different spec")
        self._specs[spec.name] = spec
        return spec

    def __contains__(self, name: str) -> bool:
        return name in self._specs

    def __getitem__(self, name: str):
        try:
            return self._specs[name]
        except KeyError:
            raise KeyError(
                f"unknown {self.kind} {name!r} "
                f"(choose from {self.names()})") from None

    def __iter__(self) -> Iterator[str]:
        return iter(self._specs)

    def __len__(self) -> int:
        return len(self._specs)

    def get(self, name: str, default=None):
        return self._specs.get(name, default)

    def names(self) -> Tuple[str, ...]:
        return tuple(self._specs)

    def values(self) -> Tuple[object, ...]:
        return tuple(self._specs.values())

    def items(self):
        return self._specs.items()

    def normalize_params(self, name: str,
                         params: Optional[Sequence[Tuple[str, object]]]
                         ) -> Tuple[Tuple[str, object], ...]:
        """Validate ``(knob, value)`` overrides against the spec's knobs and
        return them as a sorted tuple (later duplicates win)."""
        spec = self[name]
        known = tuple(k.name for k in spec.knobs)
        items = sorted(dict(params or ()).items())
        unknown = [k for k, _ in items if k not in known]
        if unknown:
            raise ValueError(
                f"{self.kind} {name!r}: unknown knob(s) {unknown} "
                f"(accepted: {list(known) or 'none'})")
        return tuple(items)

    def knob_values(self, name: str,
                    params: Optional[Sequence[Tuple[str, object]]] = None
                    ) -> Dict[str, object]:
        """Spec defaults overlaid with normalized ``params`` overrides."""
        spec = self[name]
        values = {k.name: k.default for k in spec.knobs}
        for key, value in self.normalize_params(name, params):
            values[key] = value
        return values


def describe_table(title_row: Sequence[str],
                   rows: Sequence[Sequence[str]],
                   footnote: str = "") -> str:
    """A left-justified column table: every column but the last (the doc
    string, left ragged) padded to its widest cell, then ``footnote`` as a
    trailing paragraph."""
    table = [tuple(title_row)] + [tuple(r) for r in rows]
    ncol = len(table[0])
    widths = [max(len(r[c]) for r in table) for c in range(ncol - 1)]
    lines = ["  ".join(v.ljust(w) for v, w in zip(r[:-1], widths))
             + f"  {r[-1]}" for r in table]
    text = "\n".join(lines)
    if footnote:
        text += "\n\n" + footnote
    return text
