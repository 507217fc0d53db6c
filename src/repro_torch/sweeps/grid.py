"""Declarative scenario grids: named axes -> concrete ``SimConfig`` cells
(port of ``repro.sweeps.grid``, unchanged but for its imports: the
port's ``SimConfig``, ``SELECTOR_TABLE`` and ``MODEL_TABLE``).

The paper's headline results are grids — selectors x SAA on/off x hardware
scenarios HS1-HS4 x availability settings x non-IID mappings, each over
multiple seeds.  A ``SweepSpec`` names those axes declaratively and expands
to ``Cell``s with **shared-seed pairing**: every axis combination is
instantiated once per seed with ``SimConfig.seed = seed``, so competing
policies see bit-identical datasets, device populations, and availability
traces (matched-condition comparisons; the substrate is also literally
shared in memory by ``repro_torch.sweeps.runner``).

Axes resolve through a registry: an axis is either a registered named axis
(``policy``, ``hardware``, ``availability``, ...) mapping a value to a dict
of config-field updates, or any raw ``SimConfig`` field name.  New axes
register with ``register_axis``.

Accuracy-target early stop rides the raw-field mechanism: put
``target_accuracy`` in ``base`` (one bar for the whole grid) or use it as
an axis (``axes={"target_accuracy": [0.6, 0.7]}``) — cells that reach
their target leave the lockstep batch at that eval round, and
``SweepResults.resource_to_target()`` tabulates the per-cell cost of
reaching the bar.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Dict, Mapping, Sequence

from repro_torch.sim.engine import SimConfig

_SIMCONFIG_FIELDS = {f.name for f in dataclasses.fields(SimConfig)}

AxisFn = Callable[[object], dict]
AXES: Dict[str, AxisFn] = {}


def register_axis(name: str, fn: AxisFn) -> AxisFn:
    """Register a named axis: ``fn(value) -> dict`` of SimConfig updates."""
    AXES[name] = fn
    return fn


# End-to-end policy presets (paper §5 baselines); use the ``selector`` axis
# when only the selection strategy should vary (the whole
# ``repro_torch.selection`` zoo, validated against SELECTOR_TABLE).
POLICIES = {
    "random": dict(selector="random"),
    "oort": dict(selector="oort"),
    "priority": dict(selector="priority"),
    "safa": dict(selector="safa", saa=True),
    "relay": dict(selector="priority", saa=True, apt=True,
                  scaling_rule="relay"),
}


def _selector_axis(v):
    from repro_torch.selection import SELECTOR_TABLE
    return {"selector": _check(v, tuple(SELECTOR_TABLE), "selector")}


def _model_axis(v):
    from repro_torch.learners import MODEL_TABLE
    return {"model": _check(v, tuple(MODEL_TABLE), "model")}


register_axis("policy", lambda v: dict(POLICIES[v]))
register_axis("selector", _selector_axis)
register_axis("model", _model_axis)
register_axis("saa", lambda v: {"saa": bool(v)})
register_axis("apt", lambda v: {"apt": bool(v)})
register_axis("hardware", lambda v: {"hardware_scenario": _check(
    v, ("HS1", "HS2", "HS3", "HS4"), "hardware")})
register_axis("availability", lambda v: {"dynamic_availability": (
    {"dynamic": True, "static": False}[v] if isinstance(v, str) else bool(v))})
register_axis("mapping", lambda v: {"mapping": v})
register_axis("scaling_rule", lambda v: {"scaling_rule": _check(
    v, ("equal", "dynsgd", "adasgd", "relay"), "scaling_rule")})


def _check(v, allowed, axis):
    if v not in allowed:
        raise ValueError(f"axis {axis!r}: {v!r} not in {allowed}")
    return v


def axis_updates(name: str, value) -> dict:
    """Config-field updates for one (axis, value) coordinate."""
    if name in AXES:
        return AXES[name](value)
    if name in _SIMCONFIG_FIELDS:
        return {name: value}
    raise KeyError(f"unknown sweep axis {name!r} "
                   f"(not registered, not a SimConfig field)")


def _fmt(v) -> str:
    if isinstance(v, bool):
        return "on" if v else "off"
    return str(v)


@dataclasses.dataclass(frozen=True)
class Cell:
    """One concrete simulation of a sweep: its grid coordinates + config."""
    name: str
    coords: tuple            # ((axis, value), ...), seed last
    config: SimConfig

    def coord(self, axis: str, default=None):
        return dict(self.coords).get(axis, default)


@dataclasses.dataclass
class SweepSpec:
    """Declarative scenario grid.

    axes: ordered {axis name: list of values}; base: fixed SimConfig
    overrides shared by every cell; seeds: shared-seed pairing — the full
    axis product is replicated per seed.

    Axes apply in order and later axes override earlier ones on shared
    config fields (e.g. a ``saa`` axis after a ``policy`` axis toggles SAA
    within each preset).  ``expand`` raises if an override collapses two
    differently-labeled cells onto the identical config — the symptom of
    axes ordered the wrong way around.
    """
    axes: Mapping[str, Sequence]
    base: Mapping[str, object] = dataclasses.field(default_factory=dict)
    seeds: Sequence[int] = (0,)

    def expand(self) -> list[Cell]:
        names = list(self.axes)
        cells, seen = [], {}
        for combo in itertools.product(*(self.axes[n] for n in names)):
            for seed in self.seeds:
                kw = dict(self.base)
                coords = []
                for n, v in zip(names, combo):
                    kw.update(axis_updates(n, v))
                    coords.append((n, v))
                kw["seed"] = int(seed)
                coords.append(("seed", int(seed)))
                name = "/".join(f"{n}={_fmt(v)}" for n, v in coords)
                cfg = SimConfig(**kw)
                dup = seen.setdefault(repr(cfg), name)
                if dup != name:
                    raise ValueError(
                        f"cells {dup!r} and {name!r} expand to the identical "
                        "config — an earlier axis's field is overridden by a "
                        "later axis; reorder the axes")
                cells.append(Cell(name, tuple(coords), cfg))
        return cells

    @property
    def size(self) -> int:
        n = len(self.seeds)
        for vals in self.axes.values():
            n *= len(vals)
        return n
