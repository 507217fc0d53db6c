"""The selector strategy table (port of ``repro.selection.registry``)."""
from __future__ import annotations

from repro_torch.core.registry import StrategyTable, describe_table
from repro_torch.selection.base import SelectorSpec

SELECTOR_TABLE: StrategyTable = StrategyTable("selector")


def register_selector(spec: SelectorSpec) -> SelectorSpec:
    return SELECTOR_TABLE.register(spec)


def normalize_selector_params(name: str, params) -> tuple:
    """Canonicalize ``SimConfig.selector_params`` to a sorted tuple,
    validating knob names against the spec."""
    return SELECTOR_TABLE.normalize_params(name, params)


def selector_key(cfg) -> tuple:
    """The selection strategy's static descriptor, as the reference folds
    it into its ``pipeline_key``: (name, selector_params, needs_feedback,
    select_all)."""
    spec = SELECTOR_TABLE[cfg.selector]
    return (spec.name, tuple(cfg.selector_params or ()),
            spec.needs_feedback, spec.select_all)


def build_selector(cfg, substrate=None, durations=None):
    """Construct the policy object for ``cfg.selector``."""
    return SELECTOR_TABLE[cfg.selector].build(cfg, substrate=substrate,
                                              durations=durations)


def describe_selectors() -> str:
    """The strategy table as text, the reference's ``--list-selectors``."""
    rows = [(
        spec.name,
        "1" if spec.needs_feedback else "free",
        "all available" if spec.select_all else "n_target",
        ", ".join(f"{k.name}={k.default!r}" for k in spec.knobs) or "-",
        spec.doc,
    ) for spec in SELECTOR_TABLE.values()]
    return describe_table(
        ("selector", "K", "cohort", "knobs (selector_params)", "doc"), rows,
        footnote="K = rounds_per_dispatch cap: feedback selectors consume "
                 "the per-round device stat-utility vector, forcing K=1.")
