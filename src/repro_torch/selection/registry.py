"""The selector strategy table (port of ``repro.selection.registry``)."""
from __future__ import annotations

from repro_torch.core.registry import StrategyTable
from repro_torch.selection.base import SelectorSpec

SELECTOR_TABLE: StrategyTable = StrategyTable("selector")


def register_selector(spec: SelectorSpec) -> SelectorSpec:
    return SELECTOR_TABLE.register(spec)


def normalize_selector_params(name: str, params) -> tuple:
    """Canonicalize ``SimConfig.selector_params`` to a sorted tuple,
    validating knob names against the spec."""
    return SELECTOR_TABLE.normalize_params(name, params)


def build_selector(cfg, substrate=None, durations=None):
    """Construct the policy object for ``cfg.selector``."""
    return SELECTOR_TABLE[cfg.selector].build(cfg, substrate=substrate,
                                              durations=durations)
