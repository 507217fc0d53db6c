"""The model strategy table (port of ``repro.learners.registry``)."""
from __future__ import annotations

import functools

from repro_torch.core.registry import StrategyTable
from repro_torch.learners.base import DataMeta, ModelFns, ModelSpec

MODEL_TABLE: StrategyTable = StrategyTable("model")


def register_model(spec: ModelSpec) -> ModelSpec:
    return MODEL_TABLE.register(spec)


def normalize_model_params(name: str, params) -> tuple:
    """Canonicalize ``SimConfig.model_params`` to a sorted tuple,
    validating knob names against the spec."""
    return MODEL_TABLE.normalize_params(name, params)


def model_key(cfg) -> tuple:
    """Static descriptor of the learner model for ``pipeline_key``: the
    full ``(name, params)`` pair, so a knob override forms its own batch."""
    return (cfg.model, tuple(cfg.model_params or ()))


@functools.lru_cache(maxsize=32)
def build_model(name: str, params: tuple, meta: DataMeta) -> ModelFns:
    """Resolve ``(model, model_params, meta)`` to its :class:`ModelFns`."""
    spec = MODEL_TABLE[name]
    if spec.data_kind != meta.kind:
        raise ValueError(
            f"model {name!r} trains on {spec.data_kind!r} data but the "
            f"benchmark provides {meta.kind!r} samples")
    return spec.build(MODEL_TABLE.knob_values(name, params), meta)
