"""Model plugin base (port of ``repro.learners.base``).

A model registers one :class:`ModelSpec` in ``MODEL_TABLE``; the engine
consumes its :class:`ModelFns` triple of functions over parameter dicts:

``init(generator)``
    ``torch.Generator`` -> parameter dict (CPU fp32 tensors).  The flat
    ``(D,)`` row and its ``FlatSpec`` are derived from it.
``loss(params, x, y) -> (mean_loss, per_example_losses)``
    The local objective; leaves may carry a leading learner axis, and the
    means are then per learner.
``evaluate(params, x, y) -> (accuracy, loss)``
    Held-out metric pair of L models at once: leaves batched (L, ...), x
    and y with a leading L axis; two (L,) tensors, each model's numbers
    independent of L (a sweep batch evaluates its cells in one call).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

from repro_torch.core.registry import Knob  # noqa: F401  (re-export)


@dataclasses.dataclass(frozen=True)
class DataMeta:
    """Static description of a benchmark's sample layout."""
    kind: str = "classifier"
    feature_dim: int = 0
    n_classes: int = 0


class ModelFns(NamedTuple):
    init: Callable
    loss: Callable
    evaluate: Callable


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """One registered learner model (a row of ``MODEL_TABLE``)."""
    name: str
    build: Callable[[dict, DataMeta], ModelFns]
    doc: str = ""
    data_kind: str = "classifier"
    knobs: tuple = ()
