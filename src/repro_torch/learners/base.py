"""Model plugin base (port of ``repro.learners.base``).

A model registers one :class:`ModelSpec` in ``MODEL_TABLE``; the engine
consumes its :class:`ModelFns` triple of functions over parameter dicts:

``init(generator)``
    ``torch.Generator`` -> parameter tree (nested dicts and lists of CPU
    fp32 tensors; the MLP's is a flat dict).  The flat ``(D,)`` row and its
    ``FlatSpec`` are derived from it.
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
    """Static description of a benchmark's sample layout (part of
    ``build_model``'s cache key).  ``"classifier"``: x (N, dim) fp32, y (N,)
    int; ``"tokens"``: x (N, S) int32 tokens, y (N, S) next-token labels."""
    kind: str = "classifier"         # classifier | tokens
    feature_dim: int = 0             # classifier: x feature dimension
    n_classes: int = 0               # classifier: label cardinality
    vocab: int = 0                   # tokens: vocabulary size
    seq_len: int = 0                 # tokens: sequence length


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
    data_kind: str = "classifier"    # classifier | tokens
    family: str = "dense"            # dense | moe | rnn (listing aid)
    kernel: str = "-"                # the kernel its forward can route through
    knobs: tuple = ()
