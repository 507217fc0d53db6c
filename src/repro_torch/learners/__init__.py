"""Learner-model table (port of ``repro.learners``); this slice registers
the ``mlp`` alone."""
from repro_torch.learners.base import DataMeta, Knob, ModelFns, ModelSpec  # noqa: F401
from repro_torch.learners.registry import (MODEL_TABLE, build_model,  # noqa: F401
                                           normalize_model_params,
                                           register_model)
from repro_torch.learners import mlp as _mlp  # noqa: F401  (registers "mlp")
