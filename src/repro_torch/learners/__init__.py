"""Learner-model table (port of ``repro.learners``): the ``mlp``
classifier and the LM zoo's ``transformer``, ``moe`` and ``rwkv6``."""
from repro_torch.learners.base import DataMeta, Knob, ModelFns, ModelSpec  # noqa: F401
from repro_torch.learners.registry import (MODEL_TABLE, build_model,  # noqa: F401
                                           describe_models, model_key,
                                           normalize_model_params,
                                           register_model)
from repro_torch.learners import mlp as _mlp  # noqa: F401  (registers "mlp")
from repro_torch.learners import lm as _lm    # noqa: F401  (registers the LM zoo)
