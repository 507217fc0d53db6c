"""The default model: the engine's 2-layer MLP classifier, as a plugin
(port of ``repro.learners.mlp``).  It wraps ``repro_torch.sim.learner``."""
from __future__ import annotations

import functools

from repro_torch.learners.base import Knob, ModelFns, ModelSpec
from repro_torch.learners.registry import register_model
from repro_torch.sim import learner as ln


def _build(knobs: dict, meta) -> ModelFns:
    init = functools.partial(ln.mlp_init, dim=meta.feature_dim,
                             n_classes=meta.n_classes, hidden=int(knobs["hidden"]))
    return ModelFns(init=init, loss=ln.xent, evaluate=ln.evaluate)


register_model(ModelSpec(
    name="mlp",
    build=_build,
    doc="2-layer ReLU MLP classifier (the paper-scale statistical stand-in)",
    family="dense",
    kernel="-",
    knobs=(Knob("hidden", 128, "hidden layer width"),),
))
