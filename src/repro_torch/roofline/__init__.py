"""Roofline terms and per-step cost counting (port of ``repro.roofline``):
``analysis`` holds the model-FLOP formulas and the roofline with the
H100's constants, ``dispatch_cost`` counts a step's FLOPs, bytes and
collective bytes from torch's dispatch."""
from repro_torch.roofline.analysis import (  # noqa: F401
    H100,
    active_params,
    model_flops,
    roofline_terms,
    swa_cost,
    wkv_cost,
)
from repro_torch.roofline.dispatch_cost import CostCounter  # noqa: F401
