"""Client-side optimizers (``repro.optim.sgd``). FedAvg participants run
plain SGD (Alg. 2); momentum is available for the centralized-baseline
comparisons.  Updates are computed in fp32 and cast back to each
parameter's dtype; the momentum buffer is fp32."""
from __future__ import annotations

import torch

from repro_torch.core.aggregation import tree_leaves
from repro_torch.models.transformer import tree_map


def sgd_init(params, momentum: float = 0.0) -> dict:
    if momentum == 0.0:
        return {}
    return {"mom": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                  device=p.device), params)}


def sgd_apply(params, grads, state: dict, *, lr, momentum: float = 0.0):
    """Returns (new params, new state); nothing is updated in place."""
    if momentum == 0.0:
        new = tree_map(lambda p, g: (p.float() - lr * g.float()).to(p.dtype),
                       params, grads)
        return new, state
    mom = tree_map(lambda m, g: momentum * m + g.float(), state["mom"], grads)
    new = tree_map(lambda p, m: (p.float() - lr * m).to(p.dtype), params, mom)
    return new, {"mom": mom}


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled so their global L2 norm is at most ``max_norm``, the
    norm before scaling); the norm sums leaf by leaf in fp32."""
    norm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree_leaves(grads)))
    # a true division (``scalar / tensor`` would multiply by a reciprocal)
    scale = torch.clamp(torch.full_like(norm, max_norm) / torch.clamp(norm, min=1e-9),
                        max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm
