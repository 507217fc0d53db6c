"""Plain PyTorch versions of the SAA kernel family.

The same functions the CUDA kernels compute, written with torch ops: the CPU
tests run them, the wrappers run them for CPU tensors, and ``chip_smoke.py``
holds each kernel against its plain version on the card.  They keep the TPU
kernels' exact semantics, which differ from ``core.staleness.
staleness_weights`` in two details: ``n_f = max(sum fresh, 1)`` enters the
mixed update even with no fresh rows, and ``fresh`` is not masked by
``valid``.

Every fused variant (sweep or single cell, aggregate or apply) goes through
``sweep_fused_staleness_aggregate``, so two routes that reach different
entry points still run the same torch ops on the same shapes.
"""
from __future__ import annotations

import torch

from repro_torch.core.staleness import EPS, SCALING_RULES


def deviation_partials(updates: torch.Tensor, fresh: torch.Tensor):
    """Eq. 2 partials: updates (..., n, D) fp32, fresh (..., n) bool ->
    (num (..., n), den (...)), with Lam = num / (den + EPS)."""
    fr = fresh.to(updates.dtype)
    n_f = torch.clamp(fr.sum(dim=-1), min=1.0)[..., None, None]
    u_hat = (updates * fr[..., None]).sum(dim=-2, keepdim=True) / n_f
    mixed = (updates + n_f * u_hat) / (n_f + 1.0)
    num = ((u_hat - mixed) ** 2).sum(dim=-1)
    den = (u_hat ** 2).sum(dim=(-2, -1))
    return num, den


def saa_weights(num, den, fresh, tau, valid, beta, rule: str):
    """Normalized Eq. 2 weights (S, n) from the partials; ``beta`` (S,).
    ``lam_max`` is taken over the stale rows that are valid."""
    lam = torch.where(fresh, 0.0, num / (den[:, None] + EPS))
    stale = ~fresh & valid
    lam_max = torch.where(stale, lam, 0.0).amax(dim=1, keepdim=True)
    w_stale = SCALING_RULES[rule](tau, lam, lam_max, beta[:, None])
    w = torch.where(fresh, 1.0, w_stale)
    w = torch.where(valid, w, 0.0)
    return w / torch.clamp(row_order_sum(w), min=EPS)


def row_order_sum(w):
    """(S, n) -> (S, 1): each cell's weights summed in row order, so
    padding rows (exact zeros) keep a cell's bits, as in the kernels' fixed
    lane trees (``w.sum`` picks its blocking by n)."""
    total = torch.zeros_like(w[:, :1])
    for i in range(w.shape[1]):
        total = total + w[:, i:i + 1]
    return total


def host_weights(num, den, fresh, tau, beta: float, rule: str):
    """The two-launch A/B path's weights (n,), computed between its
    kernels: ``lam_max`` over every non-fresh row, and no valid mask."""
    lam = torch.where(fresh, 0.0, num / (den + EPS))
    lam_max = torch.where(~fresh, lam, 0.0).max()
    w_stale = SCALING_RULES[rule](tau, lam, lam_max, beta)
    w = torch.where(fresh, 1.0, w_stale)
    return w / torch.clamp(w.sum(), min=EPS)


def sweep_fused_staleness_aggregate(updates, fresh, tau, beta, valid, *,
                                    rule: str = "relay"):
    """(aggregate (S, D), weights (S, n)); shapes as
    ``ops.sweep_fused_staleness_aggregate``."""
    num, den = deviation_partials(updates, fresh)
    w = saa_weights(num, den, fresh, tau, valid, beta, rule)
    # rows summed in order over the row axis: padding rows add exact
    # zeros, so a cell's aggregate keeps its bits under any padding (a
    # GEMM over the row axis picks its blocking by n)
    return (w[..., None] * updates).sum(dim=-2), w


def sweep_fused_staleness_apply(params, updates, fresh, tau, valid, scal, *,
                                rule: str = "relay"):
    """params[s] += scal[s, 1] * (w_s @ U_s), in place; returns
    (params, w (S, n)).  Shapes as ``ops.sweep_fused_staleness_apply``."""
    agg, w = sweep_fused_staleness_aggregate(updates, fresh, tau, scal[:, 0],
                                             valid, rule=rule)
    params.add_(scal[:, 1:2] * agg)
    return params, w


def fused_staleness_aggregate(updates, fresh, tau, beta, valid, *,
                              rule: str = "relay"):
    """One cell: (aggregate (D,), weights (n,)); ``beta`` is a (1,) tensor."""
    agg, w = sweep_fused_staleness_aggregate(updates[None], fresh[None],
                                             tau[None], beta, valid[None],
                                             rule=rule)
    return agg[0], w[0]


def fused_staleness_apply(params, updates, fresh, tau, valid, scal, *,
                          rule: str = "relay"):
    """One cell, in place: params (D,) += scal[0, 1] * (w @ U); returns
    (params, w (n,))."""
    _, w = sweep_fused_staleness_apply(params[None], updates[None],
                                       fresh[None], tau[None], valid[None],
                                       scal, rule=rule)
    return params, w[0]


def weighted_aggregate(weights: torch.Tensor, updates: torch.Tensor):
    """weights (n,) fp32, updates (n, D) -> (D,): sum_i w_i U_i."""
    return (weights[:, None] * updates).sum(dim=0)
