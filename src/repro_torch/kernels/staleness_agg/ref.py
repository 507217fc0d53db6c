"""Plain PyTorch version of the fused SAA server step.

The same function the CUDA kernel computes, written with torch ops: the CPU
tests run it, the wrapper runs it for CPU tensors, and ``chip_smoke.py``
holds the kernel against it on the card.  It keeps the TPU kernel's exact
semantics, which differ from ``core.staleness.staleness_weights`` in two
details: ``n_f = max(sum fresh, 1)`` enters the mixed update even with no
fresh rows, and ``fresh`` is not masked by ``valid``.
"""
from __future__ import annotations

import torch

from repro_torch.core.staleness import EPS, SCALING_RULES


def deviation_partials(updates: torch.Tensor, fresh: torch.Tensor):
    """updates (S, n, D) fp32, fresh (S, n) bool -> (num (S, n), den (S,))."""
    fr = fresh.to(updates.dtype)
    n_f = torch.clamp(fr.sum(dim=1), min=1.0)[:, None, None]       # (S,1,1)
    u_hat = (updates * fr[:, :, None]).sum(dim=1, keepdim=True) / n_f
    mixed = (updates + n_f * u_hat) / (n_f + 1.0)
    num = ((u_hat - mixed) ** 2).sum(dim=2)
    den = (u_hat ** 2).sum(dim=(1, 2))
    return num, den


def saa_weights(num, den, fresh, tau, valid, beta, rule: str):
    """Normalized Eq. 2 weights (S, n) from the partials; ``beta`` (S,)."""
    lam = torch.where(fresh, 0.0, num / (den[:, None] + EPS))
    stale = ~fresh & valid
    lam_max = torch.where(stale, lam, 0.0).amax(dim=1, keepdim=True)
    w_stale = SCALING_RULES[rule](tau, lam, lam_max, beta[:, None])
    w = torch.where(fresh, 1.0, w_stale)
    w = torch.where(valid, w, 0.0)
    return w / torch.clamp(w.sum(dim=1, keepdim=True), min=EPS)


def sweep_fused_staleness_apply(params, updates, fresh, tau, valid, scal, *,
                                rule: str = "relay"):
    """params[s] += scal[s, 1] * (w_s @ U_s), in place; returns
    (params, w (S, n)).  Shapes as ``ops.sweep_fused_staleness_apply``."""
    num, den = deviation_partials(updates, fresh)
    w = saa_weights(num, den, fresh, tau, valid, scal[:, 0], rule)
    agg = torch.bmm(w[:, None, :], updates)[:, 0]
    params.add_(scal[:, 1:2] * agg)
    return params, w
