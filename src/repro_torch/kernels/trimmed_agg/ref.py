"""Plain PyTorch version of the trimmed-mean kernel: the sort-based formula
the robust aggregators define (``repro.kernels.trimmed_agg.ref``).  The CPU
tests and the wrapper (for CPU tensors) run it, and ``chip_smoke.py`` holds
the CUDA kernel against it on the card."""
from __future__ import annotations

import torch


def trimmed_from_sorted(ys: torch.Tensor, c, k_eff) -> torch.Tensor:
    """Mean of the sorted column band ``[k_eff, c - k_eff)``: ys (n, D)
    sorted along rows; ``c`` / ``k_eff`` int scalars or 0-d int tensors.
    Divides by ``max(c - 2 k_eff, 1)``."""
    n = ys.shape[0]
    ridx = torch.arange(n, device=ys.device)[:, None]
    include = (ridx >= k_eff) & (ridx < c - k_eff)
    denom = torch.clamp(torch.as_tensor(c - 2 * k_eff, device=ys.device),
                        min=1).to(ys.dtype)
    return torch.where(include, ys, 0.0).sum(dim=0) / denom


def sweep_trimmed_aggregate(y: torch.Tensor, k_eff: torch.Tensor,
                            c: torch.Tensor) -> torch.Tensor:
    """y (S, n, D) fp32 with excluded rows ``+inf``; k_eff / c (S,) int32.
    Returns the band means (S, D): a stable sort per column, then
    ``trimmed_from_sorted`` per cell."""
    ys = torch.sort(y, dim=-2, stable=True).values
    return torch.stack([trimmed_from_sorted(ys[i], c[i], k_eff[i])
                        for i in range(y.shape[0])])
