"""Plain PyTorch versions of the trimmed-mean kernel.

``sweep_trimmed_aggregate`` is the sort-based formula the robust
aggregators define (``repro.kernels.trimmed_agg.ref``): the CPU tests and
the wrapper (for CPU tensors) run it, and ``chip_smoke.py`` holds the CUDA
kernel against it on the card within the weights' tolerance (it sums the
band in sorted order).  ``sweep_trimmed_aggregate_rows`` is the Pallas
kernel's own loop (``_trimmed_kernel``): every variant of the CUDA kernel
equals it bit for bit."""
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


def sweep_trimmed_aggregate_rows(y: torch.Tensor, k_eff: torch.Tensor,
                                 c: torch.Tensor) -> torch.Tensor:
    """The same band means as the Pallas kernel computes them: for each row
    i in order, its stable rank by compares (values strictly below it, and
    equal values of earlier rows), and ``acc + where(in band, y_i, 0)``;
    then one IEEE divide by ``max(c - 2 k_eff, 1)``."""
    s, n, d = y.shape
    ridx = torch.arange(n, device=y.device)[None, :, None]
    k = k_eff.to(torch.int64)[:, None]
    hi = c.to(torch.int64)[:, None] - k
    acc = torch.zeros((s, d), dtype=y.dtype, device=y.device)
    for i in range(n):
        yi = y[:, i:i + 1]
        rank = ((y < yi) | ((y == yi) & (ridx < i))).sum(dim=1)
        acc = acc + torch.where((rank >= k) & (rank < hi), yi[:, 0], 0.0)
    denom = torch.clamp(c.to(torch.int64) - 2 * k_eff.to(torch.int64), min=1)
    return acc / denom.to(y.dtype)[:, None]
