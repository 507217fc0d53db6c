"""Checked wrapper of the trimmed-mean kernel: the entry every caller uses
(the fused round pipeline and the per-stage flat path, through
``repro_torch.robust``), as ``repro.kernels.trimmed_agg.ops`` is.

``sweep_trimmed_aggregate`` validates its operands and takes any feature
width D as it is (the kernel guards its last block; the TPU wrapper's pad to
a 2048-column block has no work to do here).  It runs the plain version
(``ref``, the sort formula) when every tensor lies on the CPU, or launches
the CUDA kernel (``csrc/trimmed_agg.cu``) on the current stream when every
tensor lies on one CUDA device.  Anything else raises: a CUDA tensor never
falls back to the plain version.

The kernel has three variants, equal bit for bit (``VARIANTS``): ``regs``
(a column in one thread's registers, n <= 16), ``sort`` (a bitonic network
over up to 32 threads a column, n <= 1024) and ``rank`` (ranks counted by
compares, any n).  ``variant(n)`` picks by the cell's row count (the
thresholds come from ``chip_smoke.py``'s times; PERF.md); ``variant=``
forces one, and a variant given an n past its range raises.  Each launch
counts in ``LAUNCHES`` under ``sweep_trimmed_aggregate`` and under
``sweep_trimmed_aggregate:<variant>``.  The checks go through the shared
lean launch (``repro_torch.kernels._launch``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _launch
from repro_torch.kernels._launch import CEntry, Checked
from repro_torch.kernels.trimmed_agg import ref

NAME = "sweep_trimmed_aggregate"
VARIANTS = ("regs", "sort", "rank")
# the most rows a cell may have, per variant (None: any)
MAX_ROWS = {"regs": 16, "sort": 1024, "rank": None}
# the most rows the regs variant takes by default (at n = 16 it beats the
# sort 2.3x by chip_smoke.py's times; a 32-slot regs kernel, tried and
# removed, lost to the sort at n = 32: PERF.md); the sort takes the rest up
# to its limit, the rank count beyond
REGS_MAX_N = 16
_ENTRIES = {v: CEntry("trimmed_agg", f"trimmed_{v}_aggregate", 4, 3)
            for v in VARIANTS}
_ERRORS = {-1: "n is outside the variant's range"}


def variant(n: int) -> str:
    """The variant the wrapper takes for cells of n rows."""
    if n <= REGS_MAX_N:
        return "regs"
    return "sort" if n <= MAX_ROWS["sort"] else "rank"


@Checked
def _plan(y, k_eff, c, forced):
    if y.dim() != 3 or y.dtype != torch.float32:
        raise ValueError(f"y must be fp32 (S, n, D), got {y.dtype} "
                         f"{tuple(y.shape)}")
    s, n, d = y.shape
    if s < 1 or n < 1 or d < 1:
        raise ValueError(f"need S, n, D >= 1; got S={s} n={n} D={d}")
    for name, t in (("k_eff", k_eff), ("c", c)):
        if tuple(t.shape) != (s,) or t.dtype != torch.int32:
            raise ValueError(f"{name}: expected torch.int32 ({s},), got "
                             f"{t.dtype} {tuple(t.shape)}")
    if forced is None:
        v = variant(n)
    elif forced not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS} or None, got {forced!r}")
    elif MAX_ROWS[forced] is not None and n > MAX_ROWS[forced]:
        raise ValueError(f"variant {forced!r} takes n <= {MAX_ROWS[forced]}, got n={n}")
    else:
        v = forced
    devices = {y.device, k_eff.device, c.device}
    if len(devices) != 1:
        raise ValueError(f"operands on several devices: {sorted(map(str, devices))}")
    device = y.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {device}")
    return (None if device.type == "cpu" else device), s, n, d, v


def sweep_trimmed_aggregate(y: torch.Tensor, k_eff: torch.Tensor,
                            c: torch.Tensor, *, variant=None) -> torch.Tensor:
    """Band means for S cells: y (S, n, D) fp32 (any D) with excluded rows
    ``+inf``; k_eff / c (S,) int32, the per-cell trim depth and valid-row
    count.  Returns (S, D): per column, the mean of the values whose stable
    rank lies in ``[k_eff, c - k_eff)``, divided by ``max(c - 2 k_eff, 1)``.
    ``variant``: "regs", "sort", "rank" or None (by n; module docstring).
    """
    device, s, n, d, v = _plan((y, k_eff, c), variant)
    if device is None:
        return ref.sweep_trimmed_aggregate(y, k_eff, c)
    y, k_eff, c = y.contiguous(), k_eff.contiguous(), c.contiguous()
    out = torch.empty((s, d), dtype=torch.float32, device=device)
    _launch.launch(NAME, _ENTRIES[v], device.index,
                   (y.data_ptr(), k_eff.data_ptr(), c.data_ptr(),
                    out.data_ptr(), s, n, d), v, _ERRORS)
    return out
