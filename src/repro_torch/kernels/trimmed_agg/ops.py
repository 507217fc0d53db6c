"""Checked wrapper of the trimmed-mean kernel: the entry every caller uses
(the fused round pipeline and the per-stage flat path, through
``repro_torch.robust``), as ``repro.kernels.trimmed_agg.ops`` is.

``sweep_trimmed_aggregate`` validates its operands and takes any feature
width D as it is (the kernel guards its last block; the TPU wrapper's pad to
a 2048-column block has no work to do here).  It runs the plain version
(``ref``) when every tensor lies on the CPU, or launches the CUDA kernel
(``csrc/trimmed_agg.cu``) on the current stream when every tensor lies on
one CUDA device, and counts the launch in ``LAUNCHES``.  Anything else
raises: a CUDA tensor never falls back to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LAUNCHES, _build
from repro_torch.kernels.trimmed_agg import ref

NAME = "sweep_trimmed_aggregate"
_fn = []


def _cfn():
    if not _fn:
        fn = _build.library("trimmed_agg").trimmed_sweep_aggregate
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn.append(fn)
    return _fn[0]


def sweep_trimmed_aggregate(y: torch.Tensor, k_eff: torch.Tensor,
                            c: torch.Tensor) -> torch.Tensor:
    """Band means for S cells: y (S, n, D) fp32 (any D) with excluded rows
    ``+inf``; k_eff / c (S,) int32, the per-cell trim depth and valid-row
    count.  Returns (S, D): per column, the mean of the values whose stable
    rank lies in ``[k_eff, c - k_eff)``, divided by ``max(c - 2 k_eff, 1)``.
    """
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
    devices = {y.device, k_eff.device, c.device}
    if len(devices) != 1:
        raise ValueError(f"operands on several devices: {sorted(map(str, devices))}")
    device = y.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {device}")
    if device.type == "cpu":
        return ref.sweep_trimmed_aggregate(y, k_eff, c)
    y, k_eff, c = y.contiguous(), k_eff.contiguous(), c.contiguous()
    out = torch.empty((s, d), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _cfn()(y.data_ptr(), k_eff.data_ptr(), c.data_ptr(),
                     out.data_ptr(), s, n, d, stream)
    if err:
        raise RuntimeError(f"{NAME}: CUDA launch failed with error {err}")
    LAUNCHES[NAME] += 1
    return out
