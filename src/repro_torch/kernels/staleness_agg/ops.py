"""Checked wrapper of the fused SAA server-step kernel.

``sweep_fused_staleness_apply`` validates its operands, then runs the plain
version (``ref``) when every tensor lies on the CPU, or launches the CUDA
kernel (``csrc/staleness_agg.cu``) on the current stream when every tensor
lies on one CUDA device.  Anything else raises: a CUDA tensor never falls
back to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.staleness import RULE_ID
from repro_torch.kernels import LAUNCHES, _build
from repro_torch.kernels.staleness_agg import ref

D_BLK = 2048      # columns per CUDA block; D must be a multiple
MAX_N = 1024      # rows per cell the kernel's shared-memory staging takes
NAME = "sweep_fused_staleness_apply"

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.library("staleness_agg").saa_sweep_fused_apply
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(params, updates, fresh, tau, valid, scal):
    if updates.dim() != 3:
        raise ValueError(f"updates must be (S, n, D), got {tuple(updates.shape)}")
    s, n, d = updates.shape
    want = {"params": (params, (s, d), torch.float32),
            "updates": (updates, (s, n, d), torch.float32),
            "fresh": (fresh, (s, n), torch.bool),
            "tau": (tau, (s, n), torch.int32),
            "valid": (valid, (s, n), torch.bool),
            "scal": (scal, (s, 2), torch.float32)}
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if d % D_BLK or not 1 <= n <= MAX_N or s < 1:
        raise ValueError(f"need D % {D_BLK} == 0, 1 <= n <= {MAX_N}, S >= 1; "
                         f"got S={s} n={n} D={d}")
    devices = {t.device for t, _, _ in want.values()}
    if len(devices) != 1:
        raise ValueError(f"operands on several devices: {sorted(map(str, devices))}")
    return s, n, d, devices.pop()


def sweep_fused_staleness_apply(params, updates, fresh, tau, valid, scal, *,
                                rule: str = "relay"):
    """Fused SAA server step: params[s] += lr_s * (w_s @ U_s), in place.

    params: (S, D) fp32, D % 2048 == 0; updates: (S, n, D) fp32; fresh,
    valid: (S, n) bool; tau: (S, n) int32; scal: (S, 2) fp32 rows
    ``(beta_s, server_lr_s)``.  Returns (params, weights (S, n)); an
    all-invalid cell gets zero weights and keeps its parameters.
    """
    if rule not in RULE_ID:
        raise ValueError(f"unknown scaling rule {rule!r}")
    s, n, d, device = _check(params, updates, fresh, tau, valid, scal)
    if device.type == "cpu":
        return ref.sweep_fused_staleness_apply(params, updates, fresh, tau,
                                               valid, scal, rule=rule)
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    for t in (params, updates):
        if t.data_ptr() % 16:
            raise ValueError("params/updates must be 16-byte aligned")
    nchunks = d // D_BLK
    w = torch.empty((s, n), dtype=torch.float32, device=device)
    num_part = torch.empty((s, nchunks, n), dtype=torch.float32, device=device)
    den_part = torch.empty((s, nchunks), dtype=torch.float32, device=device)
    fn = _kernel()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(params.data_ptr(), updates.data_ptr(), fresh.data_ptr(),
                 tau.data_ptr(), valid.data_ptr(), scal.data_ptr(),
                 w.data_ptr(), num_part.data_ptr(), den_part.data_ptr(),
                 s, n, d, RULE_ID[rule], stream)
    if err:
        raise RuntimeError(f"{NAME}: CUDA launch failed with error {err}")
    LAUNCHES[NAME] += 1
    return params, w
