"""Checked wrappers of the WKV6 kernel, as ``repro.kernels.wkv6.ops`` and
``.wkv6`` are: ``wkv6`` takes the model's (B, S, H, N) layout (RWKV6's
prefill and decode call it), ``wkv6_bhsn`` the TPU kernel's (B*H, S, N).
Both launch the same CUDA kernel (``csrc/wkv6.cu``), which reads either
layout in place through strides, takes any S (no padding) and head sizes
8, 16, 32 and 64, and counts every launch in ``LAUNCHES["wkv6_bhsn"]``.

r, k, v are fp32 or bf16 (one dtype), w fp32; y comes back in v's dtype and
the final state in fp32.  The plain version (``ref``) runs when every tensor
lies on the CPU; on one CUDA device the kernel launches on the current
stream; anything else raises: a CUDA tensor never falls back to the plain
version.  The kernel is forward-only: on the card a call that autograd
would record (grad mode on, an operand requiring grad) raises before the
launch (``kernels.refuse_autograd``); on the CPU the plain version
differentiates.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LAUNCHES, _build, contiguous16, refuse_autograd
from repro_torch.kernels.wkv6 import ref

NAME = "wkv6_bhsn"
HEAD_SIZES = (8, 16, 32, 64)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fn = []


def _cfn():
    if not _fn:
        fn = _build.library("wkv6").wkv6_fwd
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] * 5 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn.append(fn)
    return _fn[0]


def _check(r, k, v, w, u, s0, state_shape):
    """The operands' device; raises on what the kernel does not take."""
    if not (r.shape == k.shape == v.shape == w.shape) or r.dim() not in (3, 4):
        raise ValueError(f"r, k, v, w must share one shape, got {tuple(r.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}, {tuple(w.shape)}")
    if r.shape[1] < 1:
        raise ValueError("need at least one step")
    if r.dtype not in _DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise ValueError(f"r, k, v must share one dtype of {list(_DTYPES)}, got "
                         f"{r.dtype}, {k.dtype}, {v.dtype}")
    if w.dtype != torch.float32 or u.dtype != torch.float32:
        raise ValueError(f"w and u must be fp32, got {w.dtype}, {u.dtype}")
    if s0 is not None and (tuple(s0.shape) != state_shape or s0.dtype != torch.float32):
        raise ValueError(f"state0 must be fp32 {state_shape}, got {s0.dtype} "
                         f"{tuple(s0.shape)}")
    tensors = [r, k, v, w, u] + ([] if s0 is None else [s0])
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"operands on several devices: {sorted(map(str, devices))}")
    device = r.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {device}")
    if device.type == "cuda" and r.shape[-1] not in HEAD_SIZES:
        raise ValueError(f"the kernel takes head sizes {HEAD_SIZES}, got {r.shape[-1]}")
    return device


def _launch(r, k, v, w, u, s0, B, H, S, N, lay, u_str):
    """One launch over (B, H) heads of S steps; ``lay`` are the element
    strides of (batch, step, head) of r, k, v, w and y, ``u_str`` of
    (batch, head) of u.  Returns (y, final state (B*H, N, N))."""
    r, k, v, w = (contiguous16(t) for t in (r, k, v, w))   # read by 16-byte cp.async
    u = u.contiguous()
    s0 = None if s0 is None else s0.contiguous()
    y = torch.empty_like(v)
    s_out = torch.empty((B * H, N, N), dtype=torch.float32, device=r.device)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = _cfn()(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                     u.data_ptr(), None if s0 is None else s0.data_ptr(),
                     y.data_ptr(), s_out.data_ptr(), _DTYPES[v.dtype], N, B, H, S,
                     *lay, *u_str, stream)
    if err:
        raise RuntimeError(f"{NAME}: CUDA launch failed with error {err}")
    LAUNCHES[NAME] += 1
    return y, s_out


def wkv6(r, k, v, w, u, state0=None):
    """r, k, v, w: (B, S, H, N); u: (H, N); state0: (B, H, N, N) or None
    (zeros).  Returns (y (B, S, H, N) in v's dtype, final state (B, H, N, N)
    fp32)."""
    if r.dim() != 4:
        raise ValueError(f"expected (B, S, H, N) operands, got {tuple(r.shape)}")
    B, S, H, N = r.shape
    if tuple(u.shape) != (H, N):
        raise ValueError(f"u must be ({H}, {N}), got {tuple(u.shape)}")
    if _check(r, k, v, w, u, state0, (B, H, N, N)).type == "cpu":
        return ref.wkv6_scan(r, k, v, w, u, state0=state0)
    refuse_autograd("wkv6", r, k, v, w, u, state0)
    y, s_out = _launch(r, k, v, w, u, state0, B, H, S, N,
                       (S * H * N, H * N, N), (0, N))
    return y, s_out.view(B, H, N, N)


def wkv6_bhsn(r, k, v, w, u, s0):
    """r, k, v, w: (B*H, S, N); u: (B*H, 1, N); s0: (B*H, N, N) fp32.
    Returns (y (B*H, S, N) in v's dtype, final state (B*H, N, N) fp32)."""
    if r.dim() != 3:
        raise ValueError(f"expected (B*H, S, N) operands, got {tuple(r.shape)}")
    BH, S, N = r.shape
    if tuple(u.shape) != (BH, 1, N):
        raise ValueError(f"u must be ({BH}, 1, {N}), got {tuple(u.shape)}")
    if s0 is None:
        raise ValueError("s0 is required, as in the TPU kernel")
    if _check(r, k, v, w, u, s0, (BH, N, N)).type == "cpu":
        # one head per row: (B*H, S, 1, N) with a per-row u
        y, s_fin = ref.wkv6_scan(r[:, :, None], k[:, :, None], v[:, :, None],
                                 w[:, :, None], u, state0=s0[:, None])
        return y[:, :, 0], s_fin[:, 0]
    refuse_autograd(NAME, r, k, v, w, u, s0)
    # (B*H, S, N) read as B*H batches of one head
    return _launch(r, k, v, w, u, s0, BH, 1, S, N, (S * N, N, 0), (N, 0))
