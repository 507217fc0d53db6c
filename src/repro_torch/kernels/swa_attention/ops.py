"""Checked wrappers of the sliding-window attention kernel, as
``repro.kernels.swa_attention.ops`` and ``.swa_attention`` are:
``swa_attention`` takes the model's (B, S, H, Dh) layout (the GQA
transformer's prefill calls it), ``swa_attention_bhsd`` the TPU kernel's
(B*H, S, Dh).  Both launch the same CUDA source (``csrc/swa_attention.cu``):
bf16 operands take its tensor-core kernel (wgmma, TMA), fp32 operands its
CUDA-core kernel.  Either reads both layouts in place through strides and
takes any S (it masks keys past S itself, so nothing is padded), at head
dims 64, 128 and 112 (kimi-k2's, computed at 128 with 112 kept).  Every
launch counts in ``LAUNCHES["swa_attention_bhsd"]`` and in the count of the
kernel it took (``KERNELS``).

The window must be a multiple of the TPU kernel's 128 tile, as the reference
requires.  The plain version (``ref``) runs when every tensor lies on the
CPU; on one CUDA device the kernel launches on the current stream; anything
else raises: a CUDA tensor never falls back to the plain version.  The
kernel is forward-only: on the card a call that autograd would record
(grad mode on, an operand requiring grad) raises before the launch
(``kernels.refuse_autograd``); on the CPU the plain version differentiates.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LAUNCHES, _build, contiguous16, refuse_autograd
from repro_torch.kernels.swa_attention import ref

NAME = "swa_attention_bhsd"
BLK = 128                 # the TPU kernel's tile; the window is a multiple of it
HEAD_DIMS = (64, 112, 128)    # 112 (kimi-k2) runs on the 128-wide kernels
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# operand dtype -> the launch count of the kernel that dtype takes
KERNELS = {torch.bfloat16: f"{NAME}:wgmma", torch.float32: f"{NAME}:cuda_cores"}
_fn = []


def _cfn():
    if not _fn:
        fn = _build.library("swa_attention").swa_attention_fwd
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                       + [ctypes.c_longlong] * 9 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn.append(fn)
    return _fn[0]


def _check(q, k, v, window, what):
    if window % BLK:
        raise ValueError(f"window must be a multiple of the {BLK} tile, got {window}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share one dtype of {list(_DTYPES)}, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k.shape != v.shape or q.shape[-1] != k.shape[-1]:
        raise ValueError(f"{what}: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    devices = {q.device, k.device, v.device}
    if len(devices) != 1:
        raise ValueError(f"operands on several devices: {sorted(map(str, devices))}")
    device = q.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {device}")
    if device.type == "cuda" and q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head dims {HEAD_DIMS}, got {q.shape[-1]}")
    return device


def _launch(q, k, v, out, B, S, H, Hkv, window, q_str, kv_str, o_str):
    """One kernel launch; ``*_str`` are the element strides of (batch,
    sequence, head) of q, k / v and out."""
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _cfn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     _DTYPES[q.dtype], q.shape[-1], B, S, H, Hkv, window,
                     *q_str, *kv_str, *o_str, stream)
    if err:
        raise RuntimeError(f"{NAME}: CUDA launch failed with error {err}")
    LAUNCHES[NAME] += 1
    LAUNCHES[KERNELS[q.dtype]] += 1
    return out


def swa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  window: int) -> torch.Tensor:
    """q: (B, S, H, Dh); k, v: (B, S, Hkv, Dh), H a multiple of Hkv ->
    (B, S, H, Dh) in q's dtype (fp32 or bf16)."""
    if q.dim() != 4 or k.dim() != 4 or q.shape[:2] != k.shape[:2] \
            or q.shape[2] % k.shape[2]:
        raise ValueError(f"expected q (B, S, H, Dh), k / v (B, S, Hkv, Dh); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}")
    if _check(q, k, v, window, "swa_attention").type == "cpu":
        return ref.swa_attention_ref(q, k, v, window=window)
    refuse_autograd("swa_attention", q, k, v)
    q, k, v = (contiguous16(t) for t in (q, k, v))   # TMA reads 16-byte aligned rows
    B, S, H, Dh = q.shape
    Hkv = k.shape[2]
    out = torch.empty_like(q)
    strides = lambda t: (t.stride(0), t.stride(1), t.stride(2))
    return _launch(q, k, v, out, B, S, H, Hkv, window, strides(q), strides(k),
                   strides(out))


def swa_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                       window: int, n_kv_heads: int) -> torch.Tensor:
    """q: (B*H, S, Dh); k, v: (B*Hkv, S, Dh) with Hkv = ``n_kv_heads``; query
    row bh reads kv row bh // (H // Hkv).  Returns (B*H, S, Dh)."""
    if q.dim() != 3 or k.dim() != 3 or q.shape[1] != k.shape[1] \
            or k.shape[0] % n_kv_heads or q.shape[0] % (k.shape[0] // n_kv_heads):
        raise ValueError(f"expected q (B*H, S, Dh), k / v (B*Hkv, S, Dh) with "
                         f"Hkv={n_kv_heads}; got {tuple(q.shape)}, {tuple(k.shape)}")
    BH, S, Dh = q.shape
    B = k.shape[0] // n_kv_heads
    H = BH // B
    if H % n_kv_heads:
        raise ValueError(f"{H} query heads do not group over {n_kv_heads} kv heads")
    if _check(q, k, v, window, "swa_attention_bhsd").type == "cpu":
        model = lambda t, h: t.reshape(B, h, S, Dh).transpose(1, 2)
        out = ref.swa_attention_ref(model(q, H), model(k, n_kv_heads),
                                    model(v, n_kv_heads), window=window)
        return out.transpose(1, 2).reshape(BH, S, Dh)
    refuse_autograd(NAME, q, k, v)
    q, k, v = (contiguous16(t) for t in (q, k, v))   # TMA reads 16-byte aligned rows
    out = torch.empty_like(q)
    # (B*H, S, Dh) read as (batch, sequence, head) with head stride S*Dh
    return _launch(q, k, v, out, B, S, H, n_kv_heads, window,
                   (H * S * Dh, Dh, S * Dh), (n_kv_heads * S * Dh, Dh, S * Dh),
                   (H * S * Dh, Dh, S * Dh))
