"""Plain PyTorch version of the sliding-window attention kernel: the model's
blocked online-softmax attention with the GQA reshape, as
``repro.kernels.swa_attention.ref`` is.  The CPU tests and the wrapper (for
CPU tensors) run it, and ``chip_smoke.py`` holds the CUDA kernel against it
on the card."""
from __future__ import annotations

import torch

from repro_torch.models.attention import blocked_attention


def swa_attention_ref(q, k, v, *, window: int):
    """q: (B, S, H, Dh); k, v: (B, S, Hkv, Dh) -> (B, S, H, Dh)."""
    B, S, H, Dh = q.shape
    Hkv = k.shape[2]
    pos = torch.arange(S, dtype=torch.int32, device=q.device).expand(B, S)
    out = blocked_attention(q.reshape(B, S, Hkv, H // Hkv, Dh), k, v, pos, pos,
                            window=window)
    return out.reshape(B, S, H, Dh)
