"""LR schedules (``repro.optim.schedules``). WSD (warmup-stable-decay) is
MiniCPM's contribution (arXiv:2404.06395) and ships with that assigned
architecture.  ``step`` is a number or a tensor of steps; the result is an
fp32 tensor of its shape."""
from __future__ import annotations

import math

import torch


def _steps(step) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.float32)


def wsd_schedule(step, *, peak_lr, warmup_steps, stable_steps, decay_steps,
                 final_ratio=0.1):
    step = _steps(step)
    warm = peak_lr * step / max(warmup_steps, 1)
    decay_frac = (step - warmup_steps - stable_steps) / max(decay_steps, 1)
    decayed = peak_lr * torch.exp(math.log(final_ratio) * torch.clamp(decay_frac, 0, 1))
    return torch.where(step < warmup_steps, warm,
                       torch.where(step < warmup_steps + stable_steps,
                                   torch.full_like(step, peak_lr), decayed))


def cosine_schedule(step, *, peak_lr, warmup_steps, total_steps, final_ratio=0.1):
    step = _steps(step)
    warm = peak_lr * step / max(warmup_steps, 1)
    t = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0, 1)
    cos = final_ratio + (1 - final_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
    return torch.where(step < warmup_steps, warm, peak_lr * cos)
