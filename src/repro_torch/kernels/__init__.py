"""Hand-written CUDA kernels for Hopper (sm_90a), one package per kernel
family, mirroring ``repro.kernels``: ``<name>/csrc/*.cu`` (the kernel),
``<name>/ops.py`` (the checked wrapper) and ``<name>/ref.py`` (its plain
PyTorch version, which the wrapper runs for CPU tensors).

``LAUNCHES`` counts, per kernel, the wrapper calls that launched the kernel
on the GPU; ``chip_smoke.py`` zeroes it before driving the main path and
reads it after, to show the path went through every kernel.
"""
from collections import Counter

import torch

LAUNCHES: Counter = Counter()


def contiguous16(t):
    """``t`` contiguous and starting on a 16-byte boundary (copied if not),
    as the kernels' 16-byte copies (TMA, ``cp.async``) need."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def refuse_autograd(name: str, *operands) -> None:
    """Raise before a forward-only kernel launches where autograd would
    record the call: grad mode on and an operand that requires grad.  The
    kernel writes its result through a ctypes call that autograd never
    sees, so the gradient of every tensor upstream would silently lose
    this path.  Neither package differentiates through the LM kernels (the
    reference fails in Pallas's JVP rule); the plain versions, taken with
    ``use_kernels=False``, train."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in operands):
        raise NotImplementedError(
            f"{name}: the CUDA kernel is forward-only and neither package "
            "differentiates through it (the reference fails in Pallas's JVP "
            "rule), so its result would carry no gradient; train with "
            "use_kernels=False, or call it under torch.no_grad() "
            "(ROADMAP.md queue 1 item 13)")
