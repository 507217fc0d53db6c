"""Hand-written CUDA kernels for Hopper (sm_90a), one package per kernel
family, mirroring ``repro.kernels``: ``<name>/csrc/*.cu`` (the kernel),
``<name>/ops.py`` (the checked wrapper) and ``<name>/ref.py`` (its plain
PyTorch version, which the wrapper runs for CPU tensors).

``LAUNCHES`` counts, per kernel, the wrapper calls that launched the kernel
on the GPU; ``chip_smoke.py`` zeroes it before driving the main path and
reads it after, to show the path went through every kernel.
"""
from collections import Counter

LAUNCHES: Counter = Counter()


def contiguous16(t):
    """``t`` contiguous and starting on a 16-byte boundary (copied if not),
    as the kernels' 16-byte copies (TMA, ``cp.async``) need."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()
