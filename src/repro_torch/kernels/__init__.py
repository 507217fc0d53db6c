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
